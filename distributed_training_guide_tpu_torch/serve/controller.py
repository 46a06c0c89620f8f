"""The SLO-driven control plane: close the loop between the fleet's
lock-free ``stats()`` snapshots and its elastic seams.

Counterpart of ``distributed_training_guide_tpu/serve/controller.py``
(host Python, the same code). A polling controller reads ONE aggregate
snapshot per observation and decides, against declared SLO targets,
whether the fleet needs more capacity, less, or a posture change.
``stats_seq`` is a staleness fence: a snapshot that has not advanced
since the last poll means nobody is driving the fleet, and the
controller counts it and does nothing.

- **Hysteresis.** Overload must persist for ``hold_up`` observations
  before anything actuates, underload for ``hold_down``; the band between
  ``queue_high`` and ``queue_low`` is dead on purpose (no flapping).
- **Cooldowns, one change at a time.** A scale-down is two-phase:
  ``drain()`` first, ``remove_replica`` only once the drain completes; a
  victim that dies mid-drain is abandoned, not removed.
- **Degradation ladder** at max capacity: (1) shed the lowest-priority
  admissions (``Router.min_priority``), then (2) raise every refusal's
  retry hint (``Router.retry_after_floor_s``). Running sequences are
  never touched. The ladder unwinds in reverse.
- **Cold start is a number**: each scale-up times spawn to the first
  ``readiness()`` pass (``cold_starts``).
- **Spec and horizon posture**, and advisory prefill-vs-decode
  rebalance hints for disaggregated replicas.

Every actuation appends a structured entry to ``actions``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from .router import Replica, Router, readiness


@dataclasses.dataclass
class SLO:
    """Declared service-level targets + the controller's thresholds.
    Queue depths are per LIVE replica; occupancies are fractions."""

    # overload: any of these sustained for hold_up observations
    queue_high: float = 4.0
    deadline_miss_rate_high: float = 0.05   # misses / (misses + finishes)
    pool_occupancy_high: float = 0.95
    # underload: ALL of these sustained for hold_down observations
    queue_low: float = 0.5
    slot_occupancy_low: float = 0.25        # in_flight / fleet n_slots
    # degradation ladder
    shed_below_priority: int = 1            # rung 1 refuses priority < this
    retry_after_floor_s: float = 0.5        # rung 2's tightened hint
    # spec posture
    spec_off_occupancy: float = 0.75
    spec_on_occupancy: float = 0.25
    # decode-horizon posture: the controller widens every live replica's
    # fused decode horizon to ``horizon_max`` under batch pressure (high
    # occupancy amortizes host dispatches across K tokens) and snaps it
    # back to 1 under streaming/deadline pressure (a K-horizon turns p99
    # ITL into K·step — the DistServe goodput argument). horizon_max=1
    # disables the knob. Distinct thresholds: the same hysteresis
    # argument as spec posture. Replicas running a drafter are skipped
    # (spec requires K=1); legal mid-stream because the horizon changes
    # host observation granularity, never token values.
    horizon_max: int = 1
    horizon_grow_occupancy: float = 0.75
    horizon_shrink_occupancy: float = 0.25
    # informational targets (reported, not actuated on directly)
    ttft_p99_s: Optional[float] = None
    itl_p99_s: Optional[float] = None


class Controller:
    """Poll ``router.stats()`` and actuate the elastic seams against an
    :class:`SLO`. Drive it by calling :meth:`step` from the serving
    loop (``loadgen.run_open_loop`` does this every iteration); the
    controller rate-limits itself via ``poll_interval_s`` and its own
    hysteresis. ``spawn`` builds a new :class:`Replica` on scale-up —
    defaults to ``elastic.spawn_like(router)`` (clone a live replica's
    config, shared compiled programs). All decisions run off the ONE
    aggregate snapshot per observation; fenced/dead replicas are
    invisible to capacity math and untouchable by actuation."""

    def __init__(self, router: Router, *, slo: Optional[SLO] = None,
                 spawn: Optional[Callable[[], Replica]] = None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 hold_up: int = 3, hold_down: int = 6,
                 cooldown_s: float = 1.0, poll_interval_s: float = 0.0,
                 spawn_ready_polls: int = 100,
                 clock: Optional[Callable[[], float]] = None):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got "
                             f"{min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(f"max_replicas ({max_replicas}) < "
                             f"min_replicas ({min_replicas})")
        self.router = router
        self.slo = slo or SLO()
        self._spawn = spawn
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.hold_up = hold_up
        self.hold_down = hold_down
        self.cooldown_s = cooldown_s
        self.poll_interval_s = poll_interval_s
        self.spawn_ready_polls = spawn_ready_polls
        self.clock = clock if clock is not None \
            else getattr(router, "clock", time.monotonic)
        self.state = "steady"   # steady | draining | shed | backpressure
        self.actions: list[dict] = []
        self.cold_starts: list[float] = []
        self.counters = {"observations": 0, "stale_snapshots": 0,
                         "scale_up": 0, "scale_down": 0,
                         "scale_down_abandoned": 0, "spawn_failed": 0,
                         "shed_on": 0, "shed_off": 0,
                         "backpressure_on": 0, "backpressure_off": 0,
                         "spec_off": 0, "spec_on": 0,
                         "horizon_grow": 0, "horizon_shrink": 0,
                         "rebalance_hints": 0}
        self._victim: Optional[str] = None
        self._overload_n = 0
        self._underload_n = 0
        self._calm_n = 0
        self._last_seq: Optional[int] = None
        self._last_poll: Optional[float] = None
        self._last_action_at: Optional[float] = None
        self._prev_misses = 0
        self._prev_finished = 0
        self._spec_on = True
        self._horizon_wide = False
        self._last_hint: Optional[str] = None

    # ---- bookkeeping -------------------------------------------------------
    def _note(self, kind: str, target: Optional[str] = None,
              **detail) -> None:
        self.actions.append({"t": self.clock(), "kind": kind,
                             "target": target, **detail})
        if kind in self.counters:
            self.counters[kind] += 1

    def _cooldown_ok(self, now: float) -> bool:
        return (self._last_action_at is None
                or now - self._last_action_at >= self.cooldown_s)

    # ---- the observation/actuation loop ------------------------------------
    def step(self) -> None:
        now = self.clock()
        if self._last_poll is not None and self.poll_interval_s > 0 \
                and now - self._last_poll < self.poll_interval_s:
            return
        self._last_poll = now
        s = self.router.stats()
        self.counters["observations"] += 1

        # staleness fence: a snapshot that has not advanced since the
        # last poll describes a fleet nobody is driving — actuating on
        # it would react to the PAST (the one legal read is "nothing")
        seq = s.get("stats_seq")
        if seq is not None and seq == self._last_seq:
            self.counters["stale_snapshots"] += 1
            return
        self._last_seq = seq

        # windowed deadline-miss rate from counter deltas (the absolute
        # counters are lifetime totals; the controller cares about NOW)
        misses = (s.get("deadline_missed_queued", 0)
                  + s.get("deadline_missed_running", 0))
        finished = s.get("finished", 0)
        d_miss = max(0, misses - self._prev_misses)
        d_fin = max(0, finished - self._prev_finished)
        self._prev_misses, self._prev_finished = misses, finished
        miss_rate = d_miss / max(1, d_miss + d_fin)

        live = [name for name, r in s.get("replicas", {}).items()
                if r.get("state") == "live" and not r.get("draining")]
        n_live = max(1, len(live))
        backlog = s.get("backlog", 0)
        queue_per_replica = (s.get("queued", 0) + backlog) / n_live
        pool_occ = s.get("pool_occupancy", 0.0)
        n_slots = max(1, s.get("n_slots", 1))
        slot_occ = s.get("in_flight", 0) / n_slots

        overload = (queue_per_replica >= self.slo.queue_high
                    or miss_rate >= self.slo.deadline_miss_rate_high
                    or pool_occ >= self.slo.pool_occupancy_high)
        underload = (queue_per_replica <= self.slo.queue_low
                     and d_miss == 0
                     and slot_occ <= self.slo.slot_occupancy_low)
        if overload:
            self._overload_n += 1
            self._underload_n = 0
            self._calm_n = 0
        elif underload:
            self._underload_n += 1
            self._overload_n = 0
            self._calm_n += 1
        else:
            # the dead band: decay both — a steady trace actuates nothing
            self._overload_n = 0
            self._underload_n = 0
            self._calm_n += 1

        # a scale-down in flight owns the membership channel: finish or
        # abandon it before considering anything else
        if self._victim is not None:
            self._advance_drain(s, now)
            return

        self._spec_posture(pool_occ, max(slot_occ, s.get(
            "decode_occupancy", 0.0)))
        self._horizon_posture(max(pool_occ, slot_occ, s.get(
            "decode_occupancy", 0.0)), d_miss)
        self._rebalance_hints(s)

        if self._overload_n >= self.hold_up:
            self._handle_overload(s, now, len(live))
        elif self.state in ("shed", "backpressure") \
                and self._calm_n >= self.hold_down:
            self._unwind_ladder(now)
        elif self._underload_n >= self.hold_down \
                and len(live) > self.min_replicas \
                and self._cooldown_ok(now):
            self._begin_scale_down(s, now, live)

    # ---- scale down (two-phase: drain, then remove) ------------------------
    def _begin_scale_down(self, s: dict, now: float,
                          live: list[str]) -> None:
        victim = min(live, key=lambda n: s["replicas"][n].get("load", 0.0))
        self.router.replicas[victim].drain()
        self._victim = victim
        self.state = "draining"
        self._last_action_at = now
        self._underload_n = 0
        self._note("drain", victim)

    def _advance_drain(self, s: dict, now: float) -> None:
        victim = self._victim
        rep = self.router.replicas.get(victim)
        if rep is None or rep.state != "live":
            # chaos won the race: the draining replica died or was
            # fenced — the router already resubmitted its in-flight
            # work, and removing a corpse we never finished draining
            # would double-handle it. Abandon the intent.
            self._victim = None
            self.state = "steady"
            self._note("scale_down_abandoned", victim,
                       reason="victim_not_live")
            return
        per = s.get("replicas", {}).get(victim, {})
        drained = (not rep.engine.has_work
                   and per.get("queued", 0) == 0
                   and per.get("active_slots", 0) == 0)
        if drained:
            try:
                self.router.remove_replica(victim)
            except ValueError:
                # chaos shrank the fleet under the intent: the victim is
                # now the LAST live replica and removing it is illegal.
                # Abandon AND un-drain it — a draining last replica
                # would refuse every admission forever
                rep.engine.draining = False
                self._victim = None
                self.state = "steady"
                self._note("scale_down_abandoned", victim,
                           reason="remove_refused")
                return
            self._victim = None
            self.state = "steady"
            self._last_action_at = now
            self._note("scale_down", victim)

    # ---- scale up / degradation ladder -------------------------------------
    def _handle_overload(self, s: dict, now: float, n_live: int) -> None:
        if n_live < self.max_replicas and self._cooldown_ok(now):
            if self._try_scale_up(now):
                self._overload_n = 0
                return
        # at capacity (or spawn failed): degrade in declared order
        if self.state not in ("shed", "backpressure"):
            self.router.min_priority = self.slo.shed_below_priority
            self.state = "shed"
            self._overload_n = 0
            self._note("shed_on", None,
                       min_priority=self.slo.shed_below_priority)
        elif self.state == "shed":
            self.router.retry_after_floor_s = self.slo.retry_after_floor_s
            self.state = "backpressure"
            self._overload_n = 0
            self._note("backpressure_on", None,
                       retry_after_floor_s=self.slo.retry_after_floor_s)
        # state == "backpressure": the ladder is fully deployed; nothing
        # further is legal (the next rung would corrupt running work)

    def _try_scale_up(self, now: float) -> bool:
        spawn = self._spawn
        if spawn is None:
            spawn = self._default_spawn
        t_spawn = self.clock()
        try:
            replica = spawn()
        except Exception as exc:
            self._note("spawn_failed", None, error=str(exc))
            return False
        # spawn -> /readyz, measured: poll the same readiness gate the
        # HTTP prober serves until it passes (bounded — an in-process
        # clone is ready immediately; a real process spawn warms up)
        ready = False
        for _ in range(self.spawn_ready_polls):
            ready, _reasons = readiness(replica.engine.stats())
            if ready:
                break
        if not ready:
            self._note("spawn_failed", replica.name, error="never_ready")
            close = getattr(replica.engine, "close", None)
            if close is not None:
                close()
            return False
        cold_start_s = self.clock() - t_spawn
        self.router.add_replica(replica)
        self.cold_starts.append(cold_start_s)
        self._last_action_at = now
        self._note("scale_up", replica.name,
                   cold_start_s=round(cold_start_s, 4))
        return True

    def _default_spawn(self) -> Replica:
        from .elastic import spawn_like

        return spawn_like(self.router)

    def _unwind_ladder(self, now: float) -> None:
        if self.state == "backpressure":
            self.router.retry_after_floor_s = 0.0
            self.state = "shed"
            self._note("backpressure_off")
        elif self.state == "shed":
            self.router.min_priority = None
            self.state = "steady"
            self._note("shed_off")
        self._calm_n = 0

    # ---- posture (non-membership actuation) --------------------------------
    def _spec_posture(self, pool_occ: float, decode_occ: float) -> None:
        occ = max(pool_occ, decode_occ)
        if self._spec_on and occ >= self.slo.spec_off_occupancy:
            changed = self._toggle_spec(False)
            self._spec_on = False
            if changed:
                self._note("spec_off", None, occupancy=round(occ, 3))
        elif not self._spec_on and occ <= self.slo.spec_on_occupancy:
            changed = self._toggle_spec(True)
            self._spec_on = True
            if changed:
                self._note("spec_on", None, occupancy=round(occ, 3))

    def _toggle_spec(self, on: bool) -> bool:
        changed = False
        for rep in self.router.replicas.values():
            if rep.state != "live":
                continue
            fn = getattr(rep.engine, "set_speculation", None)
            if fn is None:
                continue
            before = getattr(rep.engine, "drafter", None) is not None
            after = fn(on)
            changed = changed or (before != after)
        return changed

    def _horizon_posture(self, occ: float, d_miss: int) -> None:
        """Actuate the fused decode horizon (see the SLO fields): wide
        under sustained batch pressure, K=1 the moment deadline misses
        appear or the batch thins. A miss snaps the horizon shut with no
        hysteresis — a missed deadline is evidence the K·step ITL burst
        already cost goodput."""
        if self.slo.horizon_max <= 1:
            return
        if self._horizon_wide and (
                d_miss > 0 or occ <= self.slo.horizon_shrink_occupancy):
            changed = self._set_horizon(1)
            self._horizon_wide = False
            if changed:
                self._note("horizon_shrink", None, occupancy=round(occ, 3),
                           deadline_misses=d_miss)
        elif not self._horizon_wide and d_miss == 0 \
                and occ >= self.slo.horizon_grow_occupancy:
            changed = self._set_horizon(self.slo.horizon_max)
            self._horizon_wide = True
            if changed:
                self._note("horizon_grow", None, occupancy=round(occ, 3),
                           horizon=self.slo.horizon_max)

    def _set_horizon(self, k: int) -> bool:
        changed = False
        for rep in self.router.replicas.values():
            if rep.state != "live":
                continue
            fn = getattr(rep.engine, "set_decode_horizon", None)
            if fn is None:
                continue
            before = getattr(rep.engine, "decode_horizon", 1)
            try:
                after = fn(k)
            except ValueError:
                continue        # drafter attached: spec keeps this one K=1
            changed = changed or (before != after)
        return changed

    def _rebalance_hints(self, s: dict) -> None:
        """Advisory prefill-vs-decode imbalance hints for disaggregated
        replicas: emitted when one side idles while the other backs up.
        Hints only — re-splitting the pair is a generation swap the
        operator owns (see module docstring)."""
        for name, rep in self.router.replicas.items():
            if rep.state != "live":
                continue
            es_fn = getattr(rep.engine, "stats", None)
            if es_fn is None:
                continue
            es = es_fn()
            if "handoff_pending" not in es:
                continue            # not a disagg pair
            n_pre = max(1, es.get("n_prefill_slots", 1))
            prefill_backlog = es.get("queued", 0) / n_pre
            decode_idle = es.get("active_slots", 0) == 0
            handoff_backlog = es.get("handoff_pending", 0)
            hint = None
            if prefill_backlog >= self.slo.queue_high and decode_idle:
                hint = "toward_prefill"     # prompts queue, decodes starve
            elif handoff_backlog > 0 and es.get("prefilling_slots", 0) == 0 \
                    and es.get("queued", 0) == 0:
                hint = "toward_decode"      # prefill done, decode can't seat
            key = f"{name}:{hint}"
            if hint is not None and key != self._last_hint:
                self._last_hint = key
                self._note("rebalance_hints", name, direction=hint)

    # ---- reporting ---------------------------------------------------------
    def stats(self) -> dict:
        """The controller's own snapshot (host-side, lock-free — same
        contract as the engines'): state machine position, actuation
        counters, measured cold starts, and the action tail."""
        return {
            "state": self.state,
            "draining_victim": self._victim,
            "overload_n": self._overload_n,
            "underload_n": self._underload_n,
            **self.counters,
            "cold_start_s": list(self.cold_starts),
            "n_actions": len(self.actions),
            "recent_actions": self.actions[-8:],
        }
