"""Fleet router: the front door above N engine replicas.

Counterpart of ``distributed_training_guide_tpu/serve/router.py``, host
Python over this package's engines (every replica runs the port's
kernels: K4 on every path, K5 under adapters, K7 under int8 weights):

- **Prefix-affinity routing**: the prompt's page-aligned proper prefix
  (the pages a replica's :class:`~.scheduler.PrefixCache` can hold)
  hashes to a rendezvous (HRW) order over the live replicas, so
  shared-prefix traffic lands where its pages already are. The key is a
  content hash of (prompt, page_size, adapter), the JAX package's own.
- **Load-aware admission** from the engines' lock-free ``stats()``
  snapshots (queue depth, decode occupancy, pool occupancy).
- **Spillover with bounded backoff**: a 429 marks the refusing replica
  unroutable for its ``retry_after_s`` hint and the request tries the
  next candidate; only when every candidate refuses does the
  backpressure reach the caller.
- **Heartbeat-driven health** (``utils/heartbeat.py``): a replica that
  stops beating (dead or wedged) is FENCED: never routed or stepped
  again, and every request in flight on it is resubmitted to a healthy
  replica where the prompt re-prefills and the tokens the router has
  seen replay through the decode step. Replicas share params, so the
  continuation is token-identical to an uninterrupted run. A request
  that cannot be placed after bounded retries finishes with
  ``finish_reason="resubmit_exhausted"`` and the strict prefix seen.
- **The fleet prefix directory**: each replica's committed prefix keys
  (``stats()["prefix_keys"]``); on an affinity miss the router pulls the
  missing chain from a sibling over the transport
  (``tiering.pull_prefix``).
- **Membership and publishes**: ``add_replica`` / ``remove_replica`` /
  ``swap_replica`` (``serve/elastic.py``), and all-or-nothing fleet
  publishes of params and adapters. A params publish also drops every
  replica's cached prefix k/v, shared programs or not.

The router has the engine driving surface (``submit`` / ``step`` /
``has_work`` / ``partial_tokens`` / ``stats``), so ``serve/api.py`` runs
over a fleet unchanged. Faults (``utils/faults.py``): replica kill and
wedge at a named (replica, router step), and a slow replica.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
from typing import Optional

import numpy as np

from ..utils import faults
from ..utils.heartbeat import HeartbeatMonitor, HeartbeatWriter
from .scheduler import RefusalError, Request, RequestResult
from .tiering import prefix_digest, pull_prefix


def prefix_affinity_key(prompt_ids, page_size: int,
                        adapter_id: int = 0) -> Optional[bytes]:
    """Content hash of the prompt's page-aligned PROPER prefix — the
    exact tokens a :class:`PrefixCache` could serve from shared pages
    (full pages only, and at least one token always recomputes, mirroring
    ``PrefixCache.match``). None when the prompt owns no full cacheable
    page: affinity has nothing to win there, so routing degrades to
    least-loaded. Stable across processes and engine configs — it sees
    only (prompt, page_size, adapter), never prefill mode or kv dtype.

    The adapter id extends the key because cached pages are namespaced
    per adapter slot: the same prefix under two tenants shares NOTHING,
    so steering them to one replica wins nothing. Adapter 0 keys are
    bitwise-unchanged from the pre-multi-LoRA key (base traffic keeps
    its affinity assignments across an upgrade)."""
    n_full = (len(prompt_ids) - 1) // page_size
    if n_full < 1:
        return None
    # delegates to the tiering module's digest so the fleet directory's
    # cache-exported keys and the router's request keys agree bitwise
    return prefix_digest(prompt_ids[:n_full * page_size], adapter_id)


def rendezvous_order(key: bytes, names) -> list:
    """Highest-random-weight order of ``names`` for ``key``: every
    (key, name) pair scores independently, so fencing one replica moves
    ONLY its keys (to each key's next-highest name) — the rest of the
    fleet's affinity assignments are untouched."""
    def score(name):
        return hashlib.blake2b(key + str(name).encode(),
                               digest_size=8).digest()

    return sorted(names, key=score, reverse=True)


def replica_load(stats: dict) -> float:
    """Scalar load from one engine's lock-free stats() snapshot: queued
    requests dominate (each is a whole admission the newcomer waits
    behind), decode occupancy and pool occupancy break ties."""
    n_slots = max(1, stats.get("n_slots", 1))
    return (stats.get("queued", 0)
            + stats.get("active_slots", 0) / n_slots
            + stats.get("pool_occupancy", 0.0))


def readiness(stats: dict, *, loop_age_s: Optional[float] = None,
              heartbeat_timeout_s: float = 5.0,
              queue_watermark: Optional[int] = None,
              min_free_pages: Optional[int] = None) -> tuple[bool, list]:
    """The /readyz predicate, shared by the HTTP layer and anyone
    probing an engine's stats() directly: liveness (/healthz) answers
    "is the process up", readiness answers "should a router send
    traffic HERE" — a wedged-but-alive or saturated replica is live and
    NOT ready. Returns (ready, reasons); reasons name every failing
    gate so an operator reads the probe, not the source.

    Gates: engine thread alive; not draining; queue depth below the
    watermark (``max_queue`` when the engine has one, else 8x slots);
    pool headroom of one growth page per decode slot (the scheduler's
    own admission-margin notion); and — when the caller knows it — the
    engine loop's heartbeat age below ``heartbeat_timeout_s``."""
    reasons = []
    if not stats.get("ok", True):
        reasons.append("engine_dead")
    if stats.get("draining"):
        reasons.append("draining")
    n_slots = max(1, stats.get("n_slots", 1))
    watermark = queue_watermark
    if watermark is None:
        watermark = stats.get("max_queue") or 8 * n_slots
    if stats.get("queued", 0) >= watermark:
        reasons.append("queue_depth")
    need = n_slots if min_free_pages is None else min_free_pages
    if stats.get("pages_free", need) < need:
        reasons.append("pool_headroom")
    if loop_age_s is not None and loop_age_s > heartbeat_timeout_s:
        reasons.append("heartbeat_stale")
    return (not reasons, reasons)


class Replica:
    """One engine under the router: health state, a heartbeat, and the
    fault hooks the chaos drills drive.

    Lifecycle: ``live`` (routable; ``drain()`` keeps it live but
    unroutable while it finishes) -> ``dead`` (SIGKILL model: instant,
    no cleanup — ``kill()``) or fenced by the router (stale heartbeat /
    raised step). ``wedge()`` is the nastier failure: the replica stays
    "alive" but stops stepping AND stops beating — a stuck device op —
    so only the heartbeat age catches it. Fencing is permanent for the
    router's lifetime: a fenced replica's in-flight work was resubmitted,
    so letting it un-wedge and finish would double-issue tokens.

    The heartbeat is an in-memory stamp by default; give
    ``heartbeat_path`` to write the real ``utils/heartbeat.py`` file
    (what separate-process replicas would use) — the router then reads
    the age through :class:`HeartbeatMonitor`, same as the training
    supervisor reads its workers."""

    def __init__(self, name: str, engine, *,
                 heartbeat_path: Optional[str] = None,
                 clock=time.monotonic):
        self.name = name
        self.engine = engine
        self.clock = clock
        self.state = "live"             # live | dead | fenced
        self.wedged = False
        self.unroutable_until = 0.0     # 429-backoff window (router-set)
        self.steps = 0
        self._beat_at = clock()
        self._writer = (HeartbeatWriter(heartbeat_path, min_interval_s=0.0)
                        if heartbeat_path else None)
        self._monitor = (HeartbeatMonitor(heartbeat_path)
                         if heartbeat_path else None)
        if self._writer is not None:
            self._writer.beat(0, force=True)

    def step(self) -> list[RequestResult]:
        if self.state != "live" or self.wedged:
            return []
        # the gray-failure drill: a targeted replica keeps stepping and
        # beating, but every iteration drags — nothing here fences it,
        # only load-aware routing and the control plane's SLO loop see it
        drag = faults.replica_slow(self.name)
        if drag > 0 and self.engine.has_work:
            time.sleep(drag)
        finished = self.engine.step() if self.engine.has_work else []
        self.steps += 1
        self._beat_at = self.clock()
        if self._writer is not None:
            self._writer.beat(self.steps, force=True)
        return finished

    def heartbeat_age(self, now: Optional[float] = None) -> float:
        """Seconds since the last beat — file-based when a heartbeat
        path is configured (the cross-process truth), the in-memory
        stamp otherwise."""
        if self._monitor is not None:
            age = self._monitor.age_s()
            return float("inf") if age is None else age
        return (self.clock() if now is None else now) - self._beat_at

    def forgive_idle_gap(self) -> None:
        """Reset the beat after a window in which the ROUTER itself was
        idle (no step() calls reached any replica): a missing beat is
        only evidence of a wedge while the replica was being driven —
        fencing on an unobserved window would fence a healthy fleet the
        moment traffic resumes. A genuinely wedged replica is caught
        within ``heartbeat_timeout_s`` of the driving resuming."""
        self._beat_at = self.clock()
        if self._writer is not None:
            self._writer.beat(self.steps, force=True)

    def kill(self) -> None:
        """The SIGKILL model: instant death, nothing drained, nothing
        handed off — the worst case the router must absorb."""
        self.state = "dead"

    def wedge(self) -> None:
        self.wedged = True

    def drain(self) -> None:
        self.engine.drain()

    @property
    def draining(self) -> bool:
        return bool(getattr(self.engine, "draining", False))


@dataclasses.dataclass
class _RouteRecord:
    """Router-side ledger entry for one in-flight request: where it is,
    and every token the router has SEEN — the replay state a fence
    recovery resubmits (tokens produced after the last step's tap are
    regenerated identically by the position-keyed sampler)."""
    rid: int
    request: Request
    replica: Optional[str] = None
    engine_rid: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    first_token_at: float = 0.0
    submitted_at: float = 0.0
    resubmits: int = 0
    not_before: float = 0.0         # backlog retry gate


class Router:
    """The fleet front door (see module docstring). Drive it exactly
    like an engine: ``submit()`` routes, ``step()`` advances every live
    replica once + runs health checks + drains the resubmission backlog,
    ``stats()`` aggregates the fleet and itemizes per-replica health."""

    def __init__(self, replicas: list[Replica], *,
                 heartbeat_timeout_s: float = 2.0,
                 max_route_attempts: int = 3,
                 max_resubmits: int = 8,
                 resubmit_backoff_s: float = 0.05,
                 clock=time.monotonic):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        page_sizes = {r.engine.page_size for r in replicas}
        if len(page_sizes) != 1:
            raise ValueError(
                f"replicas disagree on page_size ({sorted(page_sizes)}) — "
                f"the prefix-affinity key is page-aligned and a mixed "
                f"fleet would split identical prefixes across engines")
        for knob in ("kv_dtype", "weight_dtype"):
            vals = {getattr(r.engine, knob, None) for r in replicas}
            if len(vals) != 1:
                raise ValueError(
                    f"replicas disagree on {knob} ({sorted(map(str, vals))})"
                    f" — a mixed-precision fleet breaks routing identity "
                    f"(the same request would sample different tokens per "
                    f"replica) and the all-or-nothing publish contract")
        adapter_cfgs = {
            (None if getattr(r.engine, "adapter_pool", None) is None
             else (r.engine.adapter_pool.max_adapters,
                   r.engine.adapter_pool.rank,
                   r.engine.adapter_pool.alpha,
                   r.engine.adapter_pool.targets))
            for r in replicas}
        if len(adapter_cfgs) != 1:
            raise ValueError(
                f"replicas disagree on adapter pool config "
                f"({sorted(map(str, adapter_cfgs))}) — a tenant's slot id "
                f"must mean the same weights on every replica, or "
                f"resubmitting a fenced request would decode under a "
                f"different adapter (or refuse outright)")
        self.replicas: dict[str, Replica] = {r.name: r for r in replicas}
        self.page_size = page_sizes.pop()
        self.kv_dtype = getattr(replicas[0].engine, "kv_dtype", None)
        self.weight_dtype = getattr(replicas[0].engine, "weight_dtype", None)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.max_route_attempts = max_route_attempts
        self.max_resubmits = max_resubmits
        self.resubmit_backoff_s = resubmit_backoff_s
        self.clock = clock
        self.step_count = 0
        self._last_step_at: Optional[float] = None
        self._ids = itertools.count()
        self._records: dict[int, _RouteRecord] = {}
        self._by_engine: dict[tuple, int] = {}
        self._backlog: list[int] = []
        self.counters = {"routed": 0, "affinity_routed": 0,
                         "spillovers": 0, "fenced": 0, "resubmitted": 0,
                         "resubmit_exhausted": 0, "replicas_added": 0,
                         "replicas_removed": 0, "generation_swaps": 0,
                         "param_publishes": 0, "adapter_publish_calls": 0,
                         "directory_pulls": 0, "directory_pull_hits": 0,
                         "directory_pull_failures": 0,
                         "refused": {}}
        # fleet prefix directory: replica name -> (stats_seq, frozenset
        # of committed prefix-key hex digests). Fed only from the
        # replicas' lock-free stats() snapshots (refreshed in step()
        # when a snapshot's stats_seq advances — the same staleness
        # fence /healthz pollers use), dropped on fence/removal. An
        # entry can lag the cache by one step; both failure modes are
        # benign — a stale hit becomes a failed pull (= plain miss), a
        # stale miss just re-prefills as before.
        self._directory: dict[str, tuple[int, frozenset]] = {}
        self._xfer_ids = itertools.count(1)
        # the control plane's degradation-ladder knobs (serve/controller
        # sets them; anything may): ``min_priority`` sheds submits below
        # that class with a 429 before routing even starts, and
        # ``retry_after_floor_s`` raises every backpressure refusal's
        # retry hint so clients back off harder under sustained overload.
        # Both act only on NEW admissions — in-flight sequences are never
        # touched (refuse, never corrupt).
        self.min_priority: Optional[int] = None
        self.retry_after_floor_s: float = 0.0

    # ---- routing -----------------------------------------------------------
    def _routable(self, now: float, exclude=()) -> list[Replica]:
        return [r for r in self.replicas.values()
                if r.state == "live" and not r.draining
                and r.name not in exclude and now >= r.unroutable_until]

    def _candidates(self, request: Request, now: float,
                    exclude=()) -> tuple[list[Replica], bool]:
        """(ordered candidates, used_affinity): the affinity target
        first when the prompt has a key, spillover (and key-less
        traffic) ordered by load."""
        live = self._routable(now, exclude)
        if not live:
            return [], False
        key = prefix_affinity_key(request.prompt_ids, self.page_size,
                                  adapter_id=request.adapter_id)
        by_load = sorted(live, key=lambda r: replica_load(r.engine.stats()))
        if key is None:
            return by_load, False
        preferred = rendezvous_order(key, [r.name for r in live])[0]
        return ([self.replicas[preferred]]
                + [r for r in by_load if r.name != preferred]), True

    def _place(self, record: _RouteRecord, now: float) -> None:
        """Try each candidate in order; raises the decisive RefusalError
        when no replica takes the request (429 everywhere -> the soonest
        retry hint propagates; a 400-class refusal propagates from the
        first replica — it would fail everywhere)."""
        candidates, used_affinity = self._candidates(record.request, now)
        if not candidates:
            raise RefusalError(
                "no_replica", "no live, routable replica in the fleet",
                http_status=503,
                detail={"queue_depth": len(self._backlog),
                        "retry_after_s": self.resubmit_backoff_s})
        last_429 = None
        for i, replica in enumerate(candidates[:self.max_route_attempts]):
            try:
                if record.generated or record.resubmits:
                    # thread the ORIGINAL client submit time through: the
                    # engine-side scheduler would otherwise restamp its
                    # clock at requeue, and TTFT/deadline accounting
                    # would restart on every fence/spillover hop
                    erid = replica.engine.resubmit(
                        record.request, record.generated,
                        first_token_at=record.first_token_at,
                        submitted_at=record.submitted_at)
                else:
                    erid = replica.engine.submit(record.request)
            except RefusalError as exc:
                if exc.http_status in (429, 503):
                    replica.unroutable_until = now + (
                        exc.retry_after_s or self.resubmit_backoff_s)
                    self.counters["refused"][exc.reason] = \
                        self.counters["refused"].get(exc.reason, 0) + 1
                    last_429 = exc
                    continue
                raise               # a request no replica could ever run
            record.replica, record.engine_rid = replica.name, erid
            self._by_engine[(replica.name, erid)] = record.rid
            self._maybe_pull_prefix(replica, record.request)
            self.counters["routed"] += 1
            if used_affinity and i == 0:
                self.counters["affinity_routed"] += 1
            if i > 0:
                self.counters["spillovers"] += 1
            return
        if self.retry_after_floor_s and (
                last_429.retry_after_s is None
                or last_429.retry_after_s < self.retry_after_floor_s):
            # ladder rung 2 (tighten admission): every propagated
            # backpressure hint is at least the controller's floor
            last_429 = RefusalError(
                last_429.reason, str(last_429),
                http_status=last_429.http_status,
                detail={**last_429.detail,
                        "retry_after_s": self.retry_after_floor_s})
        raise last_429

    def _maybe_pull_prefix(self, replica: Replica,
                           request: Request) -> None:
        """Directory-guided prefix pull: the request just landed on
        ``replica``; if its page-aligned prefix key is absent from that
        replica's directory entry but present on a live sibling, move
        the cached pages over the wire BEFORE the replica's next step
        prefills — a directory hit on a cold replica then seats the
        prefix with zero prefill forward passes. Every failure mode
        (wire fault, allocation loss, stale directory) ends as an
        ordinary cache miss: the request re-prefills exactly as it
        would have without a directory."""
        key = prefix_affinity_key(request.prompt_ids, self.page_size,
                                  adapter_id=request.adapter_id)
        if key is None or not hasattr(replica.engine, "scatter_pages"):
            return
        hexkey = key.hex()
        _, local_keys = self._directory.get(replica.name, (0, frozenset()))
        if hexkey in local_keys:
            return
        for name, (_, keys) in self._directory.items():
            if name == replica.name or hexkey not in keys:
                continue
            src = self.replicas.get(name)
            if src is None or src.state != "live" \
                    or not hasattr(src.engine, "gather_pages"):
                continue
            self.counters["directory_pulls"] += 1
            try:
                out = pull_prefix(src.engine, replica.engine,
                                  list(request.prompt_ids),
                                  adapter_id=request.adapter_id,
                                  xfer_id=next(self._xfer_ids))
            except Exception:
                out = {"ok": False}
            if out.get("ok") and out.get("pages", 0) > 0:
                self.counters["directory_pull_hits"] += 1
            elif not out.get("ok"):
                self.counters["directory_pull_failures"] += 1
            return

    def _refresh_directory(self) -> None:
        """Fold each live replica's advertised prefix keys into the
        directory, fenced by ``stats_seq``: a snapshot that has not
        advanced since the last fold is skipped (nothing new), and a
        raced walk (empty keys at an advanced seq) keeps the previous
        entry rather than blanking a replica that still holds pages."""
        for name, replica in self.replicas.items():
            if replica.state != "live":
                continue
            try:
                s = replica.engine.stats()
            except Exception:
                continue
            seq = s.get("stats_seq", 0)
            prev_seq, prev_keys = self._directory.get(name,
                                                      (-1, frozenset()))
            if seq <= prev_seq:
                continue
            keys = s.get("prefix_keys", None)
            if keys:
                self._directory[name] = (seq, frozenset(keys))
            elif keys is not None and not prev_keys:
                self._directory[name] = (seq, frozenset())

    def submit(self, request: Request) -> int:
        now = self.clock()
        if self.min_priority is not None \
                and request.priority < self.min_priority:
            # ladder rung 1 (shed): lowest-priority classes refuse at the
            # front door under sustained overload — a structured 429 with
            # a retry hint, never an admitted request later corrupted
            self.counters["refused"]["shed_low_priority"] = \
                self.counters["refused"].get("shed_low_priority", 0) + 1
            raise RefusalError(
                "shed_low_priority",
                f"fleet is shedding priority < {self.min_priority} under "
                f"sustained overload; retry later",
                http_status=429,
                detail={"queue_depth": len(self._backlog),
                        "retry_after_s": max(self.retry_after_floor_s,
                                             self.resubmit_backoff_s)})
        record = _RouteRecord(rid=next(self._ids), request=request,
                              submitted_at=now)
        self._place(record, now)
        self._records[record.rid] = record
        return record.rid

    # ---- health + recovery -------------------------------------------------
    def _resubmit_in_flight(self, replica: Replica) -> int:
        """Move every request in flight on ``replica`` to the
        resubmission backlog (the fence-recovery path: the prompt
        re-prefills elsewhere and the seen tokens replay bitwise).
        Shared by fencing (failure) and ``remove_replica`` (intent)."""
        moved = 0
        for rid, record in self._records.items():
            if record.replica == replica.name:
                self._by_engine.pop((replica.name, record.engine_rid), None)
                record.replica = record.engine_rid = None
                record.resubmits += 1
                record.not_before = self.clock() + self.resubmit_backoff_s
                if rid not in self._backlog:
                    self._backlog.append(rid)
                self.counters["resubmitted"] += 1
                moved += 1
        return moved

    def _fence(self, replica: Replica) -> None:
        """Permanently stop routing/stepping a replica and move its
        in-flight requests to the resubmission backlog."""
        replica.state = "fenced"
        self.counters["fenced"] += 1
        # a fenced replica's cached pages are unreachable — advertising
        # them would turn every directory hit into a failed pull
        self._directory.pop(replica.name, None)
        self._resubmit_in_flight(replica)

    def _exhaust(self, record: _RouteRecord,
                 now: float) -> RequestResult:
        """The structured give-up: the tokens the router saw are a
        STRICT PREFIX of the request's uninterrupted stream (bitwise
        replay guarantees no divergence, only truncation), and the
        finish_reason tells the client to retry — never a silent loss."""
        self.counters["resubmit_exhausted"] += 1
        return RequestResult(
            request_id=record.rid,
            prompt_ids=list(record.request.prompt_ids),
            generated_ids=list(record.generated),
            finish_reason="resubmit_exhausted",
            submitted_at=record.submitted_at, admitted_at=now,
            finished_at=now, first_token_at=record.first_token_at)

    def _drain_backlog(self, now: float) -> list[RequestResult]:
        failed = []
        for rid in list(self._backlog):
            record = self._records.get(rid)
            if record is None:
                self._backlog.remove(rid)
                continue
            # zero live replicas can't improve by waiting — fail fast
            # with the structured result instead of burning the backoff
            if not any(r.state == "live" for r in self.replicas.values()):
                self._backlog.remove(rid)
                del self._records[rid]
                failed.append(self._exhaust(record, now))
                continue
            if now < record.not_before:
                continue
            if record.resubmits > self.max_resubmits:
                self._backlog.remove(rid)
                del self._records[rid]
                failed.append(self._exhaust(record, now))
                continue
            try:
                self._place(record, now)
                self._backlog.remove(rid)
            except RefusalError:
                # exponential, bounded: every retry doubles the wait
                record.resubmits += 1
                record.not_before = now + self.resubmit_backoff_s \
                    * (2 ** record.resubmits)
        return failed

    def _translate(self, replica: Replica,
                   results: list[RequestResult]) -> list[RequestResult]:
        out = []
        for res in results:
            rid = self._by_engine.pop((replica.name, res.request_id), None)
            if rid is None:
                continue            # not ours (shouldn't happen)
            record = self._records.pop(rid)
            record.generated = list(res.generated_ids)
            out.append(dataclasses.replace(
                res, request_id=rid, submitted_at=record.submitted_at))
        return out

    def _tap_tokens(self) -> None:
        """Refresh every record's seen-token ledger from the live
        replicas' partial_tokens() — the state a fence recovery replays.
        Lists only grow (the engines' documented tap contract), so the
        ledger can never regress a stream."""
        for name, replica in self.replicas.items():
            if replica.state != "live":
                continue
            for erid, toks in replica.engine.partial_tokens().items():
                rid = self._by_engine.get((name, erid))
                record = self._records.get(rid) if rid is not None else None
                if record is not None and len(toks) > len(record.generated):
                    record.generated = list(toks)
                    if not record.first_token_at:
                        record.first_token_at = self.clock()

    def step(self) -> list[RequestResult]:
        """One fleet iteration: inject any scheduled faults, fence dead/
        stale replicas (resubmitting their in-flight work), advance every
        live replica one engine iteration, refresh the token ledger, and
        retry the backlog."""
        self.step_count += 1
        now = self.clock()
        # heartbeat age is only meaningful while the router is DRIVING
        # the replicas: the HTTP worker stops stepping an idle router,
        # and fencing the whole fleet for that silence would kill the
        # first request after any quiet spell (found driving the real
        # server). Forgive unobserved windows — measured from the END of
        # the previous step to the START of this one, so a SLOW step
        # (time spent inside replica.step calls) never counts as idle
        # and cannot mask a wedged replica's growing age.
        if self._last_step_at is None \
                or now - self._last_step_at > self.heartbeat_timeout_s / 2:
            for replica in self.replicas.values():
                if replica.state == "live":
                    replica.forgive_idle_gap()
        finished: list[RequestResult] = []
        for name, replica in self.replicas.items():
            fault = faults.replica_fault(name, self.step_count)
            if fault == "kill":
                replica.kill()
            elif fault == "wedge":
                replica.wedge()
        for replica in self.replicas.values():
            if replica.state == "fenced":
                continue
            if replica.state == "dead" \
                    or replica.heartbeat_age(now) > self.heartbeat_timeout_s:
                self._fence(replica)
        for replica in self.replicas.values():
            if replica.state != "live":
                continue
            try:
                finished.extend(self._translate(replica, replica.step()))
            except Exception:
                # an engine error is a replica failure, not a fleet one:
                # fence it (resubmitting its work) and keep serving
                self._fence(replica)
        self._tap_tokens()
        self._refresh_directory()
        finished.extend(self._drain_backlog(self.clock()))
        self._last_step_at = self.clock()
        return finished

    # ---- fleet membership (mutable at runtime) ------------------------------
    def add_replica(self, replica: Replica) -> None:
        """Grow the fleet: the replica becomes routable immediately.
        Rendezvous hashing means only the keys that now score highest on
        the newcomer move to it — existing replicas' affinity assignments
        are untouched (the HRW property fencing already leans on)."""
        if replica.name in self.replicas:
            raise ValueError(f"replica name {replica.name!r} already in "
                             f"the fleet")
        if replica.engine.page_size != self.page_size:
            raise ValueError(
                f"replica {replica.name!r} has page_size "
                f"{replica.engine.page_size} but the fleet routes affinity "
                f"at page_size {self.page_size} — a mixed fleet would "
                f"split identical prefixes across engines")
        for knob, fleet_val in (("kv_dtype", self.kv_dtype),
                                ("weight_dtype", self.weight_dtype)):
            val = getattr(replica.engine, knob, None)
            if val != fleet_val:
                raise ValueError(
                    f"replica {replica.name!r} has {knob}={val!r} but the "
                    f"fleet serves {knob}={fleet_val!r} — a scale-up "
                    f"replica at a different precision breaks routing "
                    f"identity and the all-or-nothing publish contract "
                    f"(spawn_like inherits the source engine's config; "
                    f"use it instead of a bare constructor)")
        self.replicas[replica.name] = replica
        self.counters["replicas_added"] += 1

    def remove_replica(self, name: str) -> None:
        """Shrink the fleet WITHOUT killing anything: the replica drains
        (unroutable, finishes nothing new) and its in-flight requests
        move through the existing fence-recovery path — resubmitted to
        healthy replicas where the prompt re-prefills and the seen tokens
        replay bitwise. The replica then leaves the fleet; its engine's
        transport is closed. Intent-shaped removal, not a kill: no token
        any client saw is lost or changed."""
        if name not in self.replicas:
            raise ValueError(f"no replica named {name!r}")
        live_others = [r for n, r in self.replicas.items()
                       if n != name and r.state == "live"]
        if not live_others:
            raise ValueError(
                f"cannot remove {name!r}: it is the last live replica — "
                f"its in-flight work would have nowhere to resubmit")
        replica = self.replicas[name]
        replica.drain()
        self._directory.pop(name, None)
        self._resubmit_in_flight(replica)
        replica.state = "removed"
        del self.replicas[name]
        close = getattr(replica.engine, "close", None)
        if close is not None:
            close()
        self.counters["replicas_removed"] += 1

    def swap_replica(self, name: str, *, params=None,
                     **overrides) -> list[RequestResult]:
        """Live engine-generation swap for one replica
        (``serve/elastic.py``): grow/shrink its ``n_slots`` / page pool
        in place without dropping in-flight requests. The swap preserves
        engine request ids, so the router's ledger — ``_by_engine``,
        streaming taps, fence recovery — remains valid across it; only
        shrink-forced evictions surface, translated to router ids with
        their strict token prefix. Counted in ``generation_swaps``.

        ``params=`` rides through to ``swap_engine``: same-layout
        refreshed weights publish into the replica's shared programs
        before the swap and every carried sequence replays (cache
        rebuilt under the new weights, emitted tokens preserved) — the
        post-training fleet's "publish AND resize" form. For a pure
        weight refresh with no capacity change use ``publish_params``."""
        from .elastic import swap_engine

        replica = self.replicas.get(name)
        if replica is None:
            raise ValueError(f"no replica named {name!r}")
        if replica.state != "live":
            raise ValueError(f"replica {name!r} is {replica.state}; only "
                             f"live replicas swap generations")
        if overrides.get("page_size", self.page_size) != self.page_size:
            # checked BEFORE the swap moves any state: the fleet's
            # affinity keys are page-aligned at one page_size
            raise ValueError("generation swap cannot change page_size — "
                             "the fleet's affinity keys would split")
        new_engine, evicted, stats = swap_engine(replica.engine,
                                                 params=params, **overrides)
        replica.engine = new_engine
        self.counters["generation_swaps"] += 1
        if params is not None:
            self.counters["param_publishes"] += 1
        return self._translate(replica, evicted)

    def publish_params(self, params, *, name: Optional[str] = None,
                       force: bool = False) -> int:
        """Fleet-wide weight publish (post-training: the trainer's
        policy update reaching every replica WITHOUT a generation swap).
        Publishes the same-layout ``params`` into each live replica's
        program cache — replicas sharing one ``ModelPrograms`` (the
        ``local_fleet`` shape) publish once, counted once. ``name``
        restricts to a single replica. Engines with in-flight work
        refuse unless ``force`` (see ``ServeEngine.publish_params``);
        the fleet-safe pattern is drain-or-idle, then publish.

        The fence-recovery invariant survives because a resubmitted
        request replays on a replica with the SAME published weights —
        publishing to a strict subset of a fleet that shares traffic
        would break that, so a partial publish is the caller's explicit
        choice via ``name``. Returns the number of program caches
        updated."""
        if name is not None and name not in self.replicas:
            raise ValueError(f"no replica named {name!r}")
        targets = ([self.replicas[name]] if name is not None
                   else [r for r in self.replicas.values()
                         if r.state == "live"])
        # all-or-nothing: check EVERY target's in-flight state before
        # touching ANY program cache — a refusal halfway through would
        # leave the fleet on mixed weights, and a fenced request
        # resubmitted across that split would replay its recorded
        # prefix under different weights (exactly the invariant the
        # docstring promises)
        if not force:
            busy = [r.name for r in targets if r.engine.has_work]
            if busy:
                raise RuntimeError(
                    f"publish_params refused: replicas {busy} have "
                    f"in-flight work and a partial publish would leave "
                    f"the fleet on mixed weights — drain first, or pass "
                    f"force=True to accept mid-stream swaps fleet-wide")
        seen: set = set()
        published = 0
        for replica in targets:
            programs = replica.engine.programs
            if id(programs) in seen:
                # the shared programs already took the weights, and the
                # publish dropped every sharer's cached k/v
                continue
            seen.add(id(programs))
            replica.engine.publish_params(params, force=force)
            published += 1
        self.counters["param_publishes"] += published
        return published

    def publish_adapter(self, adapter_params, *, name: Optional[str] = None,
                        slot: Optional[int] = None,
                        replica: Optional[str] = None,
                        force: bool = False) -> int:
        """Fleet-wide adapter insert (a tenant's trained LoRA reaching
        every replica's pool). ``name`` labels the ADAPTER (matching
        ``ServeEngine.publish_adapter``); ``replica`` restricts to one
        replica by its name. Same all-or-nothing discipline as
        ``publish_params``: every target's in-flight state is checked
        before any pool is touched, so a busy replica refuses the WHOLE
        publish — a tenant visible on half the fleet would turn routing
        spillover into unknown_adapter refusals.

        Returns the slot id the adapter landed in. The constructor pins
        identical pool configs fleet-wide and this facade is the only
        fleet-level insert path, so separate pools allocate in lockstep;
        if they ever diverge the mismatch raises loudly rather than
        letting one slot id mean two tenants."""
        if replica is not None and replica not in self.replicas:
            raise ValueError(f"no replica named {replica!r}")
        targets = ([self.replicas[replica]] if replica is not None
                   else [r for r in self.replicas.values()
                         if r.state == "live"])
        if not targets:
            raise RuntimeError("publish_adapter: no live replica")
        if not force:
            busy = [r.name for r in targets if r.engine.has_work]
            if busy:
                raise RuntimeError(
                    f"publish_adapter refused: replicas {busy} have "
                    f"in-flight work and a partial publish would leave "
                    f"the adapter visible on only part of the fleet — "
                    f"drain first, or pass force=True to accept "
                    f"mid-stream inserts fleet-wide")
        seen: set = set()
        slot_id: Optional[int] = None
        for target in targets:
            programs = target.engine.programs
            if id(programs) in seen:
                # the shared pool already took the insert, and the
                # publish dropped the slot's namespace on every sharer
                continue
            sid = target.engine.publish_adapter(adapter_params, name=name,
                                                slot=slot, force=force)
            seen.add(id(programs))
            if slot_id is None:
                slot_id = sid
            elif sid != slot_id:
                raise RuntimeError(
                    f"adapter pools diverged: replica {target.name!r} "
                    f"allocated slot {sid}, expected {slot_id} — the "
                    f"fleet's slot ids no longer agree; re-publish with "
                    f"an explicit slot= after resolving the drift")
        self.counters["adapter_publish_calls"] += 1
        return slot_id

    # ---- the engine-shaped surface -----------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self._records)

    @property
    def n_slots(self) -> int:
        return sum(r.engine.n_slots for r in self.replicas.values()
                   if r.state == "live")

    @property
    def decode_steps(self) -> int:
        return sum(r.engine.decode_steps for r in self.replicas.values())

    @property
    def decode_tokens(self) -> int:
        return sum(r.engine.decode_tokens for r in self.replicas.values())

    def drain(self) -> None:
        for replica in self.replicas.values():
            if replica.state == "live":
                replica.drain()

    def close(self) -> None:
        for replica in self.replicas.values():
            close = getattr(replica.engine, "close", None)
            if close is not None:
                close()

    def partial_tokens(self) -> dict:
        """The fleet streaming tap: every live replica's partials under
        ROUTER ids, plus the seen-token ledger for requests currently in
        the resubmission backlog (their streams pause, never regress)."""
        self._tap_tokens()
        return {rid: list(record.generated)
                for rid, record in self._records.items()
                if record.generated}

    _SUM_KEYS = (
        "admitted", "finished", "preempted", "preemptions",
        "admission_blocked", "prefix_hits", "prefix_tokens_shared",
        "cow_forks", "cache_evicted_pages", "deadline_expired",
        "deadline_missed_queued", "deadline_missed_running",
        "spec_lookahead_clamped",
        "queued", "active_slots", "prefilling_slots", "pages_capacity",
        "pages_free", "pages_held", "pages_cached", "decode_steps",
        "decode_tokens", "spec_steps", "spec_tokens_drafted",
        "spec_tokens_accepted", "spec_tokens_rejected",
        "host_tier_bytes", "host_tier_budget_bytes", "spilled_pages",
        "restore_hits", "restore_misses", "prefill_calls",
        # fused-horizon raw counters: RAW SUMS cross replica boundaries
        # (the per-replica ratios do not), so the fleet-level
        # tokens_per_dispatch/horizon_effective re-derive from these
        "host_dispatches", "horizon_ksum")

    def stats(self) -> dict:
        """Fleet aggregate + per-replica health, all host-side (each
        engine's stats() is already lock-free). Counter keys sum across
        live AND fenced replicas — work a fenced replica finished before
        dying still happened — and the derived ratios are recomputed
        from the sums, not averaged."""
        per, agg = {}, {k: 0 for k in self._SUM_KEYS}
        refused: dict = {}
        depths: dict = {}
        adapter_requests: dict = {}
        pools: dict = {}
        now = self.clock()
        for name, replica in self.replicas.items():
            s = replica.engine.stats() if replica.state != "dead" else {}
            for k in self._SUM_KEYS:
                agg[k] += s.get(k, 0)
            for reason, n in s.get("refused", {}).items():
                refused[reason] = refused.get(reason, 0) + n
            for prio, n in s.get("queue_depth_by_priority", {}).items():
                depths[prio] = depths.get(prio, 0) + n
            for aid, n in s.get("adapter_requests", {}).items():
                adapter_requests[aid] = adapter_requests.get(aid, 0) + n
            # pool gauges dedupe by pool object: a share_programs fleet
            # has ONE pool behind every replica, and summing it per
            # replica would overstate capacity n_replicas-fold
            pool = getattr(replica.engine, "adapter_pool", None)
            if pool is not None and replica.state != "dead":
                pools[id(pool)] = pool
            per[name] = {
                "state": replica.state,
                "wedged": replica.wedged,
                "draining": replica.draining,
                "heartbeat_age_s": round(replica.heartbeat_age(now), 4),
                "stats_seq": s.get("stats_seq", 0),
                "queued": s.get("queued", 0),
                "active_slots": s.get("active_slots", 0),
                "pool_occupancy": s.get("pool_occupancy", 0.0),
                "load": replica_load(s) if s else float("inf"),
            }
        for reason, n in self.counters["refused"].items():
            refused[reason] = refused.get(reason, 0) + n
        n_slots = max(1, self.n_slots)
        drafted = agg["spec_tokens_drafted"]
        adapter_agg: dict = {}
        if pools:
            vals = list(pools.values())
            capacity = sum(p.capacity for p in vals)
            live = sum(p.n_live for p in vals)
            adapter_agg = {
                "adapter_slots": sum(p.max_adapters for p in vals),
                "adapter_capacity": capacity,
                "adapters_live": live,
                "adapters_free": sum(p.n_free for p in vals),
                "adapter_occupancy": (round(live / capacity, 3)
                                      if capacity else 0.0),
                "adapter_inserts": sum(p.stats["inserts"] for p in vals),
                "adapter_updates": sum(p.stats["updates"] for p in vals),
                "adapter_evictions": sum(p.stats["evictions"]
                                         for p in vals),
                "adapter_lru_evictions": sum(p.stats["lru_evictions"]
                                             for p in vals),
            }
        if adapter_requests or pools:
            adapter_agg["adapter_requests"] = adapter_requests
        return {
            **agg,
            **adapter_agg,
            "refused": refused,
            "router": True,
            # the router's own iteration count doubles as the fleet-level
            # staleness sequence: a poller seeing it unchanged knows
            # NOBODY is driving the fleet (per-replica seqs are itemized
            # under "replicas" for per-engine wedge detection)
            "stats_seq": self.step_count,
            "queue_depth_by_priority": depths,
            "min_priority": self.min_priority,
            "retry_after_floor_s": self.retry_after_floor_s,
            "n_replicas": len(self.replicas),
            "live_replicas": sum(1 for r in self.replicas.values()
                                 if r.state == "live"),
            "n_slots": n_slots,
            "draining": all(r.draining or r.state != "live"
                            for r in self.replicas.values()),
            "in_flight": len(self._records),
            "backlog": len(self._backlog),
            "directory_replicas": len(self._directory),
            "directory_keys": sum(len(keys)
                                  for _, keys in self._directory.values()),
            "pool_occupancy": (
                round(agg["pages_held"] / agg["pages_capacity"], 3)
                if agg["pages_capacity"] else 0.0),
            "decode_occupancy": (
                round(agg["decode_tokens"]
                      / (agg["decode_steps"] * n_slots), 3)
                if agg["decode_steps"] else 0.0),
            "decode_tokens_per_step": (
                round(agg["decode_tokens"] / agg["decode_steps"], 3)
                if agg["decode_steps"] else 0.0),
            "tokens_per_dispatch": (
                round(agg["decode_tokens"] / agg["host_dispatches"], 3)
                if agg["host_dispatches"] else 0.0),
            "horizon_effective": (
                round(agg["horizon_ksum"] / agg["host_dispatches"], 3)
                if agg["host_dispatches"] else 0.0),
            # omitted entirely when nothing was drafted fleet-wide (same
            # contract as engine.spec_metrics: 0.0 would read as "0%
            # acceptance" on a fleet that never speculated)
            **({"spec_acceptance_rate":
                round(agg["spec_tokens_accepted"] / drafted, 3)}
               if drafted else {}),
            **{k: v for k, v in self.counters.items() if k != "refused"},
            "replicas": per,
        }


def local_fleet(bundle, params, n_replicas: int = 2, *,
                share_programs: bool = True, router_kw: Optional[dict] = None,
                heartbeat_dir=None, **engine_kw) -> Router:
    """A single-process fleet of :class:`~.engine.ServeEngine` replicas
    behind a router: N independent schedulers and pools over one set of
    weights on one device (``device=`` in ``engine_kw``, cuda by default).
    ``share_programs`` builds ONE ModelPrograms (one params layout) for
    the whole fleet — replicas of a replicated engine group run identical
    programs by construction, which is also what makes fence-recovery
    replay bitwise. ``heartbeat_dir`` switches the replicas to real
    heartbeat FILES (the cross-process health signal)."""
    from .engine import ModelPrograms, ServeEngine

    programs = engine_kw.pop("programs", None)
    if share_programs and programs is None:
        adapter_kw = {k: engine_kw[k]
                      for k in ("max_adapters", "adapter_rank",
                                "adapter_alpha", "adapter_targets")
                      if k in engine_kw}
        programs = ModelPrograms(
            bundle, params, device=engine_kw.get("device"),
            plan=engine_kw.get("plan"),
            shard_kv=engine_kw.get("shard_kv", False),
            attend_impl=engine_kw.get("attend_impl", "auto"),
            kv_dtype=engine_kw.get("kv_dtype"),
            weight_dtype=engine_kw.get("weight_dtype"), **adapter_kw)
    replicas = []
    for i in range(n_replicas):
        engine = ServeEngine(bundle, params, programs=programs, **engine_kw)
        hb = (str(heartbeat_dir / f"r{i}.heartbeat.json")
              if heartbeat_dir is not None else None)
        replicas.append(Replica(f"r{i}", engine, heartbeat_path=hb))
    return Router(replicas, **(router_kw or {}))
