"""The port's elastic generations (``serve/elastic.py``), SLO controller
(``serve/controller.py``) and load generator (``serve/loadgen.py``)
against the JAX package's on the CPU, llama-debug at 2 layers (fp32
weights carried across by the bridge): a swap that grows or shrinks
``n_slots`` mid-stream keeps every request's tokens and moves what the
JAX swap moves, ``shrink_evicted`` results carry the same request ids and
strict prefixes; a swap with ``params=`` replays under the new weights as
JAX's does; the controller's decisions on a scripted stats trace equal
JAX's; the same seed gives JAX's arrival schedule; an open-loop run that
overloads one replica scales the fleet up once. Tolerance: none, tokens,
schedules and actions are compared exactly."""
import dataclasses
import random

import jax
import numpy as np
import pytest

from distributed_training_guide_tpu.serve import Request as JRequest
from distributed_training_guide_tpu.serve import ServeEngine as JEngine
from distributed_training_guide_tpu.serve import controller as jctl
from distributed_training_guide_tpu.serve import elastic as jelastic
from distributed_training_guide_tpu.serve import loadgen as jload
from distributed_training_guide_tpu.serve import router as jrouter
from distributed_training_guide_tpu.serve.disagg import \
    DisaggEngine as JDisagg
from distributed_training_guide_tpu.serve.scheduler import \
    RequestResult as JResult
from distributed_training_guide_tpu_torch.models import from_jax
from distributed_training_guide_tpu_torch.serve import Request, ServeEngine
from distributed_training_guide_tpu_torch.serve import controller as tctl
from distributed_training_guide_tpu_torch.serve import elastic as telastic
from distributed_training_guide_tpu_torch.serve import loadgen as tload
from distributed_training_guide_tpu_torch.serve import router as trouter
from distributed_training_guide_tpu_torch.serve.disagg import DisaggEngine
from distributed_training_guide_tpu_torch.serve.scheduler import \
    RequestResult
from distributed_training_guide_tpu_torch.utils import faults
import torch_threads  # noqa: F401  (one torch thread a test process)
from torch_fleet import audit, bridged, reference

ENG = dict(n_slots=4, page_size=4, max_len=32)


def _reqs(n=6, new=10):
    return [dict(prompt_ids=[3 + i, 17, 42, 9, 5, 8][:2 + i % 5],
                 max_new_tokens=new + i % 3, seed=i) for i in range(n)]


def _swap_both(overrides, *, steps=4, specs=None, eng=ENG, params=None):
    """The same trace through the JAX and the port engines: ``steps``
    iterations, then ``swap_engine(**overrides)``, then to the end.
    Returns per side (ids, results by id, evicted, swap stats, engine)."""
    jb, jparams, tb, tparams = bridged()
    specs = specs or _reqs()
    out = []
    for side in ("jax", "port"):
        if side == "jax":
            old = JEngine(jb, jparams, **eng)
            reqs, swap = [JRequest(**s) for s in specs], jelastic.swap_engine
            new_params = (None if params is None else
                          jb.init(jb.config, jax.random.key(params)))
        else:
            old = ServeEngine(tb, tparams, device="cpu", **eng)
            reqs, swap = [Request(**s) for s in specs], telastic.swap_engine
            new_params = (None if params is None else
                          from_jax.params_from_numpy(jax.tree.map(
                              np.asarray, jb.init(jb.config,
                                                  jax.random.key(params))),
                              device="cpu"))
        ids = [old.submit(r) for r in reqs]
        done = {}
        for _ in range(steps):
            done.update({r.request_id: r for r in old.step()})
        new, evicted, stats = swap(old, params=new_params, **overrides)
        if side == "port":
            audit(new)
            assert old.scheduler.pool.n_free == old.scheduler.pool.capacity
        done.update({r.request_id: r for r in evicted})
        while new.has_work:
            done.update({r.request_id: r for r in new.step()})
            if side == "port":
                audit(new)
        out.append((ids, done, evicted, stats, new))
    return out


@pytest.mark.parametrize("overrides", [
    dict(n_slots=8), dict(n_slots=2, n_pages=1 + 2 * 8), dict(n_pages=12)],
    ids=["grow", "shrink", "pool"])
def test_swap_keeps_tokens_and_moves_what_jax_moves(overrides):
    (jids, jdone, _, jstats, _), (ids, done, ev, stats, new) = \
        _swap_both(overrides)
    _, _, tb, tparams = bridged()
    assert ids == jids and not ev
    for rid, s in zip(ids, _reqs()):
        want = reference(tb, tparams, Request(**s), page_size=4, max_len=32)
        assert done[rid].token_ids == want.token_ids == jdone[rid].token_ids
    assert {k: v for k, v in stats.items() if k != "swap_s"} == \
        {k: v for k, v in jstats.items() if k != "swap_s"}
    assert new.n_slots == overrides.get("n_slots", 4)


def test_shrink_evicted_results_follow_jax():
    """``max_len`` cut below a resident's worst case: it finishes at the
    swap ``shrink_evicted`` with a strict prefix of its tokens, under the
    same request id as in the JAX swap; the rest finish normally."""
    specs = [dict(prompt_ids=[3, 17, 42], max_new_tokens=26, seed=0),
             dict(prompt_ids=[5, 19, 44], max_new_tokens=8, seed=1)]
    (jids, jdone, jev, jstats, _), (ids, done, ev, stats, _) = _swap_both(
        dict(max_len=16), steps=6, specs=specs)
    assert [r.request_id for r in ev] == [r.request_id for r in jev] == \
        [ids[0]]
    assert ev[0].finish_reason == "shrink_evicted"
    assert ev[0].generated_ids == jev[0].generated_ids
    _, _, tb, tparams = bridged()
    full = reference(tb, tparams, Request(**specs[0]), page_size=4,
                     max_len=32)
    assert 0 < len(ev[0].generated_ids) < len(full.generated_ids)
    assert full.generated_ids[:len(ev[0].generated_ids)] == \
        ev[0].generated_ids
    assert done[ids[1]].token_ids == jdone[jids[1]].token_ids
    assert stats["evicted"] == jstats["evicted"] == 1


def test_swap_with_params_replays_under_the_new_weights_as_jax():
    """``swap_engine(params=)``: every carried sequence replays (no
    payload seat), its emitted tokens kept and its continuation under the
    new weights, greedy-equal to the JAX swap's."""
    (jids, jdone, _, jstats, _), (ids, done, _, stats, _) = _swap_both(
        {}, params=1)
    assert stats["seated"] == jstats["seated"] == 0
    assert stats["requeued"] == jstats["requeued"] > 0
    for rid in ids:
        assert done[rid].token_ids == jdone[rid].token_ids


def test_payload_drop_fault_and_guards(monkeypatch):
    """``DTG_FAULT_SWAP_DROP_SEQ=0`` drops the first resident's payload:
    it replays instead, to the same tokens. A publish inside the swap's
    guard and a baked knob are refused; stepping an engine whose params
    a ``new_generation(params=)`` already published is refused."""
    monkeypatch.setenv(faults.ENV_SWAP_DROP_SEQ, "0")
    (jids, jdone, _, jstats, _), (ids, done, _, stats, _) = _swap_both(
        dict(n_slots=6))
    assert stats["payload_dropped"] == jstats["payload_dropped"] == 1
    assert [done[i].token_ids for i in ids] == \
        [jdone[i].token_ids for i in jids]
    _, _, tb, tparams = bridged()
    eng = ServeEngine(tb, tparams, device="cpu", **ENG)
    with eng.programs.swap_guard():
        with pytest.raises(RuntimeError, match="swap"):
            eng.publish_params(tparams)
    with pytest.raises(ValueError, match="baked"):
        telastic.new_generation(eng, kv_dtype="int8")
    eng.submit(Request(prompt_ids=[1, 2, 3], max_new_tokens=4))
    eng.step()
    new = telastic.new_generation(eng, params=tparams)
    with pytest.raises(RuntimeError, match="swap_generation"):
        eng.step()
    results, st = telastic.swap_generation(eng, new)
    assert st["requeued"] == 1 and not results


def test_tier_carry_and_disagg_swap_with_handoffs_in_transit():
    """A payload-compatible swap carries the host tier's records, a
    forced replay drops them; a disaggregated pair swaps with sequences
    in the handoff queue, to the batch-1 tokens."""
    _, _, tb, tparams = bridged()
    old = ServeEngine(tb, tparams, device="cpu", host_tier_bytes=1 << 20,
                      **ENG)
    old.host_tier.put(("prefix", 0, (3, 17, 42, 7)), old.gather_pages([1]),
                      pages=1)
    new = telastic.new_generation(old, n_slots=6)
    _, st = telastic.swap_generation(old, new)
    assert st["tier_records_carried"] == 1 and len(old.host_tier) == 0
    new.host_tier.audit()
    new2 = telastic.new_generation(new)
    _, st2 = telastic.swap_generation(new, new2, force_replay=True)
    assert st2["tier_records_dropped"] == 1 and len(new2.host_tier) == 0
    specs = _reqs(5, new=6)
    pair = DisaggEngine(tb, tparams, device="cpu", n_slots=1,
                        n_prefill_slots=2, page_size=4, max_len=32)
    ids = [pair.submit(Request(**s)) for s in specs]
    done = {}
    while not pair.handoff.pending:
        done.update({r.request_id: r for r in pair.step()})
    new_pair, evicted, _ = telastic.swap_engine(pair, n_slots=3)
    assert not evicted and isinstance(new_pair, DisaggEngine)
    while new_pair.has_work:
        done.update({r.request_id: r for r in new_pair.step()})
        audit(new_pair)
    for rid, s in zip(ids, specs):
        want = reference(tb, tparams, Request(**s), page_size=4, max_len=32)
        assert done[rid].token_ids == want.token_ids
    # the JAX pair takes the same trace to the same tokens
    jb, jparams, _, _ = bridged()
    jpair = JDisagg(jb, jparams, n_slots=1, n_prefill_slots=2, page_size=4,
                    max_len=32)
    jids = [jpair.submit(JRequest(**s)) for s in specs]
    jdone = {}
    while not jpair.handoff.pending:
        jdone.update({r.request_id: r for r in jpair.step()})
    jnew, _, _ = jelastic.swap_engine(jpair, n_slots=3)
    while jnew.has_work:
        jdone.update({r.request_id: r for r in jnew.step()})
    assert [done[i].token_ids for i in ids] == \
        [jdone[i].token_ids for i in jids]


# ---- the controller on a scripted trace -------------------------------------

class _CtlEngine:
    """Engine-shaped stats source with writable load knobs."""

    def __init__(self, n_slots=4):
        self.page_size, self.n_slots = 4, n_slots
        self.queued = self.active = self.finished = self.missed = 0
        self.working = False
        self.decode_steps = self.decode_tokens = 0
        self.draining = False
        self._ids = iter(range(10 ** 6))

    def stats(self):
        return {"n_slots": self.n_slots, "queued": self.queued,
                "active_slots": self.active, "pool_occupancy": 0.0,
                "pages_capacity": 10, "pages_free": 10, "pages_held": 0,
                "finished": self.finished,
                "deadline_missed_queued": self.missed,
                "draining": self.draining, "max_queue": 64}

    def submit(self, request):
        return next(self._ids)

    def resubmit(self, request, generated=(), first_token_at=0.0,
                 submitted_at=None):
        return next(self._ids)

    def partial_tokens(self):
        return {}

    def step(self):
        return []

    @property
    def has_work(self):
        return self.working

    def drain(self):
        self.draining = True


def _controller_run(router_mod, ctl_mod, seed):
    """A random trace of load levels, finishes, misses and one kill
    through a fake fleet under ``ctl_mod.Controller``: the actions and
    the counters."""
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    router = router_mod.Router(
        [router_mod.Replica(f"r{i}", _CtlEngine(), clock=clock)
         for i in range(2)], clock=clock, heartbeat_timeout_s=10 ** 9)
    spawned = iter(range(100))
    ctl = ctl_mod.Controller(
        router, hold_up=2, hold_down=3, cooldown_s=0.3, max_replicas=4,
        spawn=lambda: router_mod.Replica(f"n{next(spawned)}", _CtlEngine(),
                                         clock=clock),
        slo=ctl_mod.SLO(horizon_max=4))
    rng = random.Random(seed)
    for i in range(120):
        level = rng.choice(["over", "over", "under", "band", "miss"])
        for name, rep in router.replicas.items():
            eng = rep.engine
            eng.queued = {"over": 30, "under": 0, "band": 1,
                          "miss": 2}[level]
            eng.active = {"over": 4, "under": 0, "band": 3, "miss": 2}[level]
            eng.working = level != "under" and rng.random() < 0.5
            eng.finished += rng.randrange(3)
            eng.missed += level == "miss"
        if i == 60:
            live = [n for n, r in router.replicas.items()
                    if r.state == "live"]
            router.replicas[live[-1]].kill()
        t[0] += 0.1
        router.step()
        ctl.step()
    actions = [(a["kind"], a["target"]) for a in ctl.actions]
    return actions, ctl.counters, ctl.state, sorted(router.replicas)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_decisions_equal_jax(seed):
    got = _controller_run(trouter, tctl, seed)
    want = _controller_run(jrouter, jctl, seed)
    assert got == want
    assert got[1]["scale_up"] + got[1]["shed_on"] > 0


# ---- the load generator ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_schedule_from_one_seed_equals_jax(seed):
    arr = tload.poisson_arrivals(40.0, 2.0, seed=seed)
    assert arr == jload.poisson_arrivals(40.0, 2.0, seed=seed)
    kw = dict(max_len=64, page_size=4, vocab=512, deadline_s=2.0, seed=seed)
    scen = tload.default_scenarios(**kw)
    jscen = jload.default_scenarios(**kw)
    scen.append(tload.adapter_mix_scenario(max_len=64, n_adapters=3))
    jscen.append(jload.adapter_mix_scenario(max_len=64, n_adapters=3))
    assert [dataclasses.asdict(s) for s in scen] == \
        [dataclasses.asdict(s) for s in jscen]
    got = tload.build_schedule(arr, scen, vocab=512, seed=seed)
    want = jload.build_schedule(arr, jscen, vocab=512, seed=seed)
    assert len(got) == len(want) > 20
    for (t, r), (jt, jr) in zip(got, want):
        assert t == jt
        assert dataclasses.asdict(r) == dataclasses.asdict(jr)


def test_summarize_equals_jax():
    rng = random.Random(3)
    res, jres = {}, {}
    for i in range(30):
        kw = dict(request_id=i, prompt_ids=[1, 2],
                  generated_ids=list(range(rng.randrange(1, 6))),
                  finish_reason=rng.choice(["eos", "length", "deadline",
                                            "resubmit_exhausted", "x"]),
                  submitted_at=0.0, admitted_at=0.1,
                  finished_at=1.0 + rng.random(),
                  first_token_at=0.2 + rng.random() / 10)
        res[i], jres[i] = RequestResult(**kw), JResult(**kw)
    gaps = [rng.random() / 50 for _ in range(40)]
    args = ([None] * 35, )
    got = tload.summarize(*args, res, [(0.1, "queue_full")] * 5, 2.5,
                          itl_gaps=gaps, token_burst_max=3)
    want = jload.summarize(*args, jres, [(0.1, "queue_full")] * 5, 2.5,
                           itl_gaps=gaps, token_burst_max=3)
    assert got.as_dict() == want.as_dict()


def test_open_loop_overload_scales_up_once():
    """A Poisson rate past one replica's service, through the router with
    the controller: exactly one scale-up (max 2 replicas), its cold start
    timed, and every request accounted for. ``hold_down`` is out of reach
    so that the drained tail of a slow run cannot scale the fleet back
    down before it is counted."""
    _, _, tb, tparams = bridged()
    fleet = trouter.local_fleet(tb, tparams, 1, device="cpu", n_slots=2,
                                page_size=4, max_len=32)
    ctl = tctl.Controller(fleet, hold_up=2, hold_down=10**9, cooldown_s=0.0,
                          max_replicas=2, slo=tctl.SLO(queue_high=2.0))
    scen = [tload.Scenario("gen", prompt_len=(2, 6),
                           max_new_tokens=(6, 10))]
    sched = tload.build_schedule(tload.poisson_arrivals(200.0, 0.1, seed=1),
                                 scen, vocab=tb.config.vocab_size, seed=1)
    rep = tload.run_open_loop(fleet, sched, controller=ctl, max_wall_s=120)
    assert not rep.timed_out
    assert rep.completed + rep.refused == rep.offered == len(sched) > 4
    assert ctl.counters["scale_up"] == 1 and len(ctl.cold_starts) == 1
    assert len(fleet.replicas) == 2
    assert rep.ttft_p50_s > 0 and rep.itl_samples > 0
