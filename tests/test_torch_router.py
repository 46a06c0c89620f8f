"""The port's fleet router (``serve/router.py``) against the JAX
package's on the CPU, llama-debug at 2 layers (fp32 weights carried
across by the bridge): the affinity key and the rendezvous order equal
JAX's on the same prompts; a ``local_fleet`` of 2 gives JAX's fleet's
tokens and routing counters, spilling over on a 429; a replica killed by
``DTG_FAULT_REPLICA_KILL`` or wedged is fenced and its in-flight requests
replay token-identical to an uninterrupted run, or finish
``resubmit_exhausted`` with a strict prefix; a prefix pulled between
replicas seats with no prefill; fleet publishes reach every replica, and
a params publish leaves no replica's cache holding old-weight k/v.
Tolerance: none, tokens and keys are compared exactly."""
import random
import time

import numpy as np
import pytest

from distributed_training_guide_tpu.serve import Request as JRequest
from distributed_training_guide_tpu.serve import router as jrouter
from distributed_training_guide_tpu.serve.api import \
    generate_many as jgenerate
from distributed_training_guide_tpu_torch.models import from_jax
from distributed_training_guide_tpu_torch.serve import (Request, ServeEngine,
                                                        generate_many)
from distributed_training_guide_tpu_torch.serve import router as trouter
from distributed_training_guide_tpu_torch.serve.api import \
    readiness as api_readiness
from distributed_training_guide_tpu_torch.serve.scheduler import \
    RefusalError
from distributed_training_guide_tpu_torch.serve.tiering import pull_prefix
from distributed_training_guide_tpu_torch.utils import faults
import torch_threads  # noqa: F401  (one torch thread a test process)
from torch_fleet import audit, bridged, drive, fresh, reference

FLEET = dict(n_slots=2, page_size=4, max_len=32)


def _prompts(seed: int, n: int = 40):
    rng = random.Random(seed)
    return [[rng.randrange(1, 500) for _ in range(rng.randrange(1, 30))]
            for _ in range(n)]


@pytest.mark.parametrize("page_size,adapter", [(4, 0), (16, 0), (4, 3)])
def test_affinity_key_and_rendezvous_equal_jax(page_size, adapter):
    names = [f"r{i}" for i in range(5)]
    for prompt in _prompts(page_size + adapter):
        key = trouter.prefix_affinity_key(prompt, page_size, adapter)
        assert key == jrouter.prefix_affinity_key(prompt, page_size,
                                                  adapter)
        if key is not None:
            assert trouter.rendezvous_order(key, names) == \
                jrouter.rendezvous_order(key, names)


def test_load_and_readiness_equal_jax():
    rng = random.Random(0)
    for _ in range(50):
        s = {"n_slots": rng.randrange(1, 9), "queued": rng.randrange(0, 40),
             "active_slots": rng.randrange(0, 8),
             "pool_occupancy": rng.random(), "pages_free": rng.randrange(12),
             "draining": rng.random() < 0.2, "ok": rng.random() < 0.9,
             "max_queue": rng.choice([None, 4, 16])}
        age = rng.choice([None, 0.5, 9.0])
        assert trouter.replica_load(s) == jrouter.replica_load(s)
        assert trouter.readiness(s, loop_age_s=age) == \
            jrouter.readiness(s, loop_age_s=age)
    assert api_readiness is trouter.readiness


def _specs(n: int = 6):
    return [dict(prompt_ids=[3 + i, 17, 42, 9, 5, 8, 1, 2][:2 + i % 7],
                 max_new_tokens=6 + i % 3, seed=i) for i in range(n)]


def test_local_fleet_gives_jax_fleet_tokens_and_spills_over():
    """``max_queue=1``: the affinity target refuses (429) and the request
    spills to the other replica, as in the JAX fleet, with the same
    routing counters."""
    jb, jparams, tb, tparams = bridged()
    # two prompts of one affinity key (their first page is shared): the
    # second finds its target's queue full and spills to the sibling
    specs = [dict(prompt_ids=[7, 8, 9, 10, 11 + i, 12], max_new_tokens=6,
                  seed=i) for i in range(2)]
    jfleet = jrouter.local_fleet(jb, jparams, 2, max_queue=1, **FLEET)
    tfleet = trouter.local_fleet(tb, tparams, 2, device="cpu", max_queue=1,
                                 **FLEET)
    jres = jgenerate(jfleet, [JRequest(**s) for s in specs])
    ids, done = drive(tfleet, [Request(**s) for s in specs])
    assert [done[i].token_ids for i in ids] == [r.token_ids for r in jres]
    ts, js = tfleet.stats(), jfleet.stats()
    for key in ("routed", "affinity_routed", "spillovers", "refused"):
        assert ts[key] == js[key], key
    assert ts["spillovers"] > 0
    assert set(ts) == set(js)
    assert tfleet.replicas["r0"].engine.programs is \
        tfleet.replicas["r1"].engine.programs


@pytest.mark.parametrize("how", ["kill_fault", "wedge"])
def test_failed_replica_is_fenced_and_requests_replay(monkeypatch, how):
    """``DTG_FAULT_REPLICA_KILL=r0@4`` (instant death) or a wedge caught
    by heartbeat age: the replica is fenced, its in-flight requests are
    resubmitted, and every request finishes with its uninterrupted
    tokens (sampled ones included); the survivor audits clean every
    iteration."""
    _, _, tb, tparams = bridged()
    if how == "kill_fault":
        monkeypatch.setenv(faults.ENV_REPLICA_KILL, "r0@4")
        kw = dict(heartbeat_timeout_s=60.0)
    else:
        monkeypatch.setenv(faults.ENV_REPLICA_WEDGE, "r1@3")
        kw = dict(heartbeat_timeout_s=0.15)
    fleet = trouter.local_fleet(tb, tparams, 2, device="cpu",
                                router_kw=kw, **FLEET)
    reqs = [Request(prompt_ids=[3 + i, 17, 42], max_new_tokens=10,
                    temperature=0.6 if i % 2 else 0.0, seed=i)
            for i in range(6)]
    ids = [fleet.submit(fresh(r)) for r in reqs]
    done, it = {}, 0
    while fleet.has_work:
        for res in fleet.step():
            done[res.request_id] = res
        for rep in fleet.replicas.values():
            if rep.state == "live" and not rep.wedged:
                audit(rep.engine)
        if how == "wedge":
            time.sleep(0.002)       # heartbeat age needs wall time
        it += 1
        assert it < 3000
    for rid, req in zip(ids, reqs):
        want = reference(tb, tparams, req, page_size=4, max_len=32)
        assert done[rid].token_ids == want.token_ids, f"seed={req.seed}"
    s = fleet.stats()
    victim = "r0" if how == "kill_fault" else "r1"
    assert fleet.replicas[victim].state == "fenced"
    assert s["fenced"] == 1 and s["resubmitted"] >= 1


def test_resubmit_exhausted_carries_the_strict_prefix():
    """A one-replica fleet killed mid-decode: with no live replica left
    every in-flight request finishes ``resubmit_exhausted`` with the
    tokens the router saw, a strict prefix of the uninterrupted run."""
    _, _, tb, tparams = bridged()
    fleet = trouter.local_fleet(tb, tparams, 1, device="cpu", **FLEET)
    reqs = [Request(prompt_ids=[5 + i, 6, 7], max_new_tokens=12, seed=i)
            for i in range(2)]
    ids = [fleet.submit(fresh(r)) for r in reqs]
    for _ in range(5):
        fleet.step()
    fleet.replicas["r0"].kill()
    out = {r.request_id: r for r in fleet.step()}
    assert not fleet.has_work
    for rid, req in zip(ids, reqs):
        res = out[rid]
        want = reference(tb, tparams, req, page_size=4, max_len=32)
        assert res.finish_reason == "resubmit_exhausted"
        assert 0 < len(res.generated_ids) < len(want.generated_ids)
        assert want.generated_ids[:len(res.generated_ids)] == \
            res.generated_ids
    assert fleet.stats()["resubmit_exhausted"] == 2
    with pytest.raises(RefusalError) as err:
        fleet.submit(Request(prompt_ids=[1, 2]))
    assert err.value.http_status == 503


def test_prefix_pull_between_replicas_seats_with_no_prefill():
    """The fleet directory's data path: r0 holds a 3-page prefix chain;
    ``pull_prefix`` moves it into r1's cache over the wire, and r1 then
    serves the prompt sharing those pages, with r0's tokens. Through the
    router the same pull happens on the directory's own."""
    _, _, tb, tparams = bridged()
    fleet = trouter.local_fleet(tb, tparams, 2, device="cpu", **FLEET)
    r0, r1 = (fleet.replicas[n].engine for n in ("r0", "r1"))
    prompt = list(range(20, 33))                      # 3 full pages + 1
    want = generate_many(r0, [Request(prompt_ids=prompt, max_new_tokens=5)])
    out = pull_prefix(r0, r1, prompt, xfer_id=1)
    assert out["ok"] and out["pages"] == 3 and out["bytes"] > 0
    assert r1.scheduler.cache.chain_depth(prompt) == 3
    before = r1.programs.prefill_calls
    got = generate_many(r1, [Request(prompt_ids=prompt, max_new_tokens=5)])
    assert got[0].token_ids == want[0].token_ids
    assert r1.stats()["prefix_hits"] == 1
    assert r1.programs.prefill_calls == before + 1     # the tail only
    audit(r0)
    audit(r1)
    assert pull_prefix(r0, r1, prompt)["reason"] == "already_resident"
    # the directory: a prompt whose affinity target is cold pulls from
    # the sibling that advertised its chain
    fleet.step()                                       # fold directories
    assert fleet.stats()["directory_keys"] > 0


def test_fleet_publishes_reach_every_replica_and_drop_stale_kv():
    """``Router.publish_params`` updates the shared programs once and
    empties every replica's prefix cache: a prompt cached on both
    replicas before the publish decodes, after it, bitwise what a fresh
    engine built on the new weights decodes. ``publish_adapter`` lands
    one slot id fleet-wide."""
    jb, jparams, tb, tparams = bridged()
    fleet = trouter.local_fleet(tb, tparams, 2, device="cpu",
                                max_adapters=3, adapter_rank=2, **FLEET)
    prompt = list(range(40, 53))
    for name in ("r0", "r1"):
        generate_many(fleet.replicas[name].engine,
                      [Request(prompt_ids=prompt, max_new_tokens=4)])
        assert fleet.replicas[name].engine.scheduler.cache_pages_held() > 0
    rng = np.random.default_rng(3)
    new = from_jax.params_from_numpy(
        {k: v for k, v in _scaled(jparams, rng).items()}, device="cpu")
    assert fleet.publish_params(new) == 1            # one shared programs
    fresh_eng = ServeEngine(tb, new, device="cpu", **FLEET)
    want = generate_many(fresh_eng, [Request(prompt_ids=prompt,
                                             max_new_tokens=6)])
    for name in ("r0", "r1"):
        eng = fleet.replicas[name].engine
        assert eng.scheduler.cache_pages_held() == 0
        got = generate_many(eng, [Request(prompt_ids=prompt,
                                          max_new_tokens=6)])
        assert got[0].token_ids == want[0].token_ids
    from distributed_training_guide_tpu_torch.serve import adapters as tad
    shapes = tad.adapter_shapes(tb.config, rank=2)
    adapter = {t: {leaf: from_jax._to_torch(
        rng.normal(0, 0.3, shp).astype(np.float32), "cpu", None)
        for leaf, shp in pair.items()} for t, pair in shapes.items()}
    slot = fleet.publish_adapter(adapter, name="tenant")
    assert slot == 1 and fleet.stats()["adapter_publish_calls"] == 1
    for name in ("r0", "r1"):
        assert fleet.replicas[name].engine.adapter_pool.is_live(slot)
    fleet.replicas["r0"].engine.submit(Request(prompt_ids=[1, 2, 3],
                                               max_new_tokens=4))
    with pytest.raises(RuntimeError, match="in-flight"):
        fleet.publish_params(new)


def _scaled(jparams, rng):
    """The bridged params, every leaf scaled by a random factor (a
    publish of different same-layout weights)."""
    import jax

    return jax.tree.map(
        lambda a: np.asarray(a) * np.float32(rng.uniform(0.5, 1.5)),
        jparams)


def test_membership_add_remove_and_mixed_fleets_refused():
    """``remove_replica`` drains and resubmits what the replica held (no
    token lost); ``add_replica`` makes a replica routable at once; a
    replica at another page size or kv dtype is refused."""
    _, _, tb, tparams = bridged()
    fleet = trouter.local_fleet(tb, tparams, 2, device="cpu", **FLEET)
    reqs = [Request(prompt_ids=[3 + i, 17, 42, 9], max_new_tokens=8, seed=i)
            for i in range(4)]
    ids = [fleet.submit(fresh(r)) for r in reqs]
    for _ in range(3):
        fleet.step()
    fleet.remove_replica("r0")
    extra = ServeEngine(tb, None, programs=fleet.replicas["r1"].engine
                        .programs, device="cpu", **FLEET)
    fleet.add_replica(trouter.Replica("r2", extra, clock=fleet.clock))
    done = {}
    while fleet.has_work:
        for res in fleet.step():
            done[res.request_id] = res
    for rid, req in zip(ids, reqs):
        want = reference(tb, tparams, req, page_size=4, max_len=32)
        assert done[rid].token_ids == want.token_ids
    s = fleet.stats()
    assert s["replicas_removed"] == 1 and s["replicas_added"] == 1
    with pytest.raises(ValueError, match="page_size"):
        fleet.add_replica(trouter.Replica("r3", ServeEngine(
            tb, tparams, device="cpu", n_slots=2, page_size=8, max_len=32)))
    with pytest.raises(ValueError, match="kv_dtype"):
        fleet.add_replica(trouter.Replica("r4", ServeEngine(
            tb, tparams, device="cpu", kv_dtype="int8", **FLEET)))
    with pytest.raises(ValueError, match="last live"):
        fleet.remove_replica("r1") or fleet.remove_replica("r2")


def test_restore_into_a_shared_pool_drops_every_replicas_stale_prefixes():
    """Two replicas share one ``ModelPrograms`` and so one adapter pool.
    Tenant A's prompt is cached on r1 under slot 1; r0 then restores
    tenant B from the host tier, and the LRU recycles A's slot for it.
    B's request on r1 must not reuse the prefix pages A computed there:
    its tokens are bitwise those of a fresh engine serving B alone."""
    _, _, tb, tparams = bridged()
    kw = dict(max_adapters=2, adapter_rank=2, host_tier_bytes=1 << 24,
              **FLEET)
    fleet = trouter.local_fleet(tb, tparams, 2, device="cpu", **kw)
    from distributed_training_guide_tpu_torch.serve import adapters as tad
    rng = np.random.default_rng(5)
    shapes = tad.adapter_shapes(tb.config, rank=2)

    def adapter():
        return {t: {leaf: from_jax._to_torch(
            rng.normal(0, 0.5, shp).astype(np.float32), "cpu", None)
            for leaf, shp in pair.items()} for t, pair in shapes.items()}

    a, b = adapter(), adapter()
    prompt = list(range(40, 53))
    r0, r1 = (fleet.replicas[n].engine for n in ("r0", "r1"))
    assert fleet.publish_adapter(b, name="B") == 1
    assert fleet.publish_adapter(a, name="A") == 1     # spills B
    generate_many(r1, [Request(prompt_ids=prompt, max_new_tokens=4,
                               adapter_id=1)])
    assert r1.scheduler.cache_pages_held() > 0
    assert r0.restore_adapter("B") == 1                 # spills A
    assert r1.scheduler.cache_pages_held() == 0
    got = generate_many(r1, [Request(prompt_ids=prompt, max_new_tokens=6,
                                     adapter_id=1)])
    solo = ServeEngine(tb, tparams, device="cpu", max_adapters=2,
                       adapter_rank=2, **FLEET)
    assert solo.publish_adapter(b, name="B") == 1
    want = generate_many(solo, [Request(prompt_ids=prompt, max_new_tokens=6,
                                        adapter_id=1)])
    assert got[0].token_ids == want[0].token_ids
