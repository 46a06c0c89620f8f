"""The port's host KV tier (``serve/tiering.py`` and the engine's tier
seams) against the JAX package's on the CPU, llama-debug at 2 layers
(fp32 weights carried across by the bridge): ``HostTier``'s budget, LRU
order, counters and gauges on a scripted sequence of puts equal JAX's; a
preempted sequence spilled and restored, and a prefix evicted to the tier
and restored, decode the tokens of a tier-free run, with the JAX engine's
spill / restore counts; an LRU-evicted adapter comes back bitwise its
pre-spill rows; and a params publish drops the tier's prefix records with
the cache (a port-only rule), so decoding after a publish is bitwise a
fresh engine's. Tolerance: none, tokens and bytes are compared exactly."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.serve import Request as JRequest
from distributed_training_guide_tpu.serve import ServeEngine as JEngine
from distributed_training_guide_tpu.serve.api import \
    generate_many as jgenerate
from distributed_training_guide_tpu.serve.disagg import \
    DisaggEngine as JDisagg
from distributed_training_guide_tpu.serve.tiering import HostTier as JTier
from distributed_training_guide_tpu_torch.models import from_jax
from distributed_training_guide_tpu_torch.serve import (Request, ServeEngine,
                                                        generate_many)
from distributed_training_guide_tpu_torch.serve import adapters as tad
from distributed_training_guide_tpu_torch.serve.disagg import DisaggEngine
from distributed_training_guide_tpu_torch.serve.tiering import HostTier
import torch_threads  # noqa: F401  (one torch thread a test process)
from torch_fleet import audit, bridged, drive, reference

SPILL = dict(n_slots=4, page_size=4, max_len=16, n_pages=7,
             host_tier_bytes=1 << 20)
TIER_KEYS = ("spilled_pages", "restore_hits", "restore_misses",
             "tier_spills", "tier_evictions", "tier_dropped",
             "host_tier_records", "preempted", "prefill_calls")


def test_host_tier_script_equals_jax():
    """The same scripted puts / gets / takes / drops through both tiers,
    numpy payloads of 40 to 256 bytes under a 200-byte budget: the keys
    in LRU order, the bytes, the counters and the gauges agree after
    every operation, and a carry into a smaller tier sheds the same
    records."""
    rng = np.random.default_rng(0)
    tiers = (JTier(200), HostTier(200))
    ops = []
    for i in range(60):
        kind = rng.choice(["put", "put", "get", "take", "drop"])
        key = ("prefix", 0, (int(rng.integers(6)),))
        n = int(rng.choice([10, 16, 24, 64]))
        ops.append((kind, key, {"k": np.full(n, i, np.float32)},
                    int(rng.integers(1, 3))))
    for kind, key, payload, pages in ops:
        outs = []
        for tier in tiers:
            if kind == "put":
                outs.append(tier.put(key, payload, pages=pages))
            elif kind == "get":
                rec = tier.get(key)
                outs.append(None if rec is None else rec.nbytes)
            elif kind == "take":
                rec = tier.take(key)
                outs.append(None if rec is None else rec.nbytes)
            else:
                outs.append(tier.drop(key))
            tier.audit()
        assert outs[0] == outs[1], kind
        assert tiers[0].keys() == tiers[1].keys()
        assert tiers[0].gauges() == tiers[1].gauges()
        assert tiers[0].counters == tiers[1].counters
    small = (JTier(90), HostTier(90))
    assert small[0].carry_from(tiers[0]) == small[1].carry_from(tiers[1])
    assert small[0].keys() == small[1].keys()
    assert len(tiers[1]) == 0 and tiers[1].bytes_used == 0


def _spill_specs():
    return [dict(prompt_ids=[3 + i, 17, 42][:1 + i % 3],
                 max_new_tokens=6 + (i % 5),
                 temperature=0.8 if i % 2 else 0.0, seed=i)
            for i in range(8)]


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_preempt_spill_restore_matches_tier_free_and_jax(kv_dtype):
    """A pool far below worst case: preempted sequences spill their live
    pages and resume by scatter-and-seat. Every request decodes its
    tier-free batch-1 tokens (sampled ones included), the greedy ones
    JAX's; the preemption, spill and restore counts are JAX's; a restore
    hit runs no prefill; the pools and the tier audit every iteration."""
    jb, jparams, tb, tparams = bridged()
    specs = _spill_specs()
    eng = ServeEngine(tb, tparams, device="cpu", kv_dtype=kv_dtype, **SPILL)
    ids, done = drive(eng, [Request(**s) for s in specs])
    jeng = JEngine(jb, jparams, kv_dtype=kv_dtype, **SPILL)
    jres = jgenerate(jeng, [JRequest(**s) for s in specs])
    ts, js = eng.stats(), jeng.stats()
    assert ts["preempted"] > 0 and ts["restore_hits"] > 0
    for key in TIER_KEYS:
        assert ts[key] == js[key], key
    assert ts["prefill_calls"] == len(specs) + ts["restore_misses"]
    for rid, s, j in zip(ids, specs, jres):
        want = reference(tb, tparams, Request(**s), page_size=4, max_len=16,
                         kv_dtype=kv_dtype)
        assert done[rid].token_ids == want.token_ids, s["seed"]
        if s["temperature"] == 0.0:
            assert done[rid].token_ids == j.token_ids


PREFIX = dict(n_slots=1, page_size=4, max_len=32, n_pages=9)
A = list(range(50, 63))                 # 13 tokens: 3 cacheable pages
B = list(range(70, 83))


def _prefix_trace(eng, run):
    """A, then B (which needs every page, so A's cached chain is evicted
    whole), then A again."""
    out = []
    for prompt, new in ((A, 4), (B, 19), (A, 6)):
        out.append(run(eng, prompt, new))
    return out


def _run_t(eng, prompt, new):
    res = generate_many(eng, [Request(prompt_ids=prompt,
                                      max_new_tokens=new)])[0].token_ids
    audit(eng)
    return res


def _run_j(eng, prompt, new):
    return jgenerate(eng, [JRequest(prompt_ids=prompt,
                                    max_new_tokens=new)])[0].token_ids


def test_spilled_prefix_restores_and_decodes_as_never_evicted():
    """B's growth evicts A's cached prefix pages into the tier; A's
    return re-seats them ahead of admission and shares them: the tokens
    equal a tier-free engine's and the JAX engine's, with JAX's spill,
    restore and prefix-hit counts."""
    jb, jparams, tb, tparams = bridged()
    eng = ServeEngine(tb, tparams, device="cpu", host_tier_bytes=1 << 20,
                      **PREFIX)
    got = _prefix_trace(eng, _run_t)
    free = _prefix_trace(ServeEngine(tb, tparams, device="cpu", **PREFIX),
                         _run_t)
    jeng = JEngine(jb, jparams, host_tier_bytes=1 << 20, **PREFIX)
    jgot = _prefix_trace(jeng, _run_j)
    assert got == free == jgot
    ts, js = eng.stats(), jeng.stats()
    assert ts["tier_spills"] == 3 and ts["restore_hits"] == 3
    for key in TIER_KEYS + ("prefix_hits", "cache_evicted_pages"):
        assert ts[key] == js[key], key
    assert ts["prefix_hits"] == 1


def _new_params(jb, seed=1):
    """Same-layout weights of another seed (a publish)."""
    return from_jax.params_from_numpy(jax.tree.map(
        np.asarray, jb.init(jb.config, jax.random.key(seed))), device="cpu")


def test_publish_drops_spilled_prefixes_and_decodes_as_fresh():
    """The port-only rule: after A's prefix was spilled to the tier, a
    params publish drops the tier's prefix records with the cache, so
    A's return recomputes under the new weights: its tokens are bitwise
    a fresh engine's on the new weights, and nothing is restored."""
    jb, _, tb, tparams = bridged()
    eng = ServeEngine(tb, tparams, device="cpu", host_tier_bytes=1 << 20,
                      **PREFIX)
    _run_t(eng, A, 4)
    _run_t(eng, B, 19)
    assert sum(k[0] == "prefix" for k in eng.host_tier.keys()) == 3
    new = _new_params(jb)
    eng.publish_params(new)
    assert not any(k[0] == "prefix" for k in eng.host_tier.keys())
    assert eng.scheduler.cache_pages_held() == 0
    hits = eng.stats()["restore_hits"]
    got = _run_t(eng, A, 6)
    fresh = _run_t(ServeEngine(tb, new, device="cpu", **PREFIX), A, 6)
    assert got == fresh
    assert eng.stats()["restore_hits"] == hits


def test_evicted_adapter_restores_bitwise():
    """A third tenant into a two-tenant pool LRU-evicts the first, whose
    rows spill to the tier; ``restore_adapter`` brings them back through
    the publish's insert, bitwise, and serves them; unknown names give
    None."""
    _, _, tb, tparams = bridged()
    eng = ServeEngine(tb, tparams, device="cpu", n_slots=2, page_size=4,
                      max_len=16, max_adapters=3, adapter_rank=4,
                      host_tier_bytes=1 << 24)
    rng = np.random.default_rng(1)
    shapes = tad.adapter_shapes(tb.config, rank=4)

    def adapter():
        return {t: {leaf: torch.from_numpy(
            rng.normal(0, 0.3, shp).astype(np.float32))
            for leaf, shp in pair.items()} for t, pair in shapes.items()}

    s1 = eng.publish_adapter(adapter(), name="t1")
    rows = {t: {leaf: pair[leaf][:, s1].clone() for leaf in ("a", "b")}
            for t, pair in eng.programs.adapter_stacks.items()}
    want = generate_many(eng, [Request(prompt_ids=[3, 4, 5],
                                       max_new_tokens=5, adapter_id=s1)])
    eng.publish_adapter(adapter(), name="t2")
    eng.publish_adapter(adapter(), name="t3")       # evicts t1 (LRU)
    assert eng.adapter_pool.stats["spill_evictions"] == 1
    rec = eng.host_tier.get(("adapter", "t1"))
    assert rec is not None and rec.nbytes == tad.adapter_nbytes(
        tb.config, rank=4)
    back = eng.restore_adapter("t1")
    assert back is not None and eng.host_tier.get(("adapter", "t1")) is None
    for t, pair in eng.programs.adapter_stacks.items():
        for leaf in ("a", "b"):
            assert torch.equal(pair[leaf][:, back], rows[t][leaf]), (t, leaf)
    got = generate_many(eng, [Request(prompt_ids=[3, 4, 5],
                                      max_new_tokens=5, adapter_id=back)])
    assert got[0].token_ids == want[0].token_ids
    assert eng.restore_adapter("never-spilled") is None


def test_stats_and_kv_report_expose_the_tier_as_jax():
    jb, jparams, tb, tparams = bridged()
    kw = dict(n_slots=2, page_size=4, max_len=16, host_tier_bytes=1 << 16)
    eng = ServeEngine(tb, tparams, device="cpu", **kw)
    jeng = JEngine(jb, jparams, **kw)
    assert set(eng.stats()) == set(jeng.stats())
    rep, jrep = eng.kv_report(), jeng.kv_report()
    for key in ("host_tier_budget_bytes", "host_tier_bytes",
                "host_tier_spilled_pages", "host_tier_page_capacity"):
        assert rep[key] == jrep[key], key


def test_disagg_preempt_spill_restore_identity():
    """The same contract through the cross-host pair: decode-side
    preemptions spill from the decode pool and the facade restores them
    ahead of re-admission; tokens equal the tier-free batch-1 run, the
    counts equal the JAX pair's."""
    jb, jparams, tb, tparams = bridged()
    kw = dict(n_slots=4, page_size=4, max_len=16, n_pages=7,
              n_prefill_pages=9, transport="cross_host",
              host_tier_bytes=1 << 20)
    specs = _spill_specs()
    eng = DisaggEngine(tb, tparams, device="cpu", **kw)
    ids, done = drive(eng, [Request(**s) for s in specs])
    jeng = JDisagg(jb, jparams, **kw)
    jgenerate(jeng, [JRequest(**s) for s in specs])
    ts, js = eng.stats(), jeng.stats()
    assert ts["preempted"] > 0
    assert ts["restore_hits"] + ts["restore_misses"] > 0
    for key in ("preempted", "restore_hits", "restore_misses",
                "tier_spills"):
        assert ts[key] == js[key], key
    for rid, s in zip(ids, specs):
        want = reference(tb, tparams, Request(**s), page_size=4, max_len=16)
        assert done[rid].token_ids == want.token_ids, s["seed"]
    assert eng.decode_pool.n_free == eng.decode_pool.capacity
    eng.close()
    jeng.close()
    assert dataclasses.is_dataclass(Request(prompt_ids=[1]))
