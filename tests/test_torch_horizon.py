"""Decode horizons in the port against the JAX package on the CPU.

``ModelPrograms.horizon_for`` against JAX's (block, tokens, lengths, live
lanes, budgets equal; pages within ``KV_TOL``), and the engine at K > 1
token-identical to K = 1 for every completion, greedy and sampled, on
llama (fp32 and int8 pools), gpt2 and moe, greedy equal to JAX's. A lane
that finishes mid-horizon (EOS or budget) emits a strict prefix and its
remaining writes land only in the trash page; preemption and deadline
eviction happen at horizon boundaries; speculation with a horizon is
refused everywhere it could be configured; both knobs change mid-stream
without changing a token; the gauges and the kv report match JAX's."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.serve import Request as JRequest
from distributed_training_guide_tpu.serve import ServeEngine as JEngine
from distributed_training_guide_tpu.serve import kv_pages as jkv
from distributed_training_guide_tpu.serve.api import \
    generate_many as jgenerate
from distributed_training_guide_tpu.serve.engine import \
    ModelPrograms as JPrograms
from distributed_training_guide_tpu_torch.serve import (ModelPrograms,
                                                        Request, ServeEngine,
                                                        generate_many)
from distributed_training_guide_tpu_torch.serve import kv_pages as tkv
from test_torch_spec import bridged
import torch_threads  # noqa: F401  (one torch thread a test process)

KV_TOL = 1e-5             # fp32 pages, port against JAX
ENGINE = dict(n_slots=3, page_size=4, max_len=32)


def requests(n: int = 5) -> list:
    return [dict(prompt_ids=[3 + i, 17, 42, 9][:1 + i % 4],
                 max_new_tokens=5 + 3 * (i % 4), seed=i,
                 temperature=0.8 if i % 2 else 0.0,
                 top_p=0.9 if i % 3 == 1 else 1.0) for i in range(n)]


def run(tb, tparams, specs, **kw):
    eng = ServeEngine(tb, tparams, device="cpu", **{**ENGINE, **kw})
    res = generate_many(eng, [Request(**s) for s in specs],
                        max_iterations=3000)
    return [r.token_ids for r in res], eng


def test_horizon_for_matches_jax():
    """One K = 5 horizon from the same pools and lanes: lane 0 runs its
    budget out at step 3, lane 1 hits its EOS at step 2 (the eos taken
    from a first JAX horizon), lane 2 is dead from the start."""
    jb, jparams, tb, tparams = bridged("llama-debug")
    s, page, m, k = 3, 4, 4, 5
    tables = (np.random.default_rng(0).permutation(s * m) + 1).reshape(
        s, m).astype(np.int32)
    n_pages = 1 + s * m
    lanes = dict(
        tokens=np.array([5, 9, 0], np.int32),
        lengths=np.array([2, 4, 0], np.int32), tables=tables,
        seeds=np.arange(s, dtype=np.int32),
        temps=np.array([0.0, 0.7, 0.0], np.float32),
        top_ks=np.zeros(s, np.int32), top_ps=np.ones(s, np.float32),
        live=np.array([True, True, False]),
        budgets=np.array([3, 9, 0], np.int32),
        eos_ids=np.array([-1, -1, -1], np.int32))
    rng = np.random.default_rng(1)
    kfill = rng.standard_normal((jb.config.num_layers, n_pages, page,
                                 jb.config.num_kv_heads,
                                 jb.config.head_size)).astype(np.float32)
    vfill = rng.standard_normal(kfill.shape).astype(np.float32)
    jprog = JPrograms(jb, jparams)

    def jrun(lanes):
        return [np.asarray(x) for x in jprog.horizon_for(k)(
            jprog.params, jnp.asarray(kfill), jnp.asarray(vfill),
            *(jnp.asarray(lanes[n]) for n in (
                "tokens", "lengths", "tables", "seeds", "temps", "top_ks",
                "top_ps", "live", "budgets", "eos_ids")))]

    # greedy lanes only on the JAX side's draw: lane 1 (sampled) is held
    # by its EOS, which the greedy lane 0 cannot reach
    lanes["temps"][1] = 0.0
    lanes["eos_ids"][1] = int(jrun(lanes)[0][1, 1])
    want = jrun(lanes)
    tprog = ModelPrograms(tb, tparams, device="cpu")
    pages = {"k": torch.from_numpy(kfill.copy()),
             "v": torch.from_numpy(vfill.copy())}
    got = tprog.horizon_for(k)(
        tprog.params, pages, *(torch.as_tensor(lanes[n]) for n in (
            "tokens", "lengths", "tables", "seeds", "temps", "top_ks",
            "top_ps", "live", "budgets", "eos_ids")), stochastic=False)
    for name, g, w in zip(("block", "tokens", "lengths", "live", "budgets"),
                          got, want):
        assert g.numpy().tolist() == w.tolist(), name
    block = want[0]
    assert block[0, 3:].tolist() == [0, 0] and block[0, 2] != 0
    assert block[1, 2:].tolist() == [0, 0, 0] and not want[3][1]
    assert not block[2].any()
    np.testing.assert_allclose(pages["k"].numpy()[:, 1:], want[5][:, 1:],
                               atol=KV_TOL)
    np.testing.assert_allclose(pages["v"].numpy()[:, 1:], want[6][:, 1:],
                               atol=KV_TOL)


CASES = {"llama": ("llama-debug", {}),
         "llama-int8-kv": ("llama-debug", {"kv_dtype": "int8"}),
         "gpt2": ("gpt2-debug", {}),
         "moe": ("moe-debug", {})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_horizon_bitwise_k1_and_jax(case):
    name, kw = CASES[case]
    jb, jparams, tb, tparams = bridged(name)
    specs = requests()
    k1, _ = run(tb, tparams, specs, **kw)
    k4, eng = run(tb, tparams, specs, decode_horizon=4, **kw)
    assert k4 == k1
    assert eng.host_dispatches < eng.decode_steps
    jres = jgenerate(JEngine(jb, jparams, decode_horizon=4, **ENGINE, **kw),
                     [JRequest(**s) for s in specs])
    for s, a, b in zip(specs, k4, jres):
        if s["temperature"] == 0.0:
            assert a == b.token_ids


def test_eos_mid_horizon_strict_prefix_and_trash_containment():
    _, _, tb, tparams = bridged("llama-debug")
    free, _ = run(tb, tparams, [dict(prompt_ids=[5, 9, 13],
                                     max_new_tokens=10)], n_slots=1)
    gen = free[0][3:]
    idx = next(i for i in range(1, 10) if gen[i] not in gen[:i])
    eng = ServeEngine(tb, tparams, device="cpu", n_slots=2, page_size=4,
                      max_len=32, decode_horizon=5)
    before = {n: eng.pages[n].clone() for n in ("k", "v")}
    eng.submit(Request(prompt_ids=[5, 9, 13], max_new_tokens=10,
                       eos_id=gen[idx]))
    touched, done = set(), []
    for _ in range(200):
        if not eng.has_work:
            break
        done.extend(eng.step())
        for slot in eng.scheduler.slots:
            if slot is not None:
                touched.update(slot.pages)
    [res] = done
    assert res.finish_reason == "eos"
    assert res.generated_ids == gen[:idx + 1]
    for p in range(eng.scheduler.pool.n_pages):
        if p in touched or p == 0:        # page 0 is the trash page
            continue
        for n in ("k", "v"):
            assert torch.equal(before[n][:, p], eng.pages[n][:, p]), \
                f"page {p} written past EOS outside the trash page"


def test_preemption_at_horizon_boundaries_replays_bitwise():
    _, _, tb, tparams = bridged("llama-debug")
    specs = [dict(prompt_ids=[3 + i, 17, 42][:1 + i % 3],
                  max_new_tokens=6 + i % 5, seed=i,
                  temperature=0.8 if i % 2 else 0.0) for i in range(8)]
    kw = dict(n_slots=4, page_size=4, max_len=16, n_pages=7)
    k1, _ = run(tb, tparams, specs, **kw)
    k4, eng = run(tb, tparams, specs, decode_horizon=4, **kw)
    assert eng.scheduler.stats["preempted"] > 0
    assert k4 == k1
    pool = eng.scheduler.pool
    assert pool.n_free + eng.scheduler.cache_pages_held() == pool.capacity


def test_deadline_eviction_at_horizon_boundary_is_strict_prefix():
    _, _, tb, tparams = bridged("llama-debug")
    kw = dict(n_slots=2, page_size=4, max_len=64)
    keep = dict(prompt_ids=[5, 9, 13], max_new_tokens=8, seed=0)
    long = dict(prompt_ids=[7, 11], max_new_tokens=60, seed=1)
    (ref_keep, ref_long), _ = run(tb, tparams, [keep, long], **kw)
    eng = ServeEngine(tb, tparams, device="cpu", decode_horizon=4, **kw)
    kid = eng.submit(Request(**keep))
    did = eng.submit(Request(**long, deadline_s=0.05))
    done = {r.request_id: r for r in eng.step()}
    time.sleep(0.08)
    while eng.has_work:
        for r in eng.step():
            done[r.request_id] = r
    assert done[did].finish_reason == "deadline"
    n = len(done[did].token_ids)
    assert n < len(ref_long) and done[did].token_ids == ref_long[:n]
    assert done[kid].token_ids == ref_keep


def test_spec_plus_horizon_refused_everywhere():
    _, _, tb, tparams = bridged("llama-debug")
    with pytest.raises(ValueError, match="decode_horizon"):
        ServeEngine(tb, tparams, device="cpu", speculate="ngram",
                    decode_horizon=2, **ENGINE)
    with pytest.raises(ValueError, match="decode_horizon must be >= 1"):
        ServeEngine(tb, tparams, device="cpu", decode_horizon=0, **ENGINE)
    eng = ServeEngine(tb, tparams, device="cpu", speculate="ngram", **ENGINE)
    with pytest.raises(ValueError, match="set_decode_horizon"):
        eng.set_decode_horizon(2)
    assert eng.set_speculation(False) is False       # parked, not gone
    with pytest.raises(ValueError, match="set_decode_horizon"):
        eng.set_decode_horizon(2)
    plain = ServeEngine(tb, tparams, device="cpu", decode_horizon=4,
                        **ENGINE)
    with pytest.raises(ValueError, match="set_speculation"):
        plain.set_speculation(True)
    assert plain.set_speculation(False) is False
    assert plain.set_decode_horizon(1) == 1
    assert plain.set_decode_horizon(8) == 8
    with pytest.raises(ValueError, match=">= 1"):
        plain.set_decode_horizon(0)


def _steps(eng, n, done):
    for _ in range(n):
        for r in eng.step():
            done[r.request_id] = r


def test_knobs_change_mid_stream_without_changing_a_token():
    _, _, tb, tparams = bridged("llama-debug")
    specs = [dict(prompt_ids=[9, 8, 7, 9, 8, 7, 9, 8][:4 + i],
                  max_new_tokens=24, seed=i,
                  temperature=0.9 if i % 2 else 0.0) for i in range(3)]
    off, _ = run(tb, tparams, specs)
    eng = ServeEngine(tb, tparams, device="cpu", speculate="ngram",
                      spec_k=3, **ENGINE)
    ids = [eng.submit(Request(**s)) for s in specs]
    done: dict = {}
    _steps(eng, 3, done)
    assert eng.set_speculation(False) is False
    _steps(eng, 3, done)
    assert eng.set_speculation(True) is True
    while eng.has_work:
        _steps(eng, 1, done)
    assert [done[i].token_ids for i in ids] == off
    assert eng.spec["tokens_drafted"] > 0
    eng = ServeEngine(tb, tparams, device="cpu", **ENGINE)
    ids = [eng.submit(Request(**s)) for s in specs]
    done = {}
    _steps(eng, 2, done)
    eng.set_decode_horizon(4)
    _steps(eng, 3, done)
    eng.set_decode_horizon(1)
    _steps(eng, 2, done)
    eng.set_decode_horizon(3)
    while eng.has_work:
        _steps(eng, 1, done)
    assert [done[i].token_ids for i in ids] == off
    assert eng.host_dispatches < eng.decode_steps


def test_gauges_and_kv_report_match_jax():
    """The same trace at K = 4 through both engines: stats() keys, the
    horizon gauges, the kv report's horizon
    rows; the acceptance rate left out where nothing was drafted; the
    pools keep their storage."""
    jb, jparams, tb, tparams = bridged("llama-debug")
    specs = [dict(prompt_ids=[5, 9, 13], max_new_tokens=9, seed=0)]
    jeng = JEngine(jb, jparams, decode_horizon=4, **ENGINE)
    teng = ServeEngine(tb, tparams, device="cpu", decode_horizon=4, **ENGINE)
    ptrs = {n: teng.pages[n].data_ptr() for n in ("k", "v")}
    jres = jgenerate(jeng, [JRequest(**s) for s in specs])
    tres = generate_many(teng, [Request(**s) for s in specs])
    assert tres[0].token_ids == jres[0].token_ids
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key in ("decode_horizon", "host_dispatches", "horizon_ksum",
                "decode_steps", "decode_tokens", "tokens_per_dispatch",
                "horizon_effective", "decode_tokens_per_step"):
        assert ts[key] == js[key], key
    assert ts["host_dispatches"] == 2 and ts["horizon_effective"] == 4.0
    assert "spec_acceptance_rate" not in ts
    jrep, trep = jeng.kv_report(), teng.kv_report()
    for key in ("decode_horizon", "horizon_block_bytes",
                "dispatches_per_step", "bytes_per_page", "pool_bytes"):
        assert trep[key] == jrep[key], key
    assert all(teng.pages[n].data_ptr() == ptrs[n] for n in ("k", "v"))
    assert jkv.TRASH_PAGE == tkv.TRASH_PAGE == 0
