"""Multi-LoRA serving in the port (``serve/adapters.py``, the engine's
adapter pool, the llama family's grouped-GEMM hooks) against the JAX
package on the CPU, llama-debug weights and adapters carried across by the
weight bridge (fp32). The pool's bookkeeping and byte arithmetic equal the
JAX package's exactly; adapter 0 is bitwise the adapter-free engine;
adapted greedy tokens equal the JAX engine's with the same adapters
(bucketed, chunked, int8 weights), and the adapted prefill / decode logits
are within 1e-4 of JAX's after two layers (``tests/test_torch_llama.py``'s
bound); a tenant's stream is bitwise the same co-resident or solo; the
refusals of the JAX engine hold."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.models import llama as jllama
from distributed_training_guide_tpu.serve import Request as JRequest
from distributed_training_guide_tpu.serve import ServeEngine as JEngine
from distributed_training_guide_tpu.serve import adapters as jad
from distributed_training_guide_tpu.serve import kv_pages as jkv
from distributed_training_guide_tpu.serve.api import \
    generate_many as jgenerate
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.models import llama as tllama
from distributed_training_guide_tpu_torch.serve import (Request, ServeEngine,
                                                        generate_many)
from distributed_training_guide_tpu_torch.serve import adapters as tad
from distributed_training_guide_tpu_torch.serve import kv_pages as tkv
from distributed_training_guide_tpu_torch.serve.scheduler import \
    RefusalError
import torch_threads  # noqa: F401  (one torch thread a test process)

LOGIT_TOL = 1e-4
RANK = 4
ENGINE = dict(n_slots=4, page_size=4, max_len=32)
POOL = dict(max_adapters=4, adapter_rank=RANK)


@pytest.fixture(scope="module")
def models():
    jb = jget_model("llama-debug", dtype=jnp.float32)
    jparams = jb.init(jb.config, jax.random.key(0))
    tb = get_model("llama-debug", dtype=torch.float32)
    tparams = from_jax.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, tb, tparams


def _adapters(n: int, seed: int = 7) -> list:
    """n random adapters (numpy, the params['lora'] layout), large enough
    that each one moves the greedy tokens."""
    rng = np.random.default_rng(seed)
    shapes = tad.adapter_shapes(get_model("llama-debug").config, rank=RANK)
    return [{t: {leaf: rng.normal(0, 0.4, shp).astype(np.float32)
                 for leaf, shp in pair.items()}
             for t, pair in shapes.items()} for _ in range(n)]


def _specs(slots):
    """Requests under the adapter of each entry of ``slots``."""
    prompts = ([3, 17, 42], [9, 8, 7, 6, 5, 4], [11, 12], [5, 1, 4, 1, 5],
               [100, 200, 300, 400])
    return [dict(prompt_ids=prompts[i % len(prompts)],
                 max_new_tokens=5 + i % 3, adapter_id=a)
            for i, a in enumerate(slots)]


def _tokens(results):
    return [list(r.generated_ids) for r in results]


def _t_engine(tb, tparams, adapters=(), **kw):
    eng = ServeEngine(tb, tparams, device="cpu", **{**ENGINE, **POOL, **kw})
    slots = [eng.publish_adapter(from_jax.lora_from_numpy(a, device="cpu"),
                                 name=f"t{i}")
             for i, a in enumerate(adapters)]
    return eng, slots


def _j_engine(jb, jparams, adapters=(), **kw):
    eng = JEngine(jb, jparams, **{**ENGINE, **POOL, **kw})
    slots = [eng.publish_adapter(jax.tree.map(jnp.asarray, a), name=f"t{i}")
             for i, a in enumerate(adapters)]
    return eng, slots


def _pool_ops(pool, seq):
    """Apply (op, arg) pairs; each returns its result or the exception's
    type name, plus the pool's gauges after it."""
    out = []
    for op, arg in seq:
        try:
            r = getattr(pool, op)(*([] if arg is None else [arg]))
        except ValueError as exc:
            r = type(exc).__name__
        out.append((op, arg, r, pool.n_live, pool.n_free,
                    pool.live_slots(), dict(pool.stats)))
    return out


def test_pool_bookkeeping_equals_jax_on_operation_sequences():
    rng = np.random.default_rng(0)
    ops = ("alloc", "retain", "release", "evict", "mark_update", "describe",
           "refcount")
    for _ in range(3):
        seq = [(op, None if op == "alloc" else int(rng.integers(0, 5)))
               for op in rng.choice(ops, 60)]
        seq = [(op, f"n{i}" if op == "alloc" else a)
               for i, (op, a) in enumerate(seq)]
        want = _pool_ops(jad.AdapterPool(5, rank=4, alpha=8.0), seq)
        got = _pool_ops(tad.AdapterPool(5, rank=4, alpha=8.0), seq)
        assert got == want
    pool = tad.AdapterPool(3, rank=2)
    assert (pool.scale, pool.capacity, pool.is_live(0), pool.is_live(1),
            pool.is_live(True)) == (8.0, 2, True, False, False)
    for bad in (dict(max_adapters=1), dict(rank=0), dict(targets=("wz",))):
        kw = {"max_adapters": 3, "rank": 2, **bad}
        with pytest.raises(ValueError):
            tad.AdapterPool(kw.pop("max_adapters"), **kw)


def test_adapter_bytes_equal_jax_exactly():
    for name in ("llama-debug", "llama-3.1-8b", "llama-3.2-1b"):
        tcfg, jcfg = get_model(name).config, jget_model(name).config
        for rank, targets in ((8, ("wq", "wv")), (4, ("wq", "wk", "down")),
                              (16, tuple(tad.TARGET_PATHS))):
            kw = dict(rank=rank, targets=targets)
            assert tad.adapter_shapes(tcfg, **kw) == jad.adapter_shapes(
                jcfg, **kw)
            assert tad.adapter_nbytes(tcfg, **kw) == jad.adapter_nbytes(
                jcfg, **kw)
            assert (tad.adapter_pool_bytes(tcfg, max_adapters=5, **kw)
                    == jad.adapter_pool_bytes(jcfg, max_adapters=5, **kw))
    stacks = tad.init_adapter_stacks(get_model("llama-debug").config,
                                     max_adapters=3, rank=RANK)
    assert {t: {k: tuple(v.shape) for k, v in p.items()}
            for t, p in stacks.items()} == {
        "wq": {"a": (2, 3, 64, 4), "b": (2, 3, 4, 64)},
        "wv": {"a": (2, 3, 64, 4), "b": (2, 3, 4, 32)}}
    assert all(v.dtype == torch.float32 and not v.any()
               for p in stacks.values() for v in p.values())


@pytest.mark.parametrize("bad", ["targets", "leaves", "shape", "dtype"])
def test_validate_adapter_params_is_loud(bad):
    shapes = tad.adapter_shapes(get_model("llama-debug").config, rank=RANK)
    payload = _adapters(1)[0]
    if bad == "targets":
        payload = {"wq": payload["wq"]}
    elif bad == "leaves":
        payload["wv"] = {"a": payload["wv"]["a"]}
    elif bad == "shape":
        payload["wv"]["b"] = payload["wv"]["b"][:, :2]
    else:
        payload["wq"]["a"] = payload["wq"]["a"].astype(np.int32)
    match = {"targets": "targets mismatch", "leaves": "must hold leaves",
             "shape": "wv/b shape mismatch",
             "dtype": "wq/a must be floating"}[bad]
    with pytest.raises(ValueError, match=match):
        jad.validate_adapter_params(shapes, payload)
    with pytest.raises(ValueError, match=match):
        tad.validate_adapter_params(shapes, payload)
    with pytest.raises(ValueError, match=match):
        tad.validate_adapter_params(
            shapes, {t: {k: torch.from_numpy(v) for k, v in p.items()}
                     for t, p in payload.items()})


def _lora(stacks, adapters, scale):
    return {"scale": scale, "adapters": adapters, "stacks": stacks,
            "impl": "auto"}


def test_adapter_zero_is_bitwise_the_base(models):
    """The engine with a pool and two tenants published, its requests on
    adapter 0, gives the adapter-free engine's tokens; the forwards under
    an all-zero adapter vector give its logits bit for bit."""
    _, _, tb, tparams = models
    base = generate_many(ServeEngine(tb, tparams, device="cpu", **ENGINE),
                         [Request(**s) for s in _specs([0] * 5)])
    eng, _ = _t_engine(tb, tparams, _adapters(2))
    got = generate_many(eng, [Request(**s) for s in _specs([0] * 5)])
    assert _tokens(got) == _tokens(base)
    cfg = tb.config
    lora = _lora(eng.programs.adapter_stacks, torch.zeros(2, dtype=torch.int32),
                 eng.adapter_pool.scale)
    ids = torch.tensor([[3, 17, 42, 5], [9, 8, 7, 6]])
    out = [tllama.prefill(cfg, tparams, ids, tllama.init_cache(cfg, 2, 4, device="cpu"),
                          **kw)[0] for kw in ({}, {"lora": lora})]
    assert torch.equal(out[0], out[1])
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    outs = []
    for kw in ({}, {"lora": lora}):
        pools = tkv.init_pages(cfg, 6, 4, device="cpu")
        outs.append(tllama.paged_decode_step(
            cfg, tparams, torch.tensor([[7], [8]]), lengths, pools,
            tkv.make_attend(tables, lengths), **kw)[0])
    assert torch.equal(outs[0], outs[1])


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX engine's greedy tokens over a mix of tenants, bucketed and
    chunked, built once."""
    jb, jparams, _, _ = models
    out = {}
    for mode, kw in (("bucketed", {}), ("chunked", {"prefill_chunk": 4})):
        eng, slots = _j_engine(jb, jparams, _adapters(3), **kw)
        specs = _specs([0] + slots + slots[:1])
        out[mode] = _tokens(jgenerate(eng, [JRequest(**s) for s in specs]))
    return out


@pytest.mark.parametrize("mode", ["bucketed", "chunked"])
def test_adapted_greedy_tokens_equal_the_jax_engine(models, jax_tokens,
                                                     mode):
    _, _, tb, tparams = models
    eng, slots = _t_engine(tb, tparams, _adapters(3),
                           **({"prefill_chunk": 4} if mode == "chunked"
                              else {}))
    specs = _specs([0] + slots + slots[:1])
    got = _tokens(generate_many(eng, [Request(**s) for s in specs]))
    assert got == jax_tokens[mode]
    base = _tokens(generate_many(
        ServeEngine(tb, tparams, device="cpu", **ENGINE),
        [Request(**s) for s in _specs([0] * len(specs))]))
    assert got[0] == base[0] and got[1:] != base[1:]   # the tenants moved


def _jax_stacks(ads, g):
    stacks = jad.init_adapter_stacks(jget_model("llama-debug").config,
                                     max_adapters=g, rank=RANK)
    for slot, a in enumerate(ads, start=1):
        stacks = {t: {k: v.at[:, slot].set(a[t][k]) for k, v in p.items()}
                  for t, p in stacks.items()}
    return stacks


@pytest.mark.parametrize("t", [1, 4])
def test_adapted_forward_logits_match_jax(models, t):
    """Prefill and the paged step (T = 1: three slots on adapters 2, 0, 1;
    T = 4: a chunk on adapter 3) under the same stacks, within 1e-4."""
    jb, jparams, tb, tparams = models
    ads = _adapters(3, seed=t)
    jstacks = _jax_stacks(ads, 4)
    tstacks = from_jax.lora_from_numpy(jax.tree.map(np.asarray, jstacks),
                                       device="cpu")
    scale = 16.0 / RANK
    cfg, jcfg = tb.config, jb.config
    rng = np.random.default_rng(t)
    s = 3 if t == 1 else 1
    adapters = np.array([2, 0, 1] if t == 1 else [3], np.int32)
    ids = rng.integers(0, 512, (s, 6)).astype(np.int32)
    tl, _ = tllama.prefill(cfg, tparams, torch.from_numpy(ids),
                           tllama.init_cache(cfg, s, 6, device="cpu"),
                           lora=_lora(tstacks, torch.from_numpy(adapters),
                                      scale))
    jl, _ = jllama.prefill(jcfg, jparams, jnp.asarray(ids),
                           jllama.init_cache(jcfg, s, 6),
                           lora=_lora(jstacks, jnp.asarray(adapters), scale))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    tables = np.zeros((s, 4), np.int32)
    tables[:, :3] = rng.permutation(np.arange(1, 13))[:3 * s].reshape(s, 3)
    lengths = np.array([5, 9, 2][:s], np.int32)
    step_ids = rng.integers(0, 512, (s, t)).astype(np.int32)
    tpools = tkv.init_pages(cfg, 13, 4, device="cpu")
    jpools = jkv.init_pages(jcfg, 13, 4)
    tout, _ = tllama.paged_decode_step(
        cfg, tparams, torch.from_numpy(step_ids), torch.from_numpy(lengths),
        tpools, tkv.make_attend(torch.from_numpy(tables),
                                torch.from_numpy(lengths)),
        lora=_lora(tstacks, torch.from_numpy(adapters), scale))
    jout, _ = jllama.paged_decode_step(
        jcfg, jparams, jnp.asarray(step_ids), jnp.asarray(lengths), jpools,
        jkv.make_attend(jnp.asarray(tables), jnp.asarray(lengths),
                        impl="xla"),
        lora=_lora(jstacks, jnp.asarray(adapters), scale))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=LOGIT_TOL)


def test_co_resident_stream_is_bitwise_its_solo_stream(models):
    _, _, tb, tparams = models
    eng, slots = _t_engine(tb, tparams, _adapters(3))
    specs = _specs([slots[1], 0, slots[0], slots[2], slots[1]])
    together = generate_many(eng, [Request(**s) for s in specs])
    for spec, res in zip(specs, together):
        solo, _ = _t_engine(tb, tparams, _adapters(3))
        assert _tokens(generate_many(solo, [Request(**spec)])) == \
            [list(res.generated_ids)]


def test_int8_base_with_adapters_equals_the_jax_engine(models):
    """K7's plain version under the base, K5's under the deltas: the int8
    engine's adapted tokens equal the JAX int8 engine's."""
    jb, jparams, tb, tparams = models
    eng, slots = _t_engine(tb, tparams, _adapters(2), weight_dtype="int8")
    jeng, jslots = _j_engine(jb, jparams, _adapters(2), weight_dtype="int8")
    assert slots == jslots
    specs = _specs([slots[0], 0, slots[1]])
    assert (_tokens(generate_many(eng, [Request(**s) for s in specs]))
            == _tokens(jgenerate(jeng, [JRequest(**s) for s in specs])))


def test_refusals_of_the_jax_engine(models):
    """Unknown adapters at submit, slot 0 and dead slots as publish
    targets, a busy publish without ``force``, pool exhaustion while every
    tenant is referenced, eviction of a referenced tenant, a publish
    under ``swap_guard``."""
    _, _, tb, tparams = models
    eng, slots = _t_engine(tb, tparams, _adapters(3))
    with pytest.raises(RefusalError, match="not resident"):
        eng.submit(Request(prompt_ids=[3, 4], adapter_id=9))
    with pytest.raises(RefusalError, match="no adapter pool"):
        ServeEngine(tb, tparams, device="cpu", **ENGINE).submit(
            Request(prompt_ids=[3], adapter_id=1))
    payload = from_jax.lora_from_numpy(_adapters(1, seed=3)[0], device="cpu")
    with pytest.raises(ValueError, match="zero adapter"):
        eng.publish_adapter(payload, slot=0)
    for s in slots:
        eng.submit(Request(prompt_ids=[3, 4, 5], max_new_tokens=4,
                           adapter_id=s))
    with pytest.raises(RuntimeError, match="in flight"):
        eng.publish_adapter(payload)
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.publish_adapter(payload, force=True)
    with pytest.raises(ValueError, match="in-flight"):
        eng.evict_adapter(slots[0])
    assert eng.publish_adapter(payload, slot=slots[0], force=True) == \
        slots[0]
    while eng.has_work:
        eng.step()
    eng.evict_adapter(slots[1])
    with pytest.raises(ValueError, match="not live"):
        eng.publish_adapter(payload, slot=slots[1])
    assert eng.publish_adapter(payload) == slots[1]
    with eng.programs.swap_guard():
        with pytest.raises(RuntimeError, match="swap"):
            eng.publish_adapter(payload, slot=slots[1])
    with pytest.raises(ValueError, match="no adapter pool"):
        ServeEngine(tb, tparams, device="cpu", **ENGINE).publish_adapter(
            payload)
    stats = eng.stats()
    assert stats["adapter_publishes"] == 5 and stats["adapter_evictions"] == 1
    assert stats["adapter_updates"] == 1 and stats["adapters_live"] == 3


def test_prefix_cache_is_namespaced_per_adapter(models):
    """The same prompt under another adapter never reuses cached pages;
    under the same one it does, until a publish into that slot drops the
    namespace."""
    _, _, tb, tparams = models
    eng, slots = _t_engine(tb, tparams, _adapters(2), prefill_chunk=4)
    prompt = list(range(3, 15))

    def run(aid):
        before = eng.stats()["prefix_hits"]
        res = generate_many(eng, [Request(prompt_ids=prompt,
                                          max_new_tokens=2,
                                          adapter_id=aid)])
        return eng.stats()["prefix_hits"] - before, _tokens(res)[0]

    first = run(slots[0])
    assert first[0] == 0
    assert run(slots[1])[0] == 0 and run(0)[0] == 0
    assert run(slots[0]) == (1, first[1])
    eng.publish_adapter(from_jax.lora_from_numpy(_adapters(1, 5)[0],
                                                 device="cpu"),
                        slot=slots[0])
    assert run(slots[0])[0] == 0


def test_speculation_and_horizons_with_adapters_keep_the_tokens(models):
    _, _, tb, tparams = models
    specs = [dict(prompt_ids=[5, 6, 7, 5, 6, 7, 5, 6], max_new_tokens=10,
                  adapter_id=a) for a in (1, 0, 2)]
    eng, _ = _t_engine(tb, tparams, _adapters(2))
    off = _tokens(generate_many(eng, [Request(**s) for s in specs]))
    spec, _ = _t_engine(tb, tparams, _adapters(2), speculate="ngram",
                        spec_k=3)
    assert _tokens(generate_many(spec, [Request(**s) for s in specs])) == off
    assert spec.stats()["spec_tokens_drafted"] > 0
    hor, _ = _t_engine(tb, tparams, _adapters(2), decode_horizon=4)
    assert _tokens(generate_many(hor, [Request(**s) for s in specs])) == off


def test_republish_keeps_the_stacks_storage_and_reports(models):
    jb, jparams, tb, tparams = models
    eng, slots = _t_engine(tb, tparams, _adapters(1))
    ptrs = {(t, k): v.data_ptr()
            for t, p in eng.programs.adapter_stacks.items()
            for k, v in p.items()}
    new = _adapters(1, seed=11)[0]
    eng.publish_adapter(from_jax.lora_from_numpy(new, device="cpu"),
                        slot=slots[0])
    stacks = eng.programs.adapter_stacks
    assert ptrs == {(t, k): v.data_ptr() for t, p in stacks.items()
                    for k, v in p.items()}
    assert all(np.array_equal(stacks[t][k][:, slots[0]].numpy(), new[t][k])
               and not stacks[t][k][:, 0].any()
               for t in new for k in ("a", "b"))
    jeng, _ = _j_engine(jb, jparams, _adapters(1))
    assert eng.adapter_report() == jeng.adapter_report() | {
        "adapters_live": 1, "adapters_free": 2}
    assert eng.stats().keys() == jeng.stats().keys()


def test_families_without_hooks_and_fleet_seams_are_refused(models):
    _, _, tb, tparams = models
    for name in ("gpt2-debug", "moe-debug"):
        b = get_model(name)
        with pytest.raises(ValueError, match="multi-LoRA"):
            ServeEngine(b, b.init(b.config, 0, device="cpu"), device="cpu",
                        max_len=16, max_adapters=2)
    # the fleet seams: no tier attached, or no record for the name, is
    # "nothing to restore" (None), as in the JAX engine
    eng, _ = _t_engine(tb, tparams)
    assert eng.programs.restore_adapter("x") is None
    assert eng.restore_adapter("x") is None
    eng.programs.attach_host_tier(None)
    assert eng.restore_adapter("x") is None
    with pytest.raises(ValueError, match="must hold leaves"):
        from_jax.lora_from_numpy({"wq": {"a": np.zeros(1)}}, device="cpu")
