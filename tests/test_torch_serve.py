"""The port's ServeEngine against the JAX package's on the CPU: the same
requests through both engines, greedy, with llama-debug weights carried
across by the weight bridge (fp32), must give IDENTICAL tokens — bucketed
prefill, chunked prefill, a copy-on-write prefix fork, a pool small
enough to force preemption and replay, and an int8 KV pool. The two
schedulers, driven by one random submit/step trace, must make the same
decisions. At temperature > 0 the port keeps the JAX contract (not its
bits): a request's tokens do not depend on its batch or admission order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.serve import Request as JRequest
from distributed_training_guide_tpu.serve import ServeEngine as JEngine
from distributed_training_guide_tpu.serve import kv_pages as jkv
from distributed_training_guide_tpu.serve import scheduler as jsched
from distributed_training_guide_tpu.serve.api import \
    generate_many as jgenerate
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.serve import (Request, ServeEngine,
                                                        generate_many)
from distributed_training_guide_tpu_torch.serve import kv_pages as tkv
from distributed_training_guide_tpu_torch.serve import scheduler as tsched
import torch_threads  # noqa: F401  (one torch thread a test process)


@pytest.fixture(scope="module")
def models():
    jb = jget_model("llama-debug", dtype=jnp.float32)
    jparams = jb.init(jb.config, jax.random.key(0))
    tb = get_model("llama-debug", dtype=torch.float32)
    tparams = from_jax.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, tb, tparams


def _specs(rng, n, max_prompt, max_total):
    out = []
    for i in range(n):
        p = int(rng.integers(1, max_prompt + 1))
        out.append(dict(prompt_ids=[int(x) for x in rng.integers(3, 500, p)],
                        max_new_tokens=int(rng.integers(2, max_total - p + 1)),
                        seed=i))
    return out


SHARED = [9, 8, 7, 6, 5, 4, 3, 2, 1]
CASES = {
    # engine kwargs, request batches (each batch is one generate_many call)
    "bucketed": (dict(n_slots=3, page_size=4, max_len=32),
                 [_specs(np.random.default_rng(0), 6, 12, 32)]),
    "chunked": (dict(n_slots=3, page_size=4, max_len=32, prefill_chunk=4),
                [_specs(np.random.default_rng(1), 6, 12, 32)]),
    # the second prompt diverges inside page 2 of the registered first:
    # its admission forks that page copy-on-write
    "cow_fork": (dict(n_slots=2, page_size=4, max_len=32, prefill_chunk=4),
                 [[dict(prompt_ids=SHARED, max_new_tokens=3)],
                  [dict(prompt_ids=SHARED[:6] + [99], max_new_tokens=5)],
                  [dict(prompt_ids=SHARED, max_new_tokens=3)]]),
    # 6 usable pages for 4 slots of up to 4 pages each: growth preempts,
    # and the victims replay their tokens through the decode step
    "preemption": (dict(n_slots=4, page_size=4, max_len=16, n_pages=7),
                   [[dict(prompt_ids=[3 + i, 17, 42][:1 + i % 3],
                          max_new_tokens=6 + i % 5, seed=i)
                     for i in range(8)]]),
    "int8": (dict(n_slots=3, page_size=4, max_len=32, kv_dtype="int8"),
             [_specs(np.random.default_rng(2), 5, 12, 32)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_identical_to_jax_engine(models, case):
    jb, jparams, tb, tparams = models
    kwargs, batches = CASES[case]
    jeng = JEngine(jb, jparams, **kwargs)
    teng = ServeEngine(tb, tparams, device="cpu", **kwargs)
    for batch in batches:
        jres = jgenerate(jeng, [JRequest(**r) for r in batch],
                         max_iterations=2000)
        tres = generate_many(teng, [Request(**r) for r in batch],
                             max_iterations=2000)
        for j, t in zip(jres, tres):
            assert t.token_ids == j.token_ids
            assert t.finish_reason == j.finish_reason
    js, ts = jeng.scheduler.stats, teng.scheduler.stats
    for key in ("admitted", "preempted", "prefix_hits",
                "prefix_tokens_shared", "cow_forks", "admission_blocked"):
        assert ts[key] == js[key], key
    if case == "cow_fork":
        assert ts["cow_forks"] == 1
    if case == "preemption":
        assert ts["preempted"] > 0
    pool = teng.scheduler.pool
    assert pool.n_free + teng.scheduler.cache_pages_held() == pool.capacity
    assert teng.kv_cache_bytes() == jeng.kv_cache_bytes()


def _drive(sched_mod, kv_mod, seed):
    """One random submit/step trace through a bare Scheduler: admissions
    commit their whole prompt, decodes record tokens drawn from the trace
    rng. Returns the per-iteration decision log."""
    rng = np.random.default_rng(seed)
    pool = kv_mod.PagePool(n_pages=9, page_size=4)
    sched = sched_mod.Scheduler(n_slots=3, pool=pool, max_len=24,
                                max_pages_per_slot=6, prefix_cache=True,
                                allow_partial_share=True)
    log = []
    n_sub = 0
    for it in range(300):
        if rng.random() < 0.35 and n_sub < 25:
            n = int(rng.integers(1, 10))
            # a shared prefix cut at a page boundary or inside a page:
            # full-page sharing and copy-on-write forks both occur
            cut = int(rng.choice([0, 4, 6, 8, 10]))
            prompt = [7, 7, 7, 7, 8, 8, 8, 8, 9, 9, 9, 9][:cut] + [
                int(x) for x in rng.integers(3, 60, n)]
            sched.submit(sched_mod.Request(
                prompt_ids=prompt[:20],
                max_new_tokens=int(rng.integers(1, 24 - len(prompt[:20]) + 1)),
                seed=n_sub))
            n_sub += 1
        adms = sched.try_admit()
        for a in adms:
            sched.commit_tokens(a.slot_idx, len(a.tokens) - a.shared_len)
            sched.record_token(a.slot_idx, int(rng.integers(0, 60)),
                               from_decode=False)
        grown, preempted = sched.grow_for_decode()
        finished = [r.request_id for i in sched.active_indices()
                    for r in [sched.record_token(i, int(rng.integers(0, 60)),
                                                 from_decode=True)]
                    if r is not None]
        holders = [{p: 1} for s in sched.slots if s is not None
                   for p in s.pages]
        stack = [sched.cache.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                holders.append({child.page: 1})
                stack.append(child)
        kv_mod.pool_audit(pool, holders)
        log.append(([(a.slot_idx, a.request.request_id, a.shared_len,
                      a.fork, a.resumed) for a in adms], grown, preempted,
                    finished, pool.n_free, list(pool._refs)))
    return log, dict(sched.stats)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_decisions_match_jax_scheduler(seed):
    jlog, jstats = _drive(jsched, jkv, seed)
    tlog, tstats = _drive(tsched, tkv, seed)
    assert tlog == jlog
    assert tstats == jstats
    assert tstats["preempted"] > 0 and tstats["cow_forks"] > 0


STOCHASTIC = [dict(prompt_ids=[3, 17], max_new_tokens=6, temperature=0.9,
                   top_k=40, top_p=0.9, seed=7),
              dict(prompt_ids=[9, 2, 5], max_new_tokens=6, temperature=0.7,
                   seed=8),
              dict(prompt_ids=[4], max_new_tokens=5, temperature=1.3,
                   seed=9),
              dict(prompt_ids=[11, 12, 13, 14, 15], max_new_tokens=4,
                   seed=10)]


@pytest.mark.parametrize("chunk", [None, 4])
def test_sampling_is_batch_and_order_invariant(models, chunk):
    """Batch-1 invariance (each request alone in a one-slot engine) and
    order invariance (reversed submission, another slot count): the draw
    is a pure function of (seed, position), so the tokens agree exactly."""
    _, _, tb, tparams = models
    kw = dict(page_size=4, max_len=16, prefill_chunk=chunk, device="cpu")
    reqs = [Request(**r) for r in STOCHASTIC]
    a = generate_many(ServeEngine(tb, tparams, n_slots=2, **kw), reqs)
    b = generate_many(ServeEngine(tb, tparams, n_slots=3, **kw),
                      list(reversed(reqs)))
    for i, r in enumerate(reqs):
        alone = generate_many(ServeEngine(tb, tparams, n_slots=1, **kw),
                              [dataclasses.replace(r)])[0]
        assert a[i].token_ids == b[len(reqs) - 1 - i].token_ids
        assert a[i].token_ids == alone.token_ids
    sampled = [t for r in a[:3] for t in r.generated_ids]
    assert all(0 <= t < tb.config.vocab_size for t in sampled)
    # the stochastic requests differ from their greedy twins somewhere
    greedy = generate_many(ServeEngine(tb, tparams, n_slots=3, **kw),
                           [dataclasses.replace(r, temperature=0.0)
                            for r in reqs[:3]])
    assert [g.token_ids for g in greedy] != [x.token_ids for x in a[:3]]


def test_unported_features_and_bad_input_refused(models):
    _, _, tb, tparams = models
    # the sharded pool refuses what the JAX engine refuses, in its words
    # (plans over a mesh's shape: nothing is placed before the check)
    from distributed_training_guide_tpu_torch.parallel.plans import make_plan

    for kw, match in (
            (dict(shard_kv=True), "needs a plan= with a tp mesh"),
            (dict(shard_kv=True, plan=make_plan("tp", {"tp": 1})),
             "needs mesh tp > 1"),
            (dict(shard_kv=True, plan=make_plan("tp", {"tp": 2, "fsdp": 2})),
             "tp-only meshes"),
            (dict(shard_kv=True, plan=make_plan("tp", {"tp": 4})),
             r"num_kv_heads \(2\) and num_heads \(4\) must both divide")):
        with pytest.raises(ValueError, match=match):
            ServeEngine(tb, tparams, device="cpu", max_len=16, **kw)
    eng = ServeEngine(tb, tparams, device="cpu", max_len=16, n_slots=1)
    with pytest.raises(tsched.RefusalError, match="out of range"):
        eng.submit(Request(prompt_ids=[3, 512]))
    with pytest.raises(ValueError, match="Unknown model"):
        get_model("no-such-model")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(tb, tparams, max_len=16)        # default device: cuda
