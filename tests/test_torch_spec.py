"""Speculative decoding in the port against the JAX package on the CPU.

The families' ``paged_decode_step(all_logits=True)`` and
``ModelPrograms.verify_for`` are held to JAX's with the weights carried
across by ``models/from_jax.py`` (fp32 logits within ``LOGIT_TOL``, greedy
targets, ``n_acc`` and ``new_lengths`` equal), ``NgramDrafter`` proposal
for proposal. Spec-on equals spec-off, token for token, for every family,
greedy and sampled, and greedy equals JAX's spec-off tokens. A spec-on ==
spec-off test proves nothing on a trace that never speculated, so every
case drafts by construction (a scripted oracle that proposes spec off's
own next tokens, a scripted wrong drafter, ``ngram`` on repetitive
prompts, a self-draft ``DraftModelDrafter``), asserts that it drafted,
and the cases together see accepted and rejected drafts."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.models.registry import \
    family_module as jfamily
from distributed_training_guide_tpu.serve import Request as JRequest
from distributed_training_guide_tpu.serve import ServeEngine as JEngine
from distributed_training_guide_tpu.serve import kv_pages as jkv
from distributed_training_guide_tpu.serve.api import \
    generate_many as jgenerate
from distributed_training_guide_tpu.serve.engine import \
    ModelPrograms as JPrograms
from distributed_training_guide_tpu.serve.spec import \
    NgramDrafter as JNgram
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.models.registry import \
    family_module
from distributed_training_guide_tpu_torch.serve import (
    DraftModelDrafter, Drafter, ModelPrograms, NgramDrafter, PagePool,
    Request, Scheduler, ServeEngine, generate_many)
from distributed_training_guide_tpu_torch.serve import kv_pages as tkv
import torch_threads  # noqa: F401  (one torch thread a test process)

LOGIT_TOL = 1e-4          # fp32 logits, port against JAX
KV_TOL = 1e-5             # fp32 pages, port against JAX
FAMILIES = ("llama-debug", "gpt2-debug", "neox-debug", "moe-debug")
ENGINE = dict(n_slots=4, page_size=4, max_len=64)
REPETITIVE = [9, 8, 7] * 4
_BRIDGED: dict = {}


def bridged(name: str, **over):
    """(JAX bundle, JAX params, port bundle, port params), fp32, the port's
    params carried across from JAX's."""
    key = (name, tuple(sorted(over.items())))
    if key not in _BRIDGED:
        jb = jget_model(name, dtype=jnp.float32, **over)
        jparams = jb.init(jb.config, jax.random.key(0))
        tb = get_model(name, dtype=torch.float32, **over)
        tparams = from_jax.params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu")
        _BRIDGED[key] = (jb, jparams, tb, tparams)
    return _BRIDGED[key]


def spec_requests(n: int = 4, max_new: int = 10) -> list:
    """Repetitive prompts (``ngram`` finds matches), greedy and sampled
    alternately, top-k on some."""
    return [dict(prompt_ids=REPETITIVE[:3 + (i % 5)] + [3 + i],
                 max_new_tokens=max_new,
                 temperature=0.0 if i % 2 == 0 else 0.9,
                 top_k=0 if i % 3 else 8, seed=i) for i in range(n)]


def drafting_requests(vocab: int) -> list:
    """``spec_requests`` at 24 new tokens: long enough for the debug
    models' greedy streams to revisit tokens, so ``ngram`` drafts on
    every family with these weights (each test asserts it did: a change
    of weights that stops it fails, it does not pass vacuously)."""
    del vocab
    return spec_requests(n=5, max_new=24)


def run(tb, tparams, specs, **kw):
    eng = ServeEngine(tb, tparams, device="cpu", **{**ENGINE, **kw})
    res = generate_many(eng, [Request(**s) for s in specs],
                        max_iterations=2000)
    return [r.token_ids for r in res], eng


class Scripted(Drafter):
    """Proposes each stream's own continuation from spec off (an oracle:
    every draft accepted) or that continuation plus one (every draft
    rejected)."""

    def __init__(self, streams, k: int, vocab: int, wrong: bool = False):
        self.streams, self.k, self.vocab, self.wrong = streams, k, vocab, wrong

    def propose(self, slot_idx, context, budget):
        for s in self.streams:
            if s[:len(context)] == list(context):
                nxt = s[len(context):len(context) + min(budget, self.k)]
                return [(t + 1) % self.vocab if self.wrong else t
                        for t in nxt]
        return []


def _pools(tb, jb, n_pages, page):
    return (tkv.init_pages(tb.config, n_pages, page, device="cpu"),
            jkv.init_pages(jb.config, n_pages, page))


def _tables(s, m, seed=0):
    perm = np.random.default_rng(seed).permutation(s * m) + 1
    return perm.reshape(s, m).astype(np.int32)


def _both_steps(jb, jparams, tb, tparams, jpages, tpages, ids, lens, tables,
                n_valid=None, all_logits=False):
    """One paged_decode_step through both packages; returns (JAX logits,
    JAX pages, port logits). The port's pools update in place."""
    jmod, tmod = jfamily(jb.family), family_module(tb.family)
    nv = None if n_valid is None else np.asarray(n_valid, np.int32)
    jl, jpages = jmod.paged_decode_step(
        jb.config, jparams, jnp.asarray(ids), jnp.asarray(lens), jpages,
        jkv.make_attend(jnp.asarray(tables), jnp.asarray(lens), impl="xla",
                        n_valid=None if nv is None else jnp.asarray(nv)),
        all_logits=all_logits)
    tl, _ = tmod.paged_decode_step(
        tb.config, tparams, torch.as_tensor(ids), torch.as_tensor(lens),
        tpages, tkv.make_attend(torch.as_tensor(tables),
                                torch.as_tensor(lens),
                                n_valid=None if nv is None
                                else torch.as_tensor(nv)),
        all_logits=all_logits)
    return np.asarray(jl), jpages, tl.float().numpy()


def _prefilled(name):
    """Both packages' pools after a [2, 5] chunk with a pad tail on slot 1
    (real 5 and 3 tokens), and everything a next call needs."""
    jb, jparams, tb, tparams = bridged(name)
    s, page, m = 2, 4, 6
    tables = _tables(s, m)
    tpages, jpages = _pools(tb, jb, 1 + s * m, page)
    ids = np.random.default_rng(1).integers(3, 500, (s, 5)).astype(np.int32)
    _, jpages, _ = _both_steps(jb, jparams, tb, tparams, jpages, tpages, ids,
                               np.zeros(s, np.int32), tables,
                               n_valid=[5, 3])
    return jb, jparams, tb, tparams, jpages, tpages, tables


@pytest.mark.parametrize("name", FAMILIES)
def test_all_logits_matches_jax(name):
    jb, jparams, tb, tparams, jpages, tpages, tables = _prefilled(name)
    ids = np.random.default_rng(2).integers(3, 500, (2, 3)).astype(np.int32)
    lens = np.array([5, 3], np.int32)
    jl, jpages, tl = _both_steps(jb, jparams, tb, tparams, jpages, tpages,
                                 ids, lens, tables, all_logits=True)
    assert tl.shape == jl.shape == (2, 3, tb.config.vocab_size)
    np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=0)
    for name_ in ("k", "v"):
        got, want = tpages[name_].numpy(), np.asarray(jpages[name_])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=KV_TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_verify_for_matches_jax(name):
    """Targets, n_acc, new_lengths and the pages of ONE verify forward,
    greedy, slot 0 with its first two drafts right (built by chaining
    JAX's own targets), slot 1 random with a pad tail."""
    jb, jparams, tb, tparams, jpages, tpages, tables = _prefilled(name)
    t = 4
    lens = np.array([5, 3], np.int32)
    ids = np.random.default_rng(3).integers(3, 500, (2, t)).astype(np.int32)
    n_valid = np.array([t, t - 1], np.int32)
    knobs = dict(seeds=np.array([0, 1], np.int32),
                 temps=np.zeros(2, np.float32),
                 top_ks=np.zeros(2, np.int32), top_ps=np.ones(2, np.float32),
                 actives=np.ones(2, bool))
    jprog = JPrograms(jb, jparams)
    jverify = jprog.verify_for(t, greedy=True)

    def jcall(ids):
        fresh = jax.tree.map(jnp.copy, jpages)
        return jverify(jprog.params, fresh["k"], fresh["v"],
                       jnp.asarray(ids), jnp.asarray(lens),
                       jnp.asarray(tables), *map(jnp.asarray, knobs.values()),
                       jnp.asarray(n_valid))

    for j in range(2):      # chain slot 0's drafts onto its targets
        ids[0, j + 1] = int(np.asarray(jcall(ids)[0])[0, j])
    jt, jn, jlen, jk, jv = map(np.asarray, jcall(ids))
    tprog = ModelPrograms(tb, tparams, device="cpu")
    tt, tn, tlen = tprog.verify_for(t, greedy=True)(
        tprog.params, tpages, torch.as_tensor(ids), torch.as_tensor(lens),
        torch.as_tensor(tables), *map(torch.as_tensor, knobs.values()),
        torch.as_tensor(n_valid))
    assert tt.numpy().tolist() == jt.tolist()
    assert tn.numpy().tolist() == jn.tolist() and jn[0] >= 2
    assert tlen.numpy().tolist() == jlen.tolist()
    # the pad tail went to the trash page (page 0), as JAX's did
    np.testing.assert_allclose(tpages["k"].numpy()[:, 1:], jk[:, 1:],
                               atol=KV_TOL)
    np.testing.assert_allclose(tpages["v"].numpy()[:, 1:], jv[:, 1:],
                               atol=KV_TOL)
    # the sampled program: the target at temperature 0 is the argmax too
    tt2, tn2, _ = tprog.verify_for(t, greedy=False)(
        tprog.params, tkv.init_pages(tb.config, 13, 4, device="cpu"),
        torch.as_tensor(ids), torch.as_tensor(lens), torch.as_tensor(tables),
        *map(torch.as_tensor, knobs.values()), torch.as_tensor(n_valid))
    assert tt2.shape == (2, t) and tn2.shape == (2,)


def test_ngram_drafter_matches_jax():
    rng = np.random.default_rng(4)
    contexts = [[int(x) for x in rng.integers(0, 6, n)]
                for n in rng.integers(1, 40, 60)]
    contexts += [REPETITIVE, [5] * 12, [1, 2, 3, 4, 5, 6, 1, 2, 3],
                 list(range(600)) + list(range(10))]
    for kw in (dict(k=4), dict(k=2, max_n=2), dict(k=5, min_n=2),
               dict(k=3, max_lookback=8)):
        mine, theirs = NgramDrafter(**kw), JNgram(**kw)
        for ctx in contexts:
            for budget in (0, 1, 3, 6):
                assert (mine.propose(0, ctx, budget)
                        == theirs.propose(0, ctx, budget)), (kw, ctx, budget)
    for bad in (dict(k=0), dict(min_n=0), dict(max_n=3, max_lookback=3)):
        with pytest.raises(ValueError):
            NgramDrafter(**bad)


@pytest.mark.parametrize("name", FAMILIES)
def test_spec_on_equals_spec_off_every_family(name):
    jb, jparams, tb, tparams = bridged(name)
    specs = drafting_requests(tb.config.vocab_size)
    off, _ = run(tb, tparams, specs)
    jres = jgenerate(JEngine(jb, jparams, **ENGINE),
                     [JRequest(**s) for s in specs])
    for s, a, b in zip(specs, off, jres):
        if s["temperature"] == 0.0:
            assert a == b.token_ids
    vocab = tb.config.vocab_size
    drafters = {
        "oracle": Scripted(off, 3, vocab),
        "wrong": Scripted(off, 3, vocab, wrong=True),
        "ngram": "ngram",
        "self-draft": DraftModelDrafter(tb, tparams, n_slots=4, max_len=64,
                                        k=3, page_size=4, device="cpu"),
    }
    seen = {"accepted": 0, "rejected": 0}
    for label, drafter in drafters.items():
        on, eng = run(tb, tparams, specs, speculate=drafter, spec_k=3)
        st = eng.stats()
        assert on == off, label
        assert st["spec_tokens_drafted"] > 0, f"{label} never drafted"
        assert eng.programs.verify_calls == st["spec_steps"] > 0
        if label == "oracle":
            assert st["spec_tokens_accepted"] == st["spec_tokens_drafted"]
        if label == "wrong":
            assert st["spec_tokens_accepted"] == 0
        seen["accepted"] += st["spec_tokens_accepted"]
        seen["rejected"] += st["spec_tokens_rejected"]
    assert seen["accepted"] > 0 and seen["rejected"] > 0


def test_spec_through_preemption_and_replay():
    _, _, tb, tparams = bridged("llama-debug")
    specs = [dict(prompt_ids=REPETITIVE[:1 + i % 3] + [3 + i],
                  max_new_tokens=6 + i % 5, seed=i,
                  temperature=0.8 if i % 2 else 0.0) for i in range(8)]
    kw = dict(n_slots=4, page_size=4, max_len=16, n_pages=7)
    off, off_eng = run(tb, tparams, specs, **kw)
    assert off_eng.scheduler.stats["preempted"] > 0
    on, eng = run(tb, tparams, specs, speculate="ngram", spec_k=3, **kw)
    assert on == off
    assert eng.scheduler.stats["preempted"] > 0
    assert eng.spec["tokens_drafted"] > 0
    pool = eng.scheduler.pool
    assert pool.n_free + eng.scheduler.cache_pages_held() == pool.capacity


def test_deadline_eviction_mid_speculation_is_strict_prefix():
    _, _, tb, tparams = bridged("llama-debug")
    keep = dict(prompt_ids=REPETITIVE[:6] + [3], max_new_tokens=8, seed=0)
    long = dict(prompt_ids=REPETITIVE[:5] + [4], max_new_tokens=24, seed=1)
    (ref_keep, ref_long), _ = run(tb, tparams, [keep, long])
    eng = ServeEngine(tb, tparams, device="cpu", speculate=Scripted(
        [ref_keep, ref_long], 3, tb.config.vocab_size), spec_k=3, **ENGINE)
    kid = eng.submit(Request(**keep))
    did = eng.submit(Request(**long, deadline_s=0.05))
    done = {r.request_id: r for _ in range(2) for r in eng.step()}
    time.sleep(0.08)
    while eng.has_work:
        for r in eng.step():
            done[r.request_id] = r
    assert eng.spec["tokens_drafted"] > 0
    assert done[did].finish_reason == "deadline"
    n = len(done[did].token_ids)
    assert n < len(ref_long) and done[did].token_ids == ref_long[:n]
    assert done[kid].token_ids == ref_keep


def test_lookahead_clamp_never_preempts():
    """``ensure_lookahead`` leaves a co-active decode's next page alone
    (drafts clamp to 0), and once that neighbour leaves it grows."""
    pool = PagePool(n_pages=4, page_size=4)
    sched = Scheduler(n_slots=2, pool=pool, max_len=16,
                      max_pages_per_slot=4, prefix_cache=False)
    sched.submit(Request(prompt_ids=[1, 2, 3], max_new_tokens=8))
    sched.submit(Request(prompt_ids=[4, 5, 6], max_new_tokens=1))
    for adm in sched.try_admit():
        sched.commit_tokens(adm.slot_idx, 3)
    assert pool.n_free == 1
    assert sched.ensure_lookahead(0, 6) == 0
    assert sched.stats["spec_lookahead_clamped"] == 1
    assert sched.stats["preempted"] == 0
    assert all(s is not None for s in sched.slots)
    assert sched.record_token(1, 42, from_decode=True) is not None
    assert sched.ensure_lookahead(0, 6) == 6
    assert sched.stats["preempted"] == 0


def test_spec_under_int8_weights():
    jb, jparams, tb, tparams = bridged("llama-debug")
    specs = drafting_requests(tb.config.vocab_size)
    off, _ = run(tb, tparams, specs, weight_dtype="int8")
    on, eng = run(tb, tparams, specs, weight_dtype="int8",
                  speculate="ngram", spec_k=3)
    assert on == off and eng.spec["tokens_drafted"] > 0
    assert eng.weight_report()["weight_dtype"] == "int8"
    jres = jgenerate(JEngine(jb, jparams, weight_dtype="int8",
                             speculate="ngram", spec_k=3, **ENGINE),
                     [JRequest(**s) for s in specs])
    for s, a, b in zip(specs, on, jres):
        if s["temperature"] == 0.0:
            assert a == b.token_ids


def test_stats_keys_and_spec_counters_match_jax():
    """The same greedy trace through both engines with ``ngram``: the same
    stats() keys, the same speculation
    counters, and the acceptance rate left out before any draft."""
    jb, jparams, tb, tparams = bridged("llama-debug")
    specs = [{**s, "temperature": 0.0}
             for s in drafting_requests(tb.config.vocab_size)]
    jeng = JEngine(jb, jparams, speculate="ngram", spec_k=3, **ENGINE)
    teng = ServeEngine(tb, tparams, device="cpu", speculate="ngram",
                       spec_k=3, **ENGINE)
    assert "spec_acceptance_rate" not in teng.stats()
    assert "spec_acceptance_rate" not in jeng.stats()
    jres = jgenerate(jeng, [JRequest(**s) for s in specs])
    tres = generate_many(teng, [Request(**s) for s in specs])
    assert [r.token_ids for r in tres] == [r.token_ids for r in jres]
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key in ("spec_steps", "spec_tokens_drafted", "spec_tokens_accepted",
                "spec_tokens_rejected", "spec_acceptance_rate",
                "decode_steps", "decode_tokens", "host_dispatches",
                "decode_tokens_per_step", "decode_horizon"):
        assert ts[key] == js[key], key
    assert ts["spec_tokens_drafted"] > 0


def test_spec_refusals_and_empty_drafts(monkeypatch):
    _, _, tb, tparams = bridged("llama-debug")
    with pytest.raises(ValueError, match="speculate must be"):
        ServeEngine(tb, tparams, device="cpu", speculate="medusa", **ENGINE)
    small = DraftModelDrafter(tb, tparams, n_slots=2, max_len=64,
                              page_size=4, device="cpu")
    with pytest.raises(ValueError, match="drafter covers 2 slots"):
        ServeEngine(tb, tparams, device="cpu", speculate=small, **ENGINE)
    with pytest.raises(ValueError, match="device='cpu'"):
        DraftModelDrafter(tb, tparams, n_slots=2, max_len=32,
                          attend_impl="xla", device="meta")
    # on the card the draft model's geometry is checked at construction
    # (llama-debug's head_dim 16 is not K4's), before anything allocates
    from distributed_training_guide_tpu_torch.serve import spec

    monkeypatch.setattr(spec, "resolve_device",
                        lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="draft model head_dim 16"):
        DraftModelDrafter(tb, tparams, n_slots=2, max_len=32)
    monkeypatch.undo()

    class Null(Drafter):
        k = 4

        def propose(self, slot_idx, context, budget):
            return []

    specs = spec_requests(2)
    off, _ = run(tb, tparams, specs)
    on, eng = run(tb, tparams, specs, speculate=Null())
    assert on == off
    assert eng.spec["spec_steps"] == 0 and eng.decode_steps > 0
