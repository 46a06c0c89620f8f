"""The port's post-training objective and step against the JAX package on
the CPU: ``_pack_ragged`` and ``pack_rollouts`` exactly; ``post_loss`` (both
objectives, K5's plain version at K = N = 1) in value and in its gradient
with respect to the logits within 1e-5, with exactly zero gradient at the
prompt and pad positions; one ``make_post_step`` from the same state and
batch (LoRA adapters and full params, each baseline) within 1e-5 of the
loss and 1e-4 of the updated params; the scorers' rewards and teacher rows
within 1e-4 (logits after two layers); ``jit_merge`` and ``qlora_base``
against JAX's; ``price_post_colocation`` byte for byte (the optimizers'
0-d step counters set aside, as ``tests/test_torch_preflight.py`` does).
llama-debug weights cross by the weight bridge (fp32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.models import lora as jlora
from distributed_training_guide_tpu.post import loop as jloop
from distributed_training_guide_tpu.post import score as jscore
from distributed_training_guide_tpu.post.rollout import Rollout as JRollout
from distributed_training_guide_tpu.train import optimizer as jopt
from distributed_training_guide_tpu.train import preflight as jpre
from distributed_training_guide_tpu.train import step as jstep
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.models import lora as tlora
from distributed_training_guide_tpu_torch.post import loop as tloop
from distributed_training_guide_tpu_torch.post import score as tscore
from distributed_training_guide_tpu_torch.post.rollout import Rollout
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train import preflight as tpre
from distributed_training_guide_tpu_torch.train import step as tstep
from distributed_training_guide_tpu_torch.train.state import named_leaves
import torch_threads  # noqa: F401  (one torch thread a test process)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 1e-4
LOGIT_TOL = 1e-4
TARGETS = ("wq", "wv")


@pytest.fixture(scope="module")
def models():
    jb = jget_model("llama-debug", dtype=jnp.float32)
    tb = get_model("llama-debug", dtype=torch.float32)
    jparams = jb.init(jb.config, jax.random.key(0))
    return jb, jparams, tb, _to_torch(jparams)


def _to_torch(tree):
    return from_jax.params_from_numpy(jax.tree.map(np.asarray, tree),
                                      device="cpu")


def _ragged(rng, b, s):
    """prompt / total lengths with an empty continuation and a full row."""
    prompt = rng.integers(1, s // 2, b).astype(np.int32)
    total = np.minimum(prompt + rng.integers(0, s, b), s).astype(np.int32)
    total[0] = prompt[0]                  # nothing sampled
    total[-1] = s                         # the whole width
    return prompt, total


def test_pack_ragged_equals_jax_exactly():
    rng = np.random.default_rng(0)
    for b, s in ((5, 12), (3, 7), (1, 4)):
        prompt, total = _ragged(rng, b, s)
        values = rng.normal(size=(b, s)).astype(np.float32)
        sizes = total - prompt
        want = jstep._pack_ragged(jnp.asarray(values), jnp.asarray(prompt),
                                  jnp.asarray(sizes), s)
        got = tstep._pack_ragged(torch.from_numpy(values),
                                 torch.from_numpy(prompt),
                                 torch.from_numpy(sizes), s)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("objective", ["reinforce", "distill_kl"])
def test_post_loss_and_its_logits_grad_match_jax(objective):
    rng = np.random.default_rng(1)
    b, s, v = 4, 10, 32
    logits = rng.normal(0, 2, (b, s, v)).astype(np.float32)
    tokens = rng.integers(0, v, (b, s)).astype(np.int32)
    prompt, total = _ragged(rng, b, s)
    adv = rng.normal(size=b).astype(np.float32)
    teacher = np.array(jax.nn.log_softmax(
        rng.normal(size=(b, s, v)).astype(np.float32), -1))
    kw = dict(objective=objective)

    def jloss(x):
        return jstep.post_loss(x, jnp.asarray(tokens), jnp.asarray(prompt),
                               jnp.asarray(total),
                               advantages=jnp.asarray(adv),
                               teacher_logprobs=jnp.asarray(teacher), **kw)

    (jl, jx), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    tl, tx = tstep.post_loss(x, torch.from_numpy(tokens),
                             torch.from_numpy(prompt),
                             torch.from_numpy(total),
                             advantages=torch.from_numpy(adv),
                             teacher_logprobs=torch.from_numpy(teacher),
                             **kw)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=GRAD_TOL)
    assert {k: float(v) for k, v in tx.items()} == pytest.approx(
        {k: float(v) for k, v in jx.items()}, abs=LOSS_TOL)
    for i in range(b):      # only source positions of sampled tokens
        live = np.zeros(s, bool)
        live[prompt[i] - 1:total[i] - 1] = True
        assert not x.grad[i][torch.from_numpy(~live)].any(), i
    with pytest.raises(ValueError, match="unknown post objective"):
        tstep.post_loss(x, torch.from_numpy(tokens),
                        torch.from_numpy(prompt), torch.from_numpy(total),
                        objective="dpo")


def _rollouts(rollout_cls, rng, b=4, v=32):
    out = []
    for i in range(b):
        p = [int(t) for t in rng.integers(3, v, 1 + i % 3)]
        g = [int(t) for t in rng.integers(3, v, (i * 3) % 5)]
        out.append(rollout_cls(iteration=0, index=i, prompt_ids=p,
                               generated_ids=g, seed=i,
                               finish_reason="length", group_id=i // 2))
    return out


def test_pack_rollouts_equals_jax_exactly():
    rng = np.random.default_rng(2)
    v = 32
    jr = _rollouts(JRollout, rng, v=v)
    tr = [Rollout(**dataclasses.asdict(r)) for r in jr]
    rows = [rng.normal(size=(len(r.generated_ids), v)).astype(np.float32)
            for r in jr]
    jsc = [jscore.Score(reward=0.1 * i, teacher_logprobs=x)
           for i, x in enumerate(rows)]
    for as_tensor in (False, True):
        tsc = [tscore.Score(reward=0.1 * i, teacher_logprobs=(
            torch.from_numpy(x) if as_tensor else x))
            for i, x in enumerate(rows)]
        want = jloop.pack_rollouts(jr, jsc, pad_to=8, vocab_size=v,
                                   with_teacher=True)
        got = tloop.pack_rollouts(tr, tsc, pad_to=8, vocab_size=v,
                                  with_teacher=True)
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(np.asarray(got[k]), want[k]), k
    with pytest.raises(ValueError, match="pad_to"):
        tloop.pack_rollouts(tr, tsc, pad_to=4)
    with pytest.raises(ValueError, match="teacher_logprobs"):
        tloop.pack_rollouts(tr, [tscore.Score(0.0)] * 4, pad_to=8,
                            vocab_size=v, with_teacher=True)


def _batch(rng, v, b=4, s=16):
    prompt = np.array([2, 3, 4, 1], np.int32)[:b]
    total = np.array([10, 16, 4, 7], np.int32)[:b]      # one empty
    tokens = rng.integers(3, v, (b, s)).astype(np.int32)
    tokens[np.arange(s)[None, :] >= total[:, None]] = 0
    return {"tokens": tokens, "prompt_lens": prompt, "total_lens": total,
            "rewards": rng.random(b).astype(np.float32),
            "group_ids": np.array([0, 0, 1, 1], np.int32)[:b],
            "teacher_logprobs": np.array(jax.nn.log_softmax(
                rng.normal(size=(b, s, v)).astype(np.float32), -1))}


@pytest.mark.parametrize("objective,baseline,lora", [
    ("reinforce", "batch", True), ("reinforce", "group", False),
    ("distill_kl", "none", True)])
def test_one_post_step_matches_jax(models, objective, baseline, lora):
    jb, jparams, tb, _ = models
    jbundle, tbundle = jb, tb
    if lora:
        jbundle = jlora.lora_bundle(jb, rank=4, targets=TARGETS)
        tbundle = tlora.lora_bundle(tb, rank=4, targets=TARGETS)
    jt = jstep.Trainer(bundle=jbundle, optimizer=jopt.adamw_cosine(1e-2),
                       lora_only=lora, guard_policy="skip")
    jstate = jt.init_state(0)
    if lora:    # adapters that already moved: B = 0 gives A no gradient
        rng = np.random.default_rng(5)
        jstate = dataclasses.replace(jstate, params={
            **jstate.params, "lora": jax.tree.map(
                lambda x: jnp.asarray(rng.normal(0, 0.05, x.shape),
                                      jnp.float32),
                jstate.params["lora"])})
        jstate = jt.init_state_from_params(jstate.params, 0)
    start = _to_torch(jstate.params)
    tt = tstep.Trainer(bundle=tbundle, optimizer=topt.adamw_cosine(1e-2),
                       lora_only=lora, guard_policy="skip", device="cpu")
    tstate = tt.init_state_from_params(start, 0)
    batch = _batch(np.random.default_rng(3), tb.config.vocab_size)
    jfn = jstep.make_post_step(jt, objective=objective, baseline=baseline)
    jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tfn = tstep.make_post_step(tt, objective=objective, baseline=baseline)
    tstate, tm = tfn(tstate, batch)
    assert tm.keys() == jm.keys()
    for k in ("loss", "reward_mean", "advantage_std", "post_tokens",
              "post_logprob_mean", "notfinite") + (() if lora
                                                  else ("grad_norm",)):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   atol=LOSS_TOL, err_msg=k)
    want = dict(named_leaves(jax.tree.map(np.asarray, jstate.params)))
    for path, t in named_leaves(tstate.params):
        np.testing.assert_allclose(t.detach().numpy(), want[path], rtol=0,
                                   atol=PARAM_TOL, err_msg=path)
        if lora and path.startswith("base/"):
            assert torch.equal(t, dict(named_leaves(start))[path]), path
    assert tstate.step == 1


def test_make_post_step_refusals(models):
    _, _, tb, _ = models
    tt = tstep.Trainer(bundle=tb, optimizer=topt.adamw_cosine(1e-3),
                       device="cpu")
    with pytest.raises(ValueError, match="objective"):
        tstep.make_post_step(tt, objective="ppo")
    with pytest.raises(ValueError, match="baseline"):
        tstep.make_post_step(tt, baseline="median")
    tt.attn_impl = lambda *a, **k: None
    with pytest.raises(ValueError, match="callable"):
        tstep.make_post_step(tt)
    assert tstep.POST_OBJECTIVES == jstep.POST_OBJECTIVES
    assert tstep.POST_BASELINES == jstep.POST_BASELINES


def test_jit_merge_and_qlora_base_match_jax(models):
    jb, jparams, tb, tparams = models
    jw = jlora.lora_bundle(jb, rank=4, targets=TARGETS)
    tw = tlora.lora_bundle(tb, rank=4, targets=TARGETS)
    jp = jw.init(jw.config, jax.random.key(1))
    rng = np.random.default_rng(4)
    jp = {**jp, "lora": jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0, 0.1, x.shape), jnp.float32),
        jp["lora"])}
    merge = tlora.jit_merge(tw)
    got = merge(from_jax.lora_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    want = dict(named_leaves(jax.tree.map(np.asarray,
                                          jlora.jit_merge(jw)(jp))))
    assert [p for p, _ in named_leaves(got)] == list(want)
    for path, t in named_leaves(got):
        assert t.dtype == tparams_dtype(tparams, path)
        np.testing.assert_allclose(t.numpy(), want[path], rtol=0, atol=1e-6,
                                   err_msg=path)
    with pytest.raises(ValueError, match="lora_bundle"):
        tlora.jit_merge(tb)
    snapped = tloop.qlora_base(tparams)
    jsnapped = dict(named_leaves(jax.tree.map(np.asarray,
                                              jloop.qlora_base(jparams))))
    for path, t in named_leaves(snapped):
        np.testing.assert_allclose(t.numpy(), jsnapped[path], rtol=0,
                                   atol=1e-6, err_msg=path)
    again = tloop.qlora_base(snapped)         # idempotent on its grid
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(named_leaves(again), named_leaves(snapped)))


def tparams_dtype(tparams, path):
    return dict(named_leaves(tparams))[path].dtype


@pytest.mark.parametrize("kind", ["teacher", "reward_model"])
def test_scorers_match_jax(models, kind):
    jb, jparams, tb, tparams = models
    rng = np.random.default_rng(6)
    jr = _rollouts(JRollout, rng, b=3, v=500)
    tr = [Rollout(**dataclasses.asdict(r)) for r in jr]
    jcls, tcls = {"teacher": (jscore.TeacherScorer, tscore.TeacherScorer),
                  "reward_model": (jscore.RewardModelScorer,
                                   tscore.RewardModelScorer)}[kind]
    want = jcls(jb, jparams).score(jr)
    got = tcls(tb, tparams).score(tr)
    np.testing.assert_allclose([s.reward for s in got],
                               [s.reward for s in want], rtol=0,
                               atol=LOGIT_TOL)
    for g, w in zip(got, want):
        if kind == "teacher":
            np.testing.assert_allclose(g.teacher_logprobs.numpy(),
                                       w.teacher_logprobs, rtol=0,
                                       atol=LOGIT_TOL)
        else:
            assert g.teacher_logprobs is None


def _counters(opt) -> int:
    return sum(t.numel() * t.element_size() for p in opt.state
               for t in topt.state_slots(opt, p).values() if t.ndim == 0)


@pytest.mark.parametrize("lora", [True, False])
def test_price_post_colocation_equals_jax(models, lora):
    jb, _, tb, _ = models
    jbundle = jlora.lora_bundle(jb, rank=4) if lora else jb
    tbundle = tlora.lora_bundle(tb, rank=4) if lora else tb
    jt = jstep.Trainer(bundle=jbundle, optimizer=jopt.adamw_cosine(1e-3),
                       lora_only=lora)
    tt = tstep.Trainer(bundle=tbundle, optimizer=topt.adamw_cosine(1e-3),
                       lora_only=lora, device="cpu")
    kw = dict(n_slots=4, max_len=64, page_size=16)
    extra = dict(weight_dtype="int8", teacher_bundle=None) if lora else {}
    want = jpre.price_post_colocation(
        jt, **kw, **({**extra, "teacher_bundle": jb} if lora else {}))
    got = tpre.price_post_colocation(
        tt, **kw, **({**extra, "teacher_bundle": tb} if lora else {}))
    jcount = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(
        jax.eval_shape(jt.optimizer.init, jt.param_shapes)) if x.ndim == 0)
    meta = dataclasses.replace(tt, device="meta")
    tcount = _counters(meta.init_state(0).opt_state.optimizer)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if k in ("policy_opt_state_bytes", "total_bytes"):
            g, w = g - tcount, w - jcount
        assert g == w, k
    with pytest.raises(ValueError, match="budget"):
        tpre.price_post_colocation(tt, **kw, budget_bytes=1)
    ok = tpre.price_post_colocation(tt, **kw,
                                    budget_bytes=got["total_bytes"] + 1)
    assert ok["total_bytes"] <= got["total_bytes"]
