"""The port's remat policies (``ops/remat.py``) on the CPU: under each
policy the loss and grads of llama-debug (einsum and flash attention;
moe-debug's dense and ragged dispatch in ``tests/test_torch_remat_moe.py``)
are bitwise equal to the port's step without remat (recomputation replays the same CPU arithmetic), and
within 1e-4 of the JAX package's under the same policy; the plain flash
forward runs once per layer without remat and under "attn" / "attn_mlp"
(its (o, lse) are kept), twice under "all" and "dots". Weights cross by
the weight bridge; inputs are made with numpy from a seed."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.ops import cross_entropy as jce
from distributed_training_guide_tpu.train.step import (
    REMAT_POLICIES as JREMAT)
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.ops import cross_entropy as tce
from distributed_training_guide_tpu_torch.ops import flash_attention as tfa
from distributed_training_guide_tpu_torch.ops import remat as tremat
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train.state import named_leaves
from distributed_training_guide_tpu_torch.train.step import Trainer
import torch_threads  # noqa: F401  (one torch thread a test process)

GRAD_TOL = 1e-4   # of each leaf's largest gradient: two fp32 layers
POLICIES = ["all", "dots", "attn", "attn_mlp"]


@functools.lru_cache(maxsize=None)
def _bridged(name: str, dispatch: str = None):
    over = {} if dispatch is None else {"moe_dispatch": dispatch}
    jb = jget_model(name, dtype=jnp.float32, **over)
    jparams = jb.init(jb.config, jax.random.key(0))
    tb = get_model(name, dtype=torch.float32, **over)
    tparams = from_jax.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         device="cpu")
    return jb, jparams, tb, tparams


def _ids(vocab: int):
    return np.random.default_rng(0).integers(0, vocab, (2, 16)).astype(
        np.int32)


def _torch_loss_grads(tb, tparams, ids, **kw):
    params = jax.tree.map(lambda t: t.detach().clone().requires_grad_(True),
                          tparams)
    tids = torch.from_numpy(ids).long()
    cfg = tb.config
    if tb.apply_with_aux is not None:
        out, aux = tb.apply_with_aux(cfg, params, tids, **kw)
        loss = tce.causal_lm_loss(out, tids) + cfg.router_aux_coef * aux
    else:
        loss = tce.causal_lm_loss(tb.apply(cfg, params, tids, **kw), tids)
    loss.backward()
    return loss.detach(), {path: p.grad for path, p in named_leaves(params)}


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(model, dispatch, policy):
    """JAX's loss and grads under ``policy`` (einsum attention: the flash
    path's plain version computes the same function)."""
    jb, jparams, tb, _ = _bridged(model, dispatch)
    ids = _ids(tb.config.vocab_size)
    cfg = jb.config

    def loss_fn(p):
        kw = dict(remat=True, remat_policy=JREMAT[policy], attn_impl="xla")
        if jb.apply_with_aux is not None:
            out, aux = jb.apply_with_aux(cfg, p, jnp.asarray(ids), **kw)
            return (jce.causal_lm_loss(out, jnp.asarray(ids))
                    + cfg.router_aux_coef * aux)
        return jce.causal_lm_loss(jb.apply(cfg, p, jnp.asarray(ids), **kw),
                                  jnp.asarray(ids))

    loss, grads = jax.value_and_grad(loss_fn)(jparams)
    flat = named_leaves(jax.tree.map(np.asarray, grads))
    return float(loss), dict(flat)


def check_policy(model, dispatch, attn_impl, policy):
    """The port's loss and grads under ``policy``: bitwise the step without
    remat, and within GRAD_TOL of JAX's under the same policy."""
    _, _, tb, tparams = _bridged(model, dispatch)
    ids = _ids(tb.config.vocab_size)
    loss0, grads0 = _torch_loss_grads(tb, tparams, ids, attn_impl=attn_impl)
    loss, grads = _torch_loss_grads(tb, tparams, ids, attn_impl=attn_impl,
                                    remat=True, remat_policy=policy)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    for k in grads:
        assert torch.equal(grads[k], grads0[k]), k
    jloss, jgrads = _jax_loss_grads(model, dispatch, policy)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    for k, g in grads.items():
        want = jgrads[k]
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)


# moe-debug's cases are in tests/test_torch_remat_moe.py
MODELS = [("llama-debug", None, "xla"), ("llama-debug", None, "flash")]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model,dispatch,attn_impl", MODELS,
                         ids=lambda x: str(x))
def test_policy_is_bitwise_the_remat_free_step_and_near_jax(
        model, dispatch, attn_impl, policy):
    check_policy(model, dispatch, attn_impl, policy)


@pytest.mark.parametrize("policy,per_layer", [
    (None, 1), ("all", 2), ("dots", 2), ("attn", 1), ("attn_mlp", 1)])
def test_flash_forward_runs_per_policy(monkeypatch, policy, per_layer):
    """Counting the plain flash forward (what the CPU runs for K1): "attn"
    and "attn_mlp" keep its (o, lse), so backward does not run it again."""
    calls = []
    plain = tfa.flash_attention_reference

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(tfa, "flash_attention_reference", counted)
    _, _, tb, tparams = _bridged("llama-debug")
    _torch_loss_grads(tb, tparams, _ids(tb.config.vocab_size),
                      attn_impl="flash", remat=policy is not None,
                      remat_policy=policy)
    assert len(calls) == per_layer * tb.config.num_layers


def test_policy_table_and_refusals():
    assert set(tremat.REMAT_POLICIES) == set(JREMAT)
    assert tremat.resolve_remat_policy("all") is None
    with pytest.raises(ValueError, match="remat_policy"):
        tremat.resolve_remat_policy("everything")
    with pytest.raises(ValueError, match="remat_policy"):
        Trainer(bundle=get_model("llama-debug"),
                optimizer=topt.adamw_cosine(1e-3), remat=True,
                remat_policy="everything", device="cpu")


def test_named_scope_marks_only_its_operations():
    with tremat.checkpoint_name("a"):
        with tremat.checkpoint_name("b"):
            assert tremat.active_names() == {"a", "b"}
        assert tremat.active_names() == {"a"}
    assert tremat.active_names() == frozenset()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_attn_policy_saves_only_the_einsum_output(monkeypatch, dtype):
    """Under "attn" the einsum path saves exactly one tensor per layer:
    the [B, S, H, D] attention output in q's dtype (the JAX package tags
    that tensor alone), never the fp32 probabilities or products."""
    saved = []
    real = tremat._policy_fn

    def recording(policy):
        decide = real(policy)

        def record(ctx, op, *args, **kwargs):
            out = decide(ctx, op, *args, **kwargs)
            if (out == tremat.CheckpointPolicy.MUST_SAVE
                    and not ctx.is_recompute):
                saved.append((str(op), tuple(args[0].shape),
                              kwargs.get("dtype")))
            return out
        return record

    monkeypatch.setattr(tremat, "_policy_fn", recording)
    _, _, tb, tparams = _bridged("llama-debug")
    cfg = dataclasses.replace(tb.config, dtype=dtype)
    params = jax.tree.map(
        lambda t: t.detach().to(dtype).requires_grad_(True), tparams)
    ids = torch.from_numpy(_ids(cfg.vocab_size)).long()
    out = tb.apply(cfg, params, ids, remat=True, remat_policy="attn",
                   attn_impl="xla")
    tce.causal_lm_loss(out, ids).backward()
    b, s = ids.shape
    one = ("aten._to_copy.default", (b, s, cfg.num_heads, cfg.head_size),
           dtype)
    assert saved == [one] * cfg.num_layers, saved
