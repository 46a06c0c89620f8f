"""The port's 1F1B pipeline against the JAX package's, in one process.

The port runs every stage in this process (``parallel/pipeline.py:
make_pipeline_value_and_grad``: a ``LocalExchange`` swaps the activations
downstream and the cotangents upstream after each tick); the JAX reference
is the function JAX's ``make_pipeline_value_and_grad`` computes, its
single-device mean of the microbatch means and its grads, one jitted
program per case built once per module (the JAX package's
``tests/test_pipeline.py`` holds its pipeline to it for each family and
at pp 4; a JAX pipeline compile per case cost the tier-1 run more CPU than
the port's pipeline itself): llama-debug, gpt2-debug and neox-debug at pp 2
and llama-debug cut to 4 layers at pp 4. The same weights (JAX's init
carried across by ``models/from_jax.py``) and batch (B 8, S 32 from a
numpy seed), fp32. The loss (the mean of the microbatch means) to rtol 2e-4
and every grad to rtol 1e-4 (atol 1e-6). Also: the loss and grads equal
the single-device mean of the microbatch means, and JAX's refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.ops.cross_entropy import (
    causal_lm_loss as jcausal_lm_loss)
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.ops.cross_entropy import (
    causal_lm_loss)
from distributed_training_guide_tpu_torch.parallel import pipeline as tpipe
from distributed_training_guide_tpu_torch.train.state import named_leaves
import torch_threads  # noqa: F401  (one torch thread a test process)

GB, SEQ = 8, 32
LOSS_RTOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# (id, model, pp, model overrides)
CASES = [("llama-pp2", "llama-debug", 2, {}),
         ("gpt2-pp2", "gpt2-debug", 2, {}),
         ("neox-pp2", "neox-debug", 2, {}),
         ("llama-pp4", "llama-debug", 4, {"num_layers": 4})]


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _ids():
    return np.random.RandomState(0).randint(0, 512, (GB, SEQ))


@pytest.fixture(scope="module")
def jax_refs():
    ids = jnp.asarray(_ids())
    refs = {}
    for name, model, pp, over in CASES:
        bundle = jget_model(model, dtype=jnp.float32, **over)
        params = bundle.init(bundle.config, jax.random.key(0))
        vag = jax.jit(jax.value_and_grad(
            lambda p, b, bundle=bundle, m=2 * pp: _mean_of_means(
                bundle, p, b["input_ids"], m)))
        loss, grads = vag(params, {"input_ids": ids, "labels": ids})
        refs[name] = (_flatten(jax.tree.map(np.asarray, params)),
                      float(loss), _flatten(jax.tree.map(np.asarray, grads)))
    return refs


def _mean_of_means(bundle, params, ids, m):
    """JAX's single-device mean over ``m`` microbatches of each one's mean
    next-token loss."""
    rows = ids.reshape(m, -1, ids.shape[-1])
    return sum(jcausal_lm_loss(bundle.apply(bundle.config, params, r), r)
               for r in rows) / m


def _port_params(flat):
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return from_jax.params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("name,model,pp,over", CASES,
                         ids=[c[0] for c in CASES])
def test_pipeline_matches_jax(jax_refs, name, model, pp, over):
    jparams, jloss, jgrads = jax_refs[name]
    bundle = get_model(model, dtype=torch.float32, **over)
    params = _port_params(jparams)
    ids = torch.from_numpy(_ids())
    vag = tpipe.make_pipeline_value_and_grad(bundle, pp=pp)
    assert vag.pipeline.M == 2 * pp
    loss, grads = vag(params, {"input_ids": ids, "labels": ids})
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    got = dict(named_leaves(grads))
    assert set(got) == set(jgrads)
    for path, want in jgrads.items():
        np.testing.assert_allclose(got[path].numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=path)


def test_pipeline_equals_the_mean_of_microbatch_means():
    """pp 2 over M 4: the loss and grads of the single-device forward on
    each microbatch, averaged, to fp32 summation order."""
    bundle = get_model("llama-debug", dtype=torch.float32)
    params = bundle.init(bundle.config, 0, device="cpu")
    ids = torch.from_numpy(_ids())
    loss, grads = tpipe.make_pipeline_value_and_grad(bundle, pp=2)(
        params, {"input_ids": ids, "labels": ids})
    leaves = dict(named_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    want = 0.0
    for m in range(4):
        rows = ids[2 * m:2 * m + 2]
        mb_loss = causal_lm_loss(bundle.apply(bundle.config, params, rows),
                                 rows) / 4
        mb_loss.backward()
        want += float(mb_loss.detach())
    np.testing.assert_allclose(float(loss), want, rtol=1e-6)
    for path, g in named_leaves(grads):
        torch.testing.assert_close(g, leaves[path].grad, rtol=1e-5,
                                   atol=1e-7)


def _jax_moe_mean_of_means(dispatch):
    """JAX's single-device mean over 4 microbatches of ce + aux (moe-debug,
    router_aux_coef 1, ``apply_with_aux``'s mean over layers) and its
    grads under ``jax.value_and_grad``: what JAX's pipeline computes with
    its aux scaling (``aux_coef / n_layers`` into each microbatch loss,
    ``aux_coef / (M n_layers tp)`` as the aux cotangent's seed)."""
    bundle = jget_model("moe-debug", dtype=jnp.float32, router_aux_coef=1.0,
                        moe_dispatch=dispatch)
    cfg = bundle.config
    params = bundle.init(cfg, jax.random.key(0))

    def loss_fn(p, ids):
        rows = ids.reshape(4, -1, ids.shape[-1])
        total = 0.0
        for r in rows:
            logits, aux = bundle.apply_with_aux(cfg, p, r)
            total = (total + jcausal_lm_loss(logits, r)
                     + cfg.router_aux_coef * aux)
        return total / 4

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params,
                                                       jnp.asarray(_ids()))
    return (_flatten(jax.tree.map(np.asarray, params)), float(loss),
            _flatten(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
def test_moe_pipeline_equals_the_mean_of_microbatch_means_with_aux(dispatch):
    """moe-debug at pp 2 over M 4, router_aux_coef 1: the loss is the mean
    over microbatches of ce + aux (each stage adds its layers' aux / L) and
    the grads, the router's aux path among them, match JAX's single-device
    mean of microbatch means (loss rtol 2e-4, grads rtol 1e-4) and equal
    those of the port's own per-microbatch losses to fp32 summation
    order."""
    jparams, jloss, jgrads = _jax_moe_mean_of_means(dispatch)
    bundle = get_model("moe-debug", dtype=torch.float32,
                       router_aux_coef=1.0, moe_dispatch=dispatch)
    cfg = bundle.config
    params = _port_params(jparams)
    ids = torch.from_numpy(_ids())
    loss, grads = tpipe.make_pipeline_value_and_grad(bundle, pp=2)(
        params, {"input_ids": ids, "labels": ids})
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    got = dict(named_leaves(grads))
    assert set(got) == set(jgrads)
    for path, want in jgrads.items():
        np.testing.assert_allclose(got[path].numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=path)
    leaves = dict(named_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    want = 0.0
    for m in range(4):
        rows = ids[2 * m:2 * m + 2]
        logits, aux = bundle.apply_with_aux(cfg, params, rows)
        mb_loss = (causal_lm_loss(logits, rows) + aux) / 4
        mb_loss.backward()
        want += float(mb_loss.detach())
    np.testing.assert_allclose(float(loss), want, rtol=1e-6)
    for path, g in named_leaves(grads):
        torch.testing.assert_close(g, leaves[path].grad, rtol=1e-5,
                                   atol=1e-7)


def test_pipeline_refusals():
    with pytest.raises(ValueError, match="not divisible by pp"):
        tpipe.make_pipeline_value_and_grad(
            get_model("llama-debug", dtype=torch.float32), pp=4)
    with pytest.raises(ValueError, match="layer_windows"):
        tpipe.make_pipeline_value_and_grad(
            get_model("llama-debug", dtype=torch.float32,
                      layer_windows=(8, 0)), pp=2)
    # a mixture of experts runs under pp (ported): its stages carry the aux
    assert tpipe.make_pipeline_value_and_grad(get_model("moe-debug"),
                                              pp=2).pipeline.moe
    bundle = get_model("llama-debug", dtype=torch.float32)
    params = bundle.init(bundle.config, 0, device="cpu")
    ids = torch.from_numpy(_ids())
    vag = tpipe.make_pipeline_value_and_grad(bundle, pp=2, microbatches=3)
    with pytest.raises(ValueError, match="microbatches=3"):
        vag(params, {"input_ids": ids, "labels": ids})
    pipe = tpipe.Pipeline(bundle, tpipe.LocalExchange(2), microbatches=4,
                          data_size=4)
    stages = tpipe.virtual_stages(params, 2)
    with pytest.raises(ValueError, match="data-parallel size 4"):
        pipe.value_and_grad(stages, ids[:2], ids[:2])
