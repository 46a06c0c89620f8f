"""The port's 1F1B pipeline against the JAX package's, in one process.

The port runs every stage in this process (``parallel/pipeline.py:
make_pipeline_value_and_grad``: a ``LocalExchange`` swaps the activations
downstream and the cotangents upstream after each tick); the JAX reference
is ``make_pipeline_value_and_grad`` on the 8-device CPU mesh's first pp
devices, built once per module. The same weights (JAX's init carried
across by ``models/from_jax.py``) and batch (B 8, S 32 from a numpy seed),
fp32: pp 2 on llama-debug, gpt2-debug and neox-debug, pp 4 on llama-debug
cut to 4 layers. The loss (the mean of the microbatch means) to rtol 2e-4
and every grad to rtol 1e-4 (atol 1e-6). Also: the loss and grads equal
the single-device mean of the microbatch means, and JAX's refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.parallel import make_mesh as jmake_mesh
from distributed_training_guide_tpu.parallel import make_plan as jmake_plan
from distributed_training_guide_tpu.parallel.pipeline import (
    make_pipeline_value_and_grad as jmake_pipeline)
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.ops.cross_entropy import (
    causal_lm_loss)
from distributed_training_guide_tpu_torch.parallel import pipeline as tpipe
from distributed_training_guide_tpu_torch.train.state import named_leaves

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
        plan = jmake_plan("pp", jmake_mesh(devices=jax.devices()[:pp], pp=pp))
        vag = jax.jit(jmake_pipeline(bundle, plan))
        loss, grads = vag(params, {"input_ids": ids, "labels": ids})
        refs[name] = (_flatten(jax.tree.map(np.asarray, params)),
                      float(loss), _flatten(jax.tree.map(np.asarray, grads)))
    return refs


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


def test_pipeline_refusals():
    with pytest.raises(ValueError, match="not divisible by pp"):
        tpipe.make_pipeline_value_and_grad(
            get_model("llama-debug", dtype=torch.float32), pp=4)
    with pytest.raises(ValueError, match="layer_windows"):
        tpipe.make_pipeline_value_and_grad(
            get_model("llama-debug", dtype=torch.float32,
                      layer_windows=(8, 0)), pp=2)
    with pytest.raises(NotImplementedError, match="Expert parallelism"):
        tpipe.make_pipeline_value_and_grad(get_model("moe-debug"), pp=2)
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
