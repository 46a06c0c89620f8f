"""The port's rules table against the JAX package's, in one process.

For every strategy of ``STRATEGIES`` but the pipeline and expert ones, on
mesh shapes that divide the model's dims and on ones that do not (where a
dim falls back to replication), and for llama-debug and llama-3.2-1b's
config (shapes only, nothing allocated): the port's ``spec_for_leaf``
equals JAX's, leaf for leaf, for the params and for the ZeRO optimizer
state. Also: the logical-axes trees and the param shapes equal JAX's, the
refusals name their ROADMAP items, each rank's loader rows are its slice
of the JAX loader's global batch, and the vocab-parallel loss with no
group is the plain loss, its value and gradient bit for bit."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.data import loader as jloader
from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.models import llama as jllama
from distributed_training_guide_tpu.ops import cross_entropy as jce
from distributed_training_guide_tpu.parallel import plans as jplans
from distributed_training_guide_tpu_torch.data import BatchLoader
from distributed_training_guide_tpu_torch.models import llama as tllama
from distributed_training_guide_tpu_torch.ops import cross_entropy as tce
from distributed_training_guide_tpu_torch.ops import vocab_parallel as tvp
from distributed_training_guide_tpu_torch.parallel import mesh as tmesh
from distributed_training_guide_tpu_torch.parallel import plans as tplans
from distributed_training_guide_tpu_torch.train.state import named_leaves

LAYOUT_STRATEGIES = [s for s in jplans.STRATEGIES
                     if not s.startswith(("pp", "ep"))]
# mesh axis sizes; 3, 6 and 12 divide none of llama-debug's 64 / 128 / 512
# widths, 5 none of llama-3.2-1b's
MESHES = [{"fsdp": 8}, {"tp": 4}, {"fsdp": 2, "tp": 2}, {"dp": 2, "fsdp": 4},
          {"tp": 8}, {"fsdp": 3}, {"tp": 3}, {"dp": 2, "fsdp": 3, "tp": 2},
          {"fsdp": 6, "tp": 2}, {"tp": 12}, {"fsdp": 5, "tp": 2}]
MODELS = ["llama-debug", "llama-3.2-1b"]


def _sizes(mesh_kw):
    return {a: int(mesh_kw.get(a, 1)) for a in tmesh.AXIS_NAMES}


def _jax_shapes(name):
    jb = jget_model(name)
    tree = jax.eval_shape(lambda k: jb.init(jb.config, k), jax.random.key(0))
    return jax.tree.map(lambda s: tuple(s.shape), tree), jb.config


def _flat(tree):
    return dict(named_leaves(tree))


@pytest.mark.parametrize("name", MODELS)
def test_logical_axes_and_shapes_equal_jax(name):
    jshapes, jcfg = _jax_shapes(name)
    tcfg = tllama.PRESETS[name]
    assert tllama.param_logical_axes(tcfg) == jllama.param_logical_axes(jcfg)
    assert _flat(tllama.param_shapes(tcfg)) == {
        k: tuple(v) for k, v in _flat(jshapes).items()}


@pytest.mark.parametrize("preset", ["qwen2.5-0.5b", "qwen3-0.6b",
                                    "olmo2-7b", "gemma2-2b", "llama-3.1-8b"])
def test_logical_axes_of_the_variants_equal_jax(preset):
    """Biases, per-head and flat q / k norms, sandwich and post norms, an
    untied head: every config flag's leaves get JAX's names."""
    jcfg = jget_model(preset).config
    assert tllama.param_logical_axes(tllama.PRESETS[preset]) == \
        jllama.param_logical_axes(jcfg)


def test_rules_tables_equal_jax():
    assert tplans.STRATEGIES == jplans.STRATEGIES
    assert tplans.ZERO1_RULES == jplans.ZERO1_RULES
    assert tmesh.AXIS_NAMES == ("dp", "pp", "fsdp", "ep", "tp", "cp")


@pytest.mark.parametrize("mesh_kw", MESHES,
                         ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("strategy", LAYOUT_STRATEGIES)
@pytest.mark.parametrize("name", MODELS)
def test_spec_for_leaf_equals_jax(name, strategy, mesh_kw):
    sizes = _sizes(mesh_kw)
    jmesh = types.SimpleNamespace(shape=sizes)   # all spec_for_leaf reads
    jshapes, jcfg = _jax_shapes(name)
    axes = _flat(jllama.param_logical_axes(jcfg))
    shapes = _flat(jshapes)
    zero = {**jplans.STRATEGIES[strategy], **jplans.ZERO1_RULES}
    for rules in (jplans.STRATEGIES[strategy], zero):
        for path, ax in axes.items():
            want = tuple(jplans.spec_for_leaf(jmesh, ax, shapes[path], rules))
            got = tplans.spec_for_leaf(sizes, ax, shapes[path], rules)
            assert got == want, (path, got, want)


def test_plan_specs_follow_the_rules_and_fall_back_where_indivisible():
    plan = tplans.ShardingPlan(mesh=_sizes({"fsdp": 3, "tp": 2}),
                               strategy="tp_fsdp",
                               rules=tplans.STRATEGIES["tp_fsdp"])
    cfg = tllama.PRESETS["llama-debug"]
    specs = _flat(plan.param_specs(tllama.param_logical_axes(cfg),
                                   tllama.param_shapes(cfg)))
    assert specs["layers/attn/wq"] == (None, None, "tp")  # 64 % 3: replicated
    assert specs["embed/embedding"] == ("tp",)
    assert specs["layers/input_norm"] == ()
    assert plan.data_parallel_size == 3 and plan.size() == 6
    assert plan.logits_sharding() == (("dp", "fsdp", "ep"), None, "tp")
    assert plan.activation_sharding() == (("dp", "fsdp", "ep"), None, None)


@pytest.mark.parametrize("strategy", ["ddp", "zero1", "zero2", "fsdp",
                                      "tp_fsdp"])
def test_batch_and_grad_layouts_equal_jax(strategy):
    """The batch spec, the data axes and ZeRO-2's persistent grad layout
    (the optimizer state's) against JAX's plan on the same mesh shape."""
    sizes = _sizes({"dp": 2, "fsdp": 2, "tp": 2})
    jplan = jplans.make_plan(strategy, types.SimpleNamespace(shape=sizes))
    tplan = tplans.make_plan(strategy, sizes)
    assert tplan.data_axes == jplan.data_axes
    assert tplan.data_parallel_size == jplan.data_parallel_size == 4
    for ndim in (1, 2, 3):
        assert tplan.batch_spec(ndim) == tuple(jplan.batch_spec(ndim))
    assert tplan.optimizer_state_rules() == jplan.optimizer_state_rules()
    cfg = tllama.PRESETS["llama-debug"]
    axes, shapes = (tllama.param_logical_axes(cfg),
                    tllama.param_shapes(cfg))
    want = tplan.optimizer_state_specs(axes, shapes) if jplan.zero2 else \
        tplan.param_specs(axes, shapes)
    assert tplan.grad_shardings(axes, shapes) == want


@pytest.mark.parametrize("strategy,item", [
    ("pp", "Context parallel, pipeline parallel and overlap"),
    ("pp_tp_fsdp", "Context parallel, pipeline parallel and overlap"),
    ("ep", "Expert parallelism"), ("ep_fsdp", "Expert parallelism")])
def test_make_plan_refuses_pipeline_and_expert_strategies(strategy, item):
    with pytest.raises(NotImplementedError, match=item):
        tplans.make_plan(strategy, _sizes({}))


def test_make_plan_refuses_context_parallelism():
    with pytest.raises(NotImplementedError, match="Context parallel"):
        tplans.make_plan("tp", _sizes({"cp": 2}))
    plan = tplans.make_plan("zero2", _sizes({"dp": 4}))
    assert plan.zero1 and plan.zero2 and not plan.sequence_sharded
    assert tplans.make_plan("tp", _sizes({"tp": 2})).sequence_sharded


def test_mesh_shape_for_equals_jax():
    from distributed_training_guide_tpu.parallel import mesh as jmesh

    for kw in MESHES:
        n = int(np.prod(list(kw.values())))
        assert tmesh.mesh_shape_for(n, **kw) == jmesh.mesh_shape_for(n, **kw)
    with pytest.raises(ValueError):
        tmesh.mesh_shape_for(6, tp=4)


@pytest.mark.parametrize("accum", [1, 2])
def test_each_rank_loads_its_rows_of_the_jax_global_batch(accum):
    """The JAX loader's global batch (one device holds it whole) against
    the port's loader on each of 4 data ranks: rank r's rows are the r-th
    quarter of every microbatch's rows."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    data = np.random.default_rng(0).integers(0, 512, (64, 16)).astype(
        np.int32)
    mesh1 = Mesh(np.asarray(jax.devices()[:1]).reshape(1), ("x",))
    jl = jloader.ShardedBatchLoader(data, 16, NamedSharding(mesh1, P()),
                                    grad_accum=accum, seed=3)
    jl.set_epoch(1)
    jb = [np.asarray(b["input_ids"]) for b in jl.epoch_batches(start_step=1)]
    for r in range(4):
        tl = BatchLoader(data, 16, device="cpu", grad_accum=accum, seed=3,
                         data_rank=r, data_size=4)
        tl.set_epoch(1)
        tb = [b["input_ids"].numpy() for b in tl.epoch_batches(start_step=1)]
        assert len(tb) == len(jb) == 3
        n = 16 // accum // 4
        for t, j in zip(tb, jb):
            np.testing.assert_array_equal(t, j[..., n * r:n * (r + 1), :])


def test_vocab_parallel_loss_without_a_group_is_the_plain_loss():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 9, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 9))
    labels[0, 4:] = -100
    want = float(jce.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    leaf = tl.clone().requires_grad_()
    got = tvp.vocab_parallel_causal_lm_loss(leaf, tlab, None, 0)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    got.backward()
    plain = tl.clone().requires_grad_()
    loss = tce.causal_lm_loss(plain, tlab)
    loss.backward()
    assert torch.equal(got, loss) and torch.equal(leaf.grad, plain.grad)
    np.testing.assert_allclose(float(tce.causal_lm_loss(tl, tlab)), want,
                               rtol=1e-6)
    nll, count = tce.nll_and_count(tl[:, :-1], tlab[:, 1:])
    np.testing.assert_allclose(float(tce.global_mean_loss(nll, count, [])),
                               want, rtol=1e-6)
    table = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 40, (2, 9)))
    assert torch.equal(tvp.vocab_parallel_embed(table, ids, None, 0),
                       table[ids])
