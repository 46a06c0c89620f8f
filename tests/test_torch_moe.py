"""The port's MoE family against the JAX package's on the CPU, at
moe-debug size (and a variant with per-head qk-norm, QKV biases, a shared
expert and un-normalized top-k weights), with weights carried across by
the weight bridge and inputs made with numpy: the routed FFN (top-k
indices asserted equal first), ``apply_with_aux`` under dense and ragged
dispatch, loss gradients, greedy serving against the JAX engine, a
3-step Trainer trajectory, the weight bridge, parameter counts and the
``--moe-dispatch`` flag. Each test states its bound."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.models import moe as jmoe
from distributed_training_guide_tpu.ops import cross_entropy as jce
from distributed_training_guide_tpu.serve import Request as JRequest
from distributed_training_guide_tpu.serve import ServeEngine as JEngine
from distributed_training_guide_tpu.serve.api import \
    generate_many as jgenerate
from distributed_training_guide_tpu.train import optimizer as jopt
from distributed_training_guide_tpu.train.step import Trainer as JTrainer
from distributed_training_guide_tpu_torch.models import (from_jax, get_model,
                                                         list_models)
from distributed_training_guide_tpu_torch.models import moe as tmoe
from distributed_training_guide_tpu_torch.ops import cross_entropy as tce
from distributed_training_guide_tpu_torch.ops import grouped_matmul as tgm
from distributed_training_guide_tpu_torch.serve import (Request, ServeEngine,
                                                        generate_many)
from distributed_training_guide_tpu_torch.train import cli as tcli
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train.step import Trainer
import torch_threads  # noqa: F401  (one torch thread a test process)

FFN_TOL = 1e-5      # one routed FFN in fp32: sums in another order
LOGIT_TOL = 1e-4    # two fp32 layers, norms and softmaxes in another order
GRAD_TOL = 1e-4     # of each leaf's largest gradient, two fp32 layers
VARIANTS = {
    "moe-debug": {},
    # Qwen2-MoE wiring on moe-debug's widths
    "qk-bias-shared": dict(qk_norm=True, attn_bias=True,
                           shared_expert_intermediate=32,
                           norm_topk_prob=False),
}


def _to_torch(tree):
    return from_jax.params_from_numpy(jax.tree.map(np.asarray, tree),
                                      device="cpu")


@functools.lru_cache(maxsize=None)
def _bridged(variant: str, dispatch: str = "dense"):
    over = dict(VARIANTS[variant], moe_dispatch=dispatch)
    jb = jget_model("moe-debug", dtype=jnp.float32, **over)
    jparams = jb.init(jb.config, jax.random.key(0))
    tb = get_model("moe-debug", dtype=torch.float32, **over)
    return jb, jparams, tb, _to_torch(jparams)


def _close(got, want, tol, err_msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=err_msg)


@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_ffn_matches_jax(variant, dispatch):
    """Layer 0's routed FFN on random activations: the top-k expert
    indices are equal (asserted first: torch.topk and lax.top_k could break
    ties differently), then the output within 1e-5 of its scale, the aux
    loss within 1e-5 relative and dropped_frac exactly (16 tokens x top-2
    over 4 experts at capacity factor 1.25: the dense path drops some)."""
    jb, jparams, tb, tparams = _bridged(variant, dispatch)
    x = np.random.default_rng(0).standard_normal((2, 8, 64)).astype(
        np.float32)
    jm = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    tm = {k: v[0] for k, v in tparams["layers"]["moe"].items()}
    k = jb.config.experts_per_token
    jidx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x).reshape(16, 64) @ jm["router"]), k)[1]
    tidx = torch.topk(torch.softmax(
        torch.from_numpy(x).reshape(16, 64) @ tm["router"], -1), k)[1]
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    jy, jaux, jdrop = jmoe._moe_ffn(jb.config, jnp.asarray(x), jm)
    ty, taux, tdrop = tmoe._moe_ffn(tb.config, torch.from_numpy(x), tm)
    _close(ty.numpy(), jy, FFN_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=FFN_TOL)
    assert tdrop.item() == float(jdrop)
    if dispatch == "dense" and variant == "moe-debug":
        assert float(jdrop) > 0
    if dispatch == "ragged":
        assert float(jdrop) == 0.0


@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_with_aux_matches_jax(variant, dispatch):
    """Logits (and the final hidden states) within 1e-4 of their scale,
    the mean aux loss within 1e-5 relative, dropped_frac exactly; remat
    gives the same logits bit for bit."""
    jb, jparams, tb, tparams = _bridged(variant, dispatch)
    ids = np.random.default_rng(1).integers(0, 512, (2, 16)).astype(np.int32)
    jlog, jaux, jmet = jmoe.apply_with_aux(jb.config, jparams,
                                           jnp.asarray(ids),
                                           return_metrics=True)
    tids = torch.from_numpy(ids)
    tlog, taux, tmet = tmoe.apply_with_aux(tb.config, tparams, tids,
                                           return_metrics=True)
    assert tlog.dtype == torch.float32 and tlog.shape == (2, 16, 512)
    _close(tlog.numpy(), jlog, LOGIT_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=FFN_TOL)
    assert (tmet["moe_dropped_frac"].item()
            == float(jmet["moe_dropped_frac"]))
    remat, _ = tmoe.apply_with_aux(tb.config, tparams, tids, remat=True)
    assert torch.equal(remat, tlog)
    jhid, _ = jmoe.apply_with_aux(jb.config, jparams, jnp.asarray(ids),
                                  return_hidden=True)
    thid, _ = tmoe.apply_with_aux(tb.config, tparams, tids,
                                  return_hidden=True)
    _close(thid.numpy(), jhid, LOGIT_TOL)


@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
def test_loss_grads_match_jax(dispatch):
    """d(ce + router_aux_coef * aux)/d(params), every leaf within 1e-4 of
    its largest gradient; under ragged the port's expert grads run the
    grouped-matmul Function's backward (plain K5 / K6 on the CPU), the
    JAX ones autodiff through its scan."""
    jb, jparams, tb, tparams = _bridged("qk-bias-shared", dispatch)
    ids = np.random.default_rng(2).integers(0, 512, (2, 16)).astype(np.int32)
    coef = jb.config.router_aux_coef

    def jloss(p):
        logits, aux = jmoe.apply_with_aux(jb.config, p, jnp.asarray(ids))
        return jce.causal_lm_loss(logits, jnp.asarray(ids)) + coef * aux

    jl, jg = jax.value_and_grad(jloss)(jparams)
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(), tparams)
    tids = torch.from_numpy(ids).long()
    logits, aux = tmoe.apply_with_aux(tb.config, tp, tids)
    tl = tce.causal_lm_loss(logits, tids) + coef * aux
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.grad, tp))[0])
    assert len(jflat) == len(tflat)
    for path, g in jflat:
        _close(tflat[path].numpy(), g, GRAD_TOL,
               err_msg=jax.tree_util.keystr(path))


SERVE_CASES = {
    "bucketed": dict(n_slots=3, page_size=4, max_len=32),
    "chunked": dict(n_slots=3, page_size=4, max_len=32, prefill_chunk=4),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_greedy_tokens_identical_to_jax_engine(case):
    """Six greedy requests through 3 slots: the port's engine (grouped
    GEMMs through the K5 wrapper's plain version) emits exactly the JAX
    engine's tokens, bucketed and chunked."""
    over = dict(capacity_factor=4.0)
    jb = jget_model("moe-debug", dtype=jnp.float32, **over)
    jparams = jb.init(jb.config, jax.random.key(0))
    tb = get_model("moe-debug", dtype=torch.float32, **over)
    tparams = _to_torch(jparams)
    rng = np.random.default_rng(3)
    specs = []
    for i in range(6):
        p = int(rng.integers(1, 13))
        specs.append(dict(prompt_ids=[int(x) for x in rng.integers(3, 500, p)],
                          max_new_tokens=int(rng.integers(2, 32 - p + 1)),
                          seed=i))
    kw = SERVE_CASES[case]
    jres = jgenerate(JEngine(jb, jparams, **kw),
                     [JRequest(**r) for r in specs], max_iterations=2000)
    teng = ServeEngine(tb, tparams, device="cpu", **kw)
    tres = generate_many(teng, [Request(**r) for r in specs],
                         max_iterations=2000)
    for j, t in zip(jres, tres):
        assert t.token_ids == j.token_ids
        assert t.finish_reason == j.finish_reason
    assert teng.decode_steps > 0


@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
def test_trainer_trajectory_matches_jax(dispatch):
    """3 fp32 steps of moe-debug from the same params and batches: loss
    and grad norm per step within 2e-5 relative, moe_dropped_frac equal
    (lr 1e-4: Adam's normalized update carries another summation order's
    grad differences only lr x 3 steps into the params)."""
    from distributed_training_guide_tpu.data import loader as jloader
    from distributed_training_guide_tpu.data import pipeline as jpipeline

    jb = jget_model("moe-debug", dtype=jnp.float32, moe_dispatch=dispatch)
    jt = JTrainer(bundle=jb, optimizer=jopt.adamw_cosine(1e-4))
    jstate = jt.init_state(0)
    tb = get_model("moe-debug", dtype=torch.float32, moe_dispatch=dispatch)
    tt = Trainer(bundle=tb, optimizer=topt.adamw_cosine(1e-4), device="cpu")
    tstate = tt.init_state_from_params(_to_torch(jstate.params), 0)
    tok = jpipeline.synthetic_dataset(20000, 259, 32, seed=0)
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    jl = jloader.ShardedBatchLoader(tok, 4, sharding, seed=0)
    batches = [np.array(b["input_ids"]) for _, b in
               zip(range(3), jl.epoch_batches())]
    jl.close()
    for step, ids in enumerate(batches):
        jstate, jm = jt.step_fn(jstate, {"input_ids": jnp.asarray(ids),
                                         "labels": jnp.asarray(ids)})
        t_ids = torch.from_numpy(ids).long()
        tstate, tm = tt.step_fn(tstate, {"input_ids": t_ids,
                                         "labels": t_ids})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=2e-5, err_msg=f"{key} at "
                                       f"step {step}")
        assert (tm["moe_dropped_frac"].item()
                == float(jm["moe_dropped_frac"]))
    assert tstate.step == 3


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_weight_bridge_round_trips_the_moe_tree(dtype):
    """Every leaf of the MoE pytree (expert stacks, router, shared expert,
    q/k norms, biases) crosses to torch and back bit for bit, with the
    port's own init's leaf set and shapes."""
    jb = jget_model("moe-debug", **VARIANTS["qk-bias-shared"])
    jparams = jax.tree.map(lambda a: a.astype(dtype),
                           jb.init(jb.config, jax.random.key(0)))
    tparams = _to_torch(jparams)
    back = from_jax.params_to_numpy(tparams)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    bflat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in jflat:
        got = bflat[path]
        assert got.dtype == np.asarray(leaf).dtype
        assert np.array_equal(got.view(np.uint8),
                              np.asarray(leaf).view(np.uint8)), path
    tb = get_model("moe-debug", **VARIANTS["qk-bias-shared"])
    own = tb.init(tb.config, 0, device="cpu")
    oflat = jax.tree_util.tree_flatten_with_path(
        own, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [(p, tuple(t.shape)) for p, t in oflat] == [
        (p, tuple(np.shape(x))) for p, x in jflat]


def test_parameter_counts_match_jax():
    """Every MoE preset counts the same total and active parameters as
    the JAX package; qwen3-30b-a3b is the 30.5B / 3.3B model card."""
    for name in ("moe-debug", "moe-1b-8e", "mixtral-8x7b",
                 "qwen1.5-moe-a2.7b", "qwen3-30b-a3b"):
        assert name in list_models()
        jb, tb = jget_model(name), get_model(name)
        assert tb.family == "moe" and tb.apply_with_aux is not None
        assert tb.num_params() == jb.num_params(), name
        assert tb.num_active_params() == jb.num_active_params(), name
    n = get_model("qwen3-30b-a3b").num_params()
    assert 30.4e9 < n < 30.6e9


def _args(model, *extra):
    return tcli.get_parser().parse_args(
        ["-m", model, "-d", "synthetic:20000", "-s", "32", "-b", "2",
         "--max-steps", "2", "--log-freq", "2", "--device", "cpu", *extra])


def test_cli_moe_dispatch_accepted_for_moe_refused_for_llama():
    before = (tgm.GMM_LAUNCHES, tgm.TGMM_LAUNCHES)
    out = tcli.run_training(_args("moe-debug", "--moe-dispatch", "ragged"))
    assert (tgm.GMM_LAUNCHES, tgm.TGMM_LAUNCHES) == before   # CPU: plain
    info = out["last_info"]
    assert info["global_step"] == 2 and np.isfinite(info["running_loss"])
    assert info["moe_dropped_frac"] == 0.0
    with pytest.raises(SystemExit, match="only valid for MoE models"):
        tcli.run_training(_args("llama-debug", "--moe-dispatch", "ragged"))


def test_unported_moe_paths_raise():
    """Every MoE path is ported now: the overlap schedule's
    ``layer_schedule`` (one device: nothing gathered) runs the layers over
    the ``(x, aux, dropped)`` carry, bitwise the loop; a dispatch with no
    axis wider than one member is None (the local path is the program),
    and a ``moe_ep`` threaded through ``apply_with_aux`` runs every
    layer's ragged dispatch, here the local one, bitwise."""
    from distributed_training_guide_tpu_torch.ops.overlap import (
        make_layer_schedule)

    _, _, tb, tparams = _bridged("moe-debug")
    ids = torch.zeros(1, 4, dtype=torch.long)
    assert tmoe.make_ragged_ep_dispatch(None, tb.config) is None
    plain = tmoe.apply_with_aux(tb.config, tparams, ids, return_metrics=True)
    sched = tmoe.apply_with_aux(
        tb.config, tparams, ids, return_metrics=True,
        layer_schedule=make_layer_schedule(remat=False, remat_policy=None))
    for a, b in zip(plain[:2], sched[:2]):
        assert torch.equal(a, b)
    assert plain[2] == sched[2]
    cfg = dataclasses.replace(tb.config, moe_dispatch="ragged")
    calls = []

    def moe_ep(xts, idxs, probs, gates, ups, downs):
        calls.append(len(xts))
        ef = idxs[0].T.reshape(-1)
        return [tmoe._ragged_dispatch(
            cfg, xts[0], ef, probs[0].T.reshape(-1),
            tmoe._group_sizes(ef, cfg.num_experts),
            {"gate": gates[0], "up": ups[0], "down": downs[0]}, cfg.dtype)]
    got = tmoe.apply_with_aux(cfg, tparams, ids, moe_ep=moe_ep)[0]
    assert calls == [1] * cfg.num_layers
    assert torch.equal(got, tmoe.apply_with_aux(cfg, tparams, ids)[0])
    # the remat policies are ported (tests/test_torch_remat.py)
    dots, _ = tmoe.apply_with_aux(tb.config, tparams, ids, remat=True,
                                  remat_policy="dots")
    assert torch.equal(dots, tmoe.apply_with_aux(tb.config, tparams, ids)[0])
    cfg = dataclasses.replace(tb.config, moe_dispatch="sparse")
    with pytest.raises(ValueError, match="moe_dispatch"):
        tmoe.apply_with_aux(cfg, tparams, ids)
