"""The port's LoRA (``models/lora.py``) against the JAX package's on the
CPU, at llama-debug size in fp32 with the JAX wrapped params carried
across by the weight bridge:

- the wrapped tree's layout, its logical axes and
  ``num_trainable_params`` equal JAX's; B = 0 starts the wrapped model
  exactly at the base model;
- the adapter grads of one loss (B moved off zero so that A's grad is not
  zero) equal JAX's within 1e-5 of the largest (fp32 through two layers,
  sums in another order);
- the masked update: three ``Trainer(lora_only=True)`` steps against the
  JAX Trainer on ``lora_bundle`` + ``mask_optimizer``, losses within 2e-5
  relative and adapters within 1e-5 after them (``test_torch_train.py``'s
  trajectory bounds); the base bitwise untouched and holding no grad;
- ``merge_lora`` equal to JAX's within 1e-6, and the merged base model's
  logits the wrapped model's within 1e-5;
- the CLI's ``--lora-rank`` (its step-1 loss the base run's, bitwise) and
  the JSON engine's ``lora`` at world one under a plan."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.models import lora as jlora
from distributed_training_guide_tpu.ops import cross_entropy as jce
from distributed_training_guide_tpu.train import optimizer as jopt
from distributed_training_guide_tpu.train.step import Trainer as JTrainer
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.models import lora as tlora
from distributed_training_guide_tpu_torch.ops import cross_entropy as tce
from distributed_training_guide_tpu_torch.train import cli as tcli
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train.state import named_leaves
from distributed_training_guide_tpu_torch.train.step import Trainer
import torch_threads  # noqa: F401  (one torch thread a test process)

TARGETS = ("wq", "wv", "down")
GRAD_TOL = 1e-5
LOSS_RTOL = 2e-5
PARAM_TOL = 1e-5


def _to_torch(tree):
    return from_jax.params_from_numpy(jax.tree.map(np.asarray, tree),
                                      device="cpu")


@pytest.fixture(scope="module")
def wrapped():
    jw = jlora.lora_bundle(jget_model("llama-debug", dtype=jnp.float32),
                           rank=4, targets=TARGETS)
    tw = tlora.lora_bundle(get_model("llama-debug", dtype=torch.float32),
                           rank=4, targets=TARGETS)
    jparams = jw.init(jw.config, jax.random.key(0))
    return jw, jparams, tw


def _ids(seed, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def test_layout_axes_count_and_start_at_base(wrapped):
    jw, jparams, tw = wrapped
    mine = tw.init(tw.config, 0, device="cpu")
    shapes = lambda t: {p: tuple(x.shape) for p, x in  # noqa: E731
                        named_leaves(t)}
    assert shapes(mine) == shapes(_to_torch(jparams))
    assert tw.logical_axes() == jw.param_logical_axes(jw.config)
    assert tlora.num_trainable_params(tw) == jlora.num_trainable_params(jw)
    ids = torch.from_numpy(_ids(0))
    base = tw.lora_base
    assert torch.equal(tw.apply(tw.config, mine, ids),
                       base.apply(base.config, mine["base"], ids))


def test_adapter_grads_match_jax(wrapped):
    jw, jparams, tw = wrapped
    rng = np.random.default_rng(1)
    jp = jax.tree.map(np.asarray, jparams)
    for t in TARGETS:   # B off zero, so that A's grad is not zero too
        jp["lora"][t]["b"] = (0.02 * rng.standard_normal(
            jp["lora"][t]["b"].shape)).astype(np.float32)
    ids = _ids(2)

    def jloss(lora):
        logits = jw.apply(jw.config, {"base": jp["base"], "lora": lora},
                          jnp.asarray(ids))
        return jce.causal_lm_loss(logits, jnp.asarray(ids))

    jgrads = jax.grad(jloss)(jax.tree.map(jnp.asarray, jp["lora"]))
    tp = from_jax.params_from_numpy(jp, device="cpu")
    for _, leaf in named_leaves(tp["lora"]):
        leaf.requires_grad_(True)
    tids = torch.from_numpy(ids).long()
    tce.causal_lm_loss(tw.apply(tw.config, tp, tids), tids).backward()
    for path, leaf in named_leaves(tp["lora"]):
        t, x = path.split("/")
        want = np.asarray(jgrads[t][x])
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=path)


def test_masked_update_matches_jax(wrapped):
    jw, _, tw = wrapped
    jt = JTrainer(bundle=jw, optimizer=jopt.adamw_cosine(1e-3),
                  lora_only=True)
    jstate = jt.init_state(0)
    tt = Trainer(bundle=tw, optimizer=topt.adamw_cosine(1e-3),
                 lora_only=True, device="cpu")
    tstate = tt.init_state_from_params(_to_torch(jstate.params), 0)
    base0 = {p: t.detach().clone()
             for p, t in named_leaves(tstate.params["base"])}
    opt = tstate.opt_state.optimizer
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    assert held == {id(t) for _, t in named_leaves(tstate.params["lora"])}
    for step in range(3):
        ids = _ids(10 + step)
        jstate, jm = jt.step_fn(jstate, {"input_ids": jnp.asarray(ids),
                                         "labels": jnp.asarray(ids)})
        tids = torch.from_numpy(ids).long()
        tstate, tm = tt.step_fn(tstate, {"input_ids": tids, "labels": tids})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=LOSS_RTOL, err_msg=str(step))
    for path, t in named_leaves(tstate.params["base"]):
        assert torch.equal(t, base0[path]) and t.grad is None, path
    want = dict(named_leaves(jax.tree.map(np.asarray,
                                          jstate.params["lora"])))
    for path, t in named_leaves(tstate.params["lora"]):
        np.testing.assert_allclose(t.detach().numpy(), want[path], rtol=0,
                                   atol=PARAM_TOL, err_msg=path)
        if path.endswith("/b"):     # B moved off its zero start
            assert float(t.detach().abs().max()) > 0, path


def test_merge_matches_jax_and_the_wrapped_logits(wrapped):
    jw, jparams, tw = wrapped
    rng = np.random.default_rng(3)
    jp = jax.tree.map(np.asarray, jparams)
    for t in TARGETS:
        jp["lora"][t]["b"] = rng.standard_normal(
            jp["lora"][t]["b"].shape).astype(np.float32)
    want = jax.tree.map(np.asarray, jlora.merge_lora(
        jw, jax.tree.map(jnp.asarray, jp)))
    tp = from_jax.params_from_numpy(jp, device="cpu")
    merged = tlora.merge_lora(tw, tp)
    got = dict(named_leaves(merged))
    for path, leaf in named_leaves(want):
        np.testing.assert_allclose(got[path].numpy(), leaf, rtol=0,
                                   atol=1e-6, err_msg=path)
    ids = torch.from_numpy(_ids(4)).long()
    base = tw.lora_base
    torch.testing.assert_close(base.apply(base.config, merged, ids),
                               tw.apply(tw.config, tp, ids), rtol=0,
                               atol=1e-5)


def _cli(*extra):
    return tcli.get_parser().parse_args(
        ["-m", "llama-debug", "-d", "synthetic:20000", "-s", "64", "-b", "2",
         "--max-steps", "3", "--log-freq", "1", "--device", "cpu", *extra])


def test_cli_lora_rank_trains_only_the_adapters():
    plain = tcli.run_training(_cli())
    out = tcli.run_training(_cli("--lora-rank", "4", "--lora-targets",
                                 "wq,wv"))
    losses = [i["running_loss"] for i in out["infos"]]
    assert losses[0] == plain["infos"][0]["running_loss"]    # B = 0
    assert all(np.isfinite(losses)) and len(losses) == 3
    opt = out["state"].opt_state.optimizer
    assert sum(p.numel() for g in opt.param_groups for p in g["params"]) == \
        2 * (64 * 4 + 4 * 64 + 64 * 4 + 4 * 32)   # L x (wq + wv pairs)


def test_engine_lora_at_world_one():
    from distributed_training_guide_tpu_torch.train.engine import initialize

    engine = initialize({"model": "llama-debug", "bf16": {"enabled": False},
                         "seed": 0, "zero_optimization": {"stage": 1},
                         "lora": {"rank": 4, "targets": ["wq", "down"]},
                         "optimizer": {"type": "AdamW",
                                       "params": {"lr": 1e-2}}},
                        device="cpu")
    try:
        params = engine.state.params
        base0 = {p: t.detach().clone()
                 for p, t in named_leaves(params["base"])}
        lora0 = {p: t.detach().clone()
                 for p, t in named_leaves(params["lora"])}
        ids = torch.from_numpy(_ids(5, (1, 32))).long()
        for _ in range(2):
            m = engine.train_batch({"input_ids": ids, "labels": ids})
            assert np.isfinite(float(m["loss"]))
        for p, t in named_leaves(engine.state.params["base"]):
            assert torch.equal(t, base0[p]), p
        assert any(not torch.equal(t, lora0[p]) for p, t in
                   named_leaves(engine.state.params["lora"]))
    finally:
        engine.close()


def test_lora_refuses_other_families_and_bad_targets():
    with pytest.raises(ValueError, match="llama family only"):
        tlora.lora_bundle(get_model("gpt2-debug"))
    with pytest.raises(ValueError, match="unknown lora targets"):
        tlora.lora_bundle(get_model("llama-debug"), targets=("wqkv",))
    with pytest.raises(ValueError, match="lora_bundle"):
        Trainer(bundle=get_model("llama-debug"),
                optimizer=topt.adamw_cosine(1e-3), lora_only=True,
                device="cpu")
