"""The port's training path against the JAX package's on the CPU, at
llama-debug size with weights carried across by the weight bridge and
inputs made with numpy: ``apply`` (einsum and flash attention, remat,
hidden states), the bf16 output head, the losses, AdamW + cosine, the
batch loader, a 5-step ``Trainer`` trajectory, the non-finite guard and
the chapter-01 CLI. Each test states its bound."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_guide_tpu.data import loader as jloader
from distributed_training_guide_tpu.data import pipeline as jpipeline
from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.models import llama as jllama
from distributed_training_guide_tpu.ops import cross_entropy as jce
from distributed_training_guide_tpu.train import optimizer as jopt
from distributed_training_guide_tpu.train.guards import (
    GuardMonitor as JGuardMonitor)
from distributed_training_guide_tpu.train.step import Trainer as JTrainer
from distributed_training_guide_tpu_torch.data import BatchLoader
from distributed_training_guide_tpu_torch.data import pipeline as tpipeline
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.models import llama as tllama
from distributed_training_guide_tpu_torch.ops import cross_entropy as tce
from distributed_training_guide_tpu_torch.ops import flash_attention as tfa
from distributed_training_guide_tpu_torch.train import cli as tcli
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train.guards import (
    GuardMonitor, NonFiniteLossError)
from distributed_training_guide_tpu_torch.train.step import Trainer
import torch_threads  # noqa: F401  (one torch thread a test process)

LOGIT_TOL = 1e-4   # two fp32 layers, norms and softmax in another order
LOSS_TOL = 1e-5


def _to_torch(tree):
    return from_jax.params_from_numpy(jax.tree.map(np.asarray, tree),
                                      device="cpu")


@pytest.fixture(scope="module")
def bridged():
    jb = jget_model("llama-debug", dtype=jnp.float32)
    jparams = jb.init(jb.config, jax.random.key(0))
    tb = get_model("llama-debug", dtype=torch.float32)
    return jb, jparams, tb, _to_torch(jparams)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_apply_matches_jax(bridged, attn_impl):
    jb, jparams, tb, tparams = bridged
    ids = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32)
    jlog = jllama.apply(jb.config, jparams, jnp.asarray(ids),
                        attn_impl=attn_impl)
    tids = torch.from_numpy(ids)
    before = tfa.FWD_LAUNCHES
    tlog = tllama.apply(tb.config, tparams, tids, attn_impl=attn_impl)
    assert tfa.FWD_LAUNCHES == before          # CPU: the plain versions
    assert tlog.dtype == torch.float32 and tlog.shape == (2, 16, 512)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=LOGIT_TOL)
    remat = tllama.apply(tb.config, tparams, tids, attn_impl=attn_impl,
                         remat=True)
    assert torch.equal(remat, tlog)
    jhid = jllama.apply(jb.config, jparams, jnp.asarray(ids),
                        attn_impl=attn_impl, return_hidden=True)
    thid = tllama.apply(tb.config, tparams, tids, attn_impl=attn_impl,
                        return_hidden=True)
    np.testing.assert_allclose(thid.numpy(), np.asarray(jhid), rtol=0,
                               atol=LOGIT_TOL)


def test_bf16_head_keeps_the_fp32_accumulator(bridged):
    """bf16 params and hidden states: the fp32 logits equal the JAX
    fp32-accumulator product within 1e-5 relative (the products are exact
    in fp32 on both sides; only the summation order differs)."""
    jb, jparams, _, _ = bridged
    jcfg = dataclasses.replace(jb.config, dtype=jnp.bfloat16)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    tb = get_model("llama-debug", dtype=torch.bfloat16)
    tp = _to_torch(jp)
    x = np.random.default_rng(1).standard_normal((2, 8, 64)).astype(
        np.float32)
    jlog = np.asarray(jllama.lm_head_logits(
        jcfg, jp, jnp.asarray(x).astype(jnp.bfloat16)))
    tlog = tllama.lm_head_logits(tb.config, tp,
                                 torch.from_numpy(x).to(torch.bfloat16))
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=1e-5,
                               atol=1e-5 * np.abs(jlog).max())


@pytest.mark.parametrize("chunks", [0, 4])
def test_losses_and_grads_match_jax(chunks):
    rng = np.random.default_rng(2)
    b, s, e, v = 2, 15, 16, 40
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, 3:6] = -100
    labels[1, -1] = -100
    if chunks == 0:
        logits = rng.standard_normal((b, s, v)).astype(np.float32)
        jl, jg = jax.value_and_grad(jce.causal_lm_loss)(
            jnp.asarray(logits), jnp.asarray(labels))
        tlog = torch.from_numpy(logits).requires_grad_()
        tl = tce.causal_lm_loss(tlog, torch.from_numpy(labels))
        tl.backward()
        pairs = [(tlog.grad, jg)]
    else:
        hidden = rng.standard_normal((b, s, e)).astype(np.float32)
        w = rng.standard_normal((e, v)).astype(np.float32)
        jl, (jgh, jgw) = jax.value_and_grad(
            lambda h, w: jce.chunked_causal_lm_loss(h, w, jnp.asarray(labels),
                                                    num_chunks=chunks),
            argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(w))
        th = torch.from_numpy(hidden).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        # the port's chunked loss is the fused hidden->loss
        nll, count = tce.fused_linear_cross_entropy(
            th, tw, torch.from_numpy(labels), num_chunks=chunks)
        tl = nll / count
        tl.backward()
        pairs = [(th.grad, jgh), (tw.grad, jgw)]
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_TOL)
    for tg, jg in pairs:
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                                   atol=LOSS_TOL)


def test_adamw_cosine_matches_optax():
    """10 updates of the same grads: the learning rate of every update
    equal to optax's schedule at its count, params within 1e-6."""
    rng = np.random.default_rng(3)
    shapes = {"w": (4, 3), "norm": (3,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    kw = dict(t_max=6, warmup_steps=2)
    tx = jopt.adamw_cosine(1e-2, **kw)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jp)
    schedule = jopt.make_schedule(1e-2, **kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt_state = topt.adamw_cosine(1e-2, **kw).init(list(tp.values()))
    for step in range(10):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        lr = opt_state.optimizer.param_groups[0]["lr"]
        np.testing.assert_allclose(lr, float(schedule(step)), rtol=1e-6,
                                   err_msg=f"lr at update {step}")
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in
                                     grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt_state.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{k} after update {step}")


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_loader_batches_equal_jax(grad_accum):
    tok = jpipeline.synthetic_dataset(4000, 259, 32, seed=5)
    assert np.array_equal(tok, tpipeline.synthetic_dataset(4000, 259, 32,
                                                           seed=5))
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    jl = jloader.ShardedBatchLoader(tok, 8, sharding, grad_accum=grad_accum,
                                    seed=5)
    tl = BatchLoader(tok, 8, device="cpu", grad_accum=grad_accum, seed=5)
    assert len(jl) == len(tl)
    for epoch, start in ((0, 0), (1, 3)):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb = list(jl.epoch_batches(start_step=start))
        tb = list(tl.epoch_batches(start_step=start))
        assert len(jb) == len(tb) == len(jl) - start
        for a, b in zip(jb, tb):
            assert b["input_ids"].dtype == torch.int64
            assert np.array_equal(b["input_ids"].numpy(),
                                  np.asarray(a["input_ids"]))
            assert np.array_equal(b["labels"].numpy(),
                                  np.asarray(a["labels"]))
    jl.close()


def _batches(grad_accum, steps=5):
    tok = jpipeline.synthetic_dataset(20000, 259, 32, seed=0)
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    jl = jloader.ShardedBatchLoader(tok, 4, sharding, grad_accum=grad_accum,
                                    seed=0)
    out = [np.array(b["input_ids"]) for _, b in
           zip(range(steps), jl.epoch_batches())]
    jl.close()
    return out


@pytest.mark.parametrize("grad_accum,remat", [(1, False), (2, True)])
def test_trainer_trajectory_matches_jax(grad_accum, remat):
    """5 steps of llama-debug in fp32 from the same params and batches:
    loss and grad norm per step within 2e-5 relative. The lr is 1e-4, so
    Adam's normalized update (about lr per param, whatever the grad's
    size) carries the tiny grad differences of another summation order
    only as far as lr * 5 steps into the params."""
    jb = jget_model("llama-debug", dtype=jnp.float32)
    jt = JTrainer(bundle=jb, optimizer=jopt.adamw_cosine(1e-4),
                  grad_accum=grad_accum, remat=remat)
    jstate = jt.init_state(0)
    tparams = _to_torch(jstate.params)
    tb = get_model("llama-debug", dtype=torch.float32)
    tt = Trainer(bundle=tb, optimizer=topt.adamw_cosine(1e-4),
                 grad_accum=grad_accum, remat=remat, device="cpu")
    tstate = tt.init_state_from_params(tparams, 0)
    for step, ids in enumerate(_batches(grad_accum)):
        jstate, jm = jt.step_fn(jstate, {"input_ids": jnp.asarray(ids),
                                         "labels": jnp.asarray(ids)})
        t_ids = torch.from_numpy(ids).long()
        tstate, tm = tt.step_fn(tstate, {"input_ids": t_ids,
                                         "labels": t_ids})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=2e-5, err_msg=f"{key} at "
                                       f"step {step}")
    assert tstate.step == 5 and int(jstate.step) == 5


def test_guard_skip_reverts_like_jax_and_abort_raises():
    """An injected non-finite loss under ``skip``: params and the whole
    optimizer state (its schedule count too) stay bit for bit, and the
    step advances, as in the JAX Trainer."""
    def poisoned(logits, labels):
        return jce.causal_lm_loss(logits, labels) * jnp.nan

    def tpoisoned(logits, labels):
        return tce.causal_lm_loss(logits, labels) * float("nan")

    ids = _batches(1, steps=1)[0]
    jb = jget_model("llama-debug", dtype=jnp.float32)
    jt = JTrainer(bundle=jb, optimizer=jopt.adamw_cosine(1e-3),
                  guard_policy="skip", loss_fn=poisoned)
    jstate = jt.init_state(0)
    jbefore = jax.tree.map(np.array, (jstate.params, jstate.opt_state))
    jstate, jm = jt.step_fn(jstate, {"input_ids": jnp.asarray(ids),
                                     "labels": jnp.asarray(ids)})
    assert float(jm["notfinite"]) == 1.0 and int(jstate.step) == 1
    jafter = jax.tree.map(np.array, (jstate.params, jstate.opt_state))
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(jbefore), jax.tree.leaves(jafter)))

    tt = Trainer(bundle=get_model("llama-debug", dtype=torch.float32),
                 optimizer=topt.adamw_cosine(1e-3), guard_policy="skip",
                 loss_fn=tpoisoned, device="cpu")
    tstate = tt.init_state(0)
    t_ids = torch.from_numpy(ids).long()
    tt.loss_fn = tce.causal_lm_loss          # one good step first
    tt.step_fn(tstate, {"input_ids": t_ids, "labels": t_ids})
    tt.loss_fn = tpoisoned
    opt = tstate.opt_state
    before = ({k: v.detach().clone() for k, v in
               tllama.layer_params(tstate.params, 0)["mlp"].items()},
              {i: {k: v.clone() for k, v in s.items()}
               for i, s in enumerate(opt.optimizer.state.values())},
              opt.scheduler.last_epoch, opt.optimizer.param_groups[0]["lr"])
    tstate, tm = tt.step_fn(tstate, {"input_ids": t_ids, "labels": t_ids})
    assert tm["notfinite"].item() == 1.0 and tstate.step == 2
    for k, v in tllama.layer_params(tstate.params, 0)["mlp"].items():
        assert torch.equal(v, before[0][k]), k
    for i, s in enumerate(opt.optimizer.state.values()):
        for k, v in s.items():
            assert torch.equal(v, before[1][i][k]), (i, k)
    assert opt.scheduler.last_epoch == before[2]
    assert opt.optimizer.param_groups[0]["lr"] == before[3]

    for monitor in (GuardMonitor("abort"), JGuardMonitor("abort")):
        assert not monitor.observe(0.0, 1)
        with pytest.raises(Exception, match="non-finite training step 2"):
            monitor.observe(1.0, 2, {"loss": float("nan")})
    skipper = GuardMonitor("skip", max_consecutive_skips=1)
    assert skipper.observe(1.0, 1)
    with pytest.raises(NonFiniteLossError):
        skipper.observe(1.0, 2)


def _args(*extra):
    return tcli.get_parser().parse_args(
        ["-m", "llama-debug", "-d", "synthetic:20000", "-s", "64", "-b", "2",
         "--max-steps", "6", "--log-freq", "3", "--device", "cpu", *extra])


def test_cli_runs_on_cpu_with_finite_losses():
    out = tcli.run_training(_args())
    infos = out["infos"]
    assert [i["global_step"] for i in infos] == [3, 6]
    for info in infos:
        assert np.isfinite(info["running_loss"])
        assert np.isfinite(info["grad_norm"])
        for key in ("lr", "tokens_per_s", "mfu", "time/total", "time/data",
                    "time/step", "peak_alloc_gb", "epoch_progress"):
            assert key in info, key
    assert out["state"].step == 6
    assert out["host_state"]["global_step"] == 6


@pytest.mark.parametrize("flag", [
    ["--native-loader"], ["--overlap-schedule"]],
    ids=lambda f: "_".join(f).strip("-"))
def test_cli_refuses_unported_flags(flag):
    """``--native-loader`` refuses, naming its ROADMAP item;
    ``--overlap-schedule`` is ported and trains (the layer schedule and
    the fused hidden->loss on one device)."""
    if flag == ["--overlap-schedule"]:
        out = tcli.run_training(_args(*flag))
        assert out["state"].step > 0
        assert all(np.isfinite(i["running_loss"]) for i in out["infos"])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tcli.run_training(_args(*flag))


def test_cli_without_device_flag_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    args = _args()
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.run_training(args)


def test_cli_bf16_params_follow_the_jax_cli(monkeypatch):
    """``--param-dtype bfloat16`` under the default policy, both CLIs on
    the same bf16 weights (the JAX CLI's own init, carried across) and the
    same synthetic batches: every optimizer slot of the port's state is
    bf16, as optax keeps it, and the losses of 6 steps agree within 1e-3
    relative (bf16 compute in two frameworks; 2.2e-4 measured)."""
    from distributed_training_guide_tpu.parallel import make_mesh, make_plan
    from distributed_training_guide_tpu.train import cli as jcli

    argv = ["-m", "llama-debug", "-d", "synthetic:20000", "-s", "64", "-b",
            "2", "--max-steps", "6", "--log-freq", "1", "--param-dtype",
            "bfloat16", "--lr", "1e-2"]
    jinfos = []
    real_info = jcli.LOGGER.info

    def capture(msg, *a, **kw):
        if isinstance(msg, dict) and "running_loss" in msg:
            jinfos.append(msg)
        return real_info(msg, *a, **kw)

    monkeypatch.setattr(jcli.LOGGER, "info", capture)
    jcli.run_training(jcli.get_parser().parse_args(argv),
                      lambda: make_plan("single",
                                        make_mesh(devices=jax.devices()[:1])))
    jb = jget_model("llama-debug", param_dtype=jnp.bfloat16)
    init_rng, _ = jax.random.split(jax.random.key(0))
    jparams = jax.tree.map(np.asarray, jb.init(jb.config, init_rng))

    def bridged_init(config, rng, *, device=None):
        return from_jax.params_from_numpy(jparams, device=device)

    monkeypatch.setattr(tllama, "init", bridged_init)
    out = tcli.run_training(tcli.get_parser().parse_args(
        argv + ["--device", "cpu"]))
    opt = out["state"].opt_state.optimizer
    assert not isinstance(opt, torch.optim.AdamW)
    for slots in opt.state.values():
        assert {k: v.dtype for k, v in slots.items()} == {
            "exp_avg": torch.bfloat16, "exp_avg_sq": torch.bfloat16}
    tlosses = [i["running_loss"] for i in out["infos"]]
    jlosses = [i["running_loss"] for i in jinfos]
    assert len(tlosses) == len(jlosses) == 6
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
