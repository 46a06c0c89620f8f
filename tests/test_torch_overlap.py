"""The port's overlap schedule and fused hidden->loss (``ops/overlap.py``,
``ops/cross_entropy.py:fused_linear_cross_entropy``) against the JAX
package, in one process.

The fused loss is held to JAX's ``fused_linear_cross_entropy`` (value,
dh and dW: fp32 within 1e-5 relative to each grad's largest, bf16 within
the bound stated at ``BF16_*``) and to the port's own whole-tensor
``causal_lm_loss``, on a row count the chunks do not divide and with
``-100`` labels. The schedule runs on a plan at world 1 (a real gloo
group of one rank, every fsdp collective a one-rank copy): bitwise the
unscheduled run on the same loss for the four families, its gather
counter at 2 x L x 7 a step for llama-debug under fsdp (the stand-in for
the JAX package's HLO count), the user's remat policy in charge under
``remat``. The single device's scheduled trajectory (the fused loss in
place of the logits) is held to the JAX Trainer's under
``overlap_schedule``. The expert ring over 4 virtual members is held to
the bulk exchange. The Trainer refuses the schedule under pp, under cp,
for LoRA and for a family without ``layer_schedule`` as the JAX Trainer
does, keeps the standard loss for Gemma-2's final softcap, and refuses a
custom loss or ``loss_chunks`` under pp / cp under a plan (ROADMAP item
7). The preflight prices the scheduled comm as JAX's does. The 4-rank
cases (fsdp, zero1, tp_fsdp, zero2, tp, ep) are in the
``tests/test_torch_dist.py`` gang."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.ops.cross_entropy import (
    fused_linear_cross_entropy as jfused)
from distributed_training_guide_tpu.parallel import make_mesh as jmake_mesh
from distributed_training_guide_tpu.parallel import make_plan as jmake_plan
from distributed_training_guide_tpu.train import Trainer as JTrainer
from distributed_training_guide_tpu.train import adamw_cosine as jadamw
from distributed_training_guide_tpu.train import preflight as jpre
from distributed_training_guide_tpu_torch.models import get_model
from distributed_training_guide_tpu_torch.models import moe as tmoe
from distributed_training_guide_tpu_torch.models.registry import (
    family_module)
from distributed_training_guide_tpu_torch.ops import overlap as tov
from distributed_training_guide_tpu_torch.ops.collectives import (
    LocalExchange)
from distributed_training_guide_tpu_torch.ops.cross_entropy import (
    causal_lm_loss, fused_linear_cross_entropy)
from distributed_training_guide_tpu_torch.ops.matmul import matmul_f32_out
from distributed_training_guide_tpu_torch.parallel import make_mesh, make_plan
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train.preflight import (
    comm_roofline, fake_group)
from distributed_training_guide_tpu_torch.train.step import Trainer
import torch_threads  # noqa: F401  (one torch thread a test process)

B, S, E, V = 3, 17, 16, 37          # 3 x 16 = 48 rows, 5 chunks: padded
CHUNKS = 5
# bf16 operands: the port rounds the fp32 cotangent to bf16 before the two
# products, as its whole-tensor head does (ops/matmul.py); JAX's CPU dot
# takes it in fp32. Bound on |port - JAX| / max|JAX| per grad
BF16_GRAD_REL = 2e-2
STEPS = 3


def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(B, S, E).astype(np.float32)
    w = (rng.randn(E, V) * 0.1).astype(np.float32)
    labels = rng.randint(0, V, (B, S))
    labels[0, 3] = -100
    labels[2, 5:9] = -100
    return h, w, labels


def _port_fused(h, w, labels, dtype, chunks=CHUNKS):
    th = torch.tensor(h).to(dtype).requires_grad_()
    tw = torch.tensor(w).to(dtype).requires_grad_()
    nll, cnt = fused_linear_cross_entropy(th, tw, torch.tensor(labels),
                                          num_chunks=chunks)
    loss = nll / cnt.clamp_min(1)
    loss.backward()
    return (float(loss.detach()), th.grad.float().numpy(),
            tw.grad.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_loss_matches_jax(dtype):
    """Value, dh and dW of the port's fused loss against JAX's
    ``fused_linear_cross_entropy`` on the same rows, 5 chunks over 48 rows
    (3 padded), -100 labels: fp32 within 1e-5 (the loss relative, each
    grad relative to its largest element), bf16 within ``BF16_GRAD_REL``
    and the loss within 1e-3."""
    h, w, labels = _loss_inputs()
    jdt = getattr(jnp, dtype)

    def jloss(h_, w_):
        nll, cnt = jfused(h_, w_, jnp.asarray(labels), num_chunks=CHUNKS)
        return nll / jnp.maximum(cnt, 1.0)

    jv, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h, jdt), jnp.asarray(w, jdt))
    v, gh, gw = _port_fused(h, w, labels, getattr(torch, dtype))
    exact = dtype == "float32"
    assert v == pytest.approx(float(jv), rel=1e-5 if exact else 1e-3)
    for got, want in ((gh, jgh), (gw, jgw)):
        want = np.asarray(want, np.float32)
        bound = (1e-5 if exact else BF16_GRAD_REL) * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=bound)


@pytest.mark.parametrize("chunks", [1, CHUNKS])
def test_fused_loss_matches_the_whole_tensor_loss(chunks):
    """The fused loss against the port's ``causal_lm_loss`` of the
    ``matmul_f32_out`` logits (what the unscheduled head computes) in
    fp32: the value within 1e-6 (the chunked sum adds in another order)
    and both grads within 1e-6 of their largest element."""
    h, w, labels = _loss_inputs(1)
    v, gh, gw = _port_fused(h, w, labels, torch.float32, chunks)
    th = torch.tensor(h).requires_grad_()
    tw = torch.tensor(w).requires_grad_()
    ref = causal_lm_loss(matmul_f32_out(th, tw), torch.tensor(labels))
    ref.backward()
    assert v == pytest.approx(float(ref.detach()), rel=1e-6)
    for got, want in ((gh, th.grad), (gw, tw.grad)):
        want = want.numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@contextlib.contextmanager
def _world_of_one():
    """A real gloo group of one rank in this process (a plan's fsdp
    collectives are one-rank copies), taken down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _batch(vocab, seed=0, b=4, s=32):
    ids = torch.from_numpy(np.random.RandomState(seed).randint(0, vocab,
                                                               (b, s)))
    return {"input_ids": ids, "labels": ids}


def _steps(t, batch, steps=STEPS) -> tuple:
    torch.manual_seed(0)
    state = t.init_state(0)
    out = []
    for _ in range(steps):
        state, m = t.step_fn(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, state


FAMILIES = [("llama-debug", {}, 7), ("gpt2-debug", {}, None),
            ("neox-debug", {}, None),
            ("moe-debug", {"moe_dispatch": "ragged"}, None),
            ("llama-debug", {"dtype": torch.bfloat16}, 7),
            ("moe-debug", {"dtype": torch.bfloat16, "moe_dispatch": "ragged",
                           "shared_expert_intermediate": 32}, None)]


@pytest.mark.parametrize("model,over,leaves", FAMILIES,
                         ids=[m for m, _, _ in FAMILIES[:-2]]
                         + ["llama-debug-bf16-compute",
                            "moe-debug-bf16-compute"])
def test_schedule_at_world_one_is_bitwise_the_loop(model, over, leaves):
    """fsdp at world 1 on a real gloo group: the scheduled run (each
    layer's fsdp leaves gathered a layer ahead and dropped after the
    forward, so the backward gathers them again) equals the unscheduled
    run on the same fused loss (``loss_chunks`` 4) bitwise, losses, grad
    norms and params; every layer gathers the same leaves in the forward
    and again for the backward (llama-debug: 7 leaves, 2 x L x 7 a step:
    under bf16 compute the weights are gathered in bf16, but moe's router
    and shared gate, which its block reads in fp32), and the first step's
    loss is within 1e-6 of the whole-tensor loss's (1e-3 under bf16
    compute: rounded in another order)."""
    over = {"dtype": torch.float32, **over}

    def trainer(sched, chunks=4):
        return Trainer(bundle=get_model(model, **over),
                       optimizer=topt.adamw_cosine(1e-3), device="cpu",
                       plan=make_plan("fsdp", make_mesh(device="cpu")),
                       overlap_schedule=sched, loss_chunks=chunks)

    with _world_of_one():
        t = trainer(True)
        batch = _batch(t.bundle.config.vocab_size)
        got, state = _steps(t, batch)
        want, want_state = _steps(trainer(False), batch)
        whole, _ = _steps(trainer(False, 0), batch, steps=1)
        sched = t.plan_state.layer_schedule
        n_layers = t.bundle.config.num_layers
    assert got == want
    for (path, a), (_, b) in zip(sorted(_flat(state.params).items()),
                                 sorted(_flat(want_state.params).items())):
        assert torch.equal(a, b), path
    if leaves is not None:
        assert sched.n_gathered == leaves
    assert sched.n_gathered > 0
    per_step = n_layers * sched.n_gathered
    assert sched.counts == {"gather": STEPS * per_step,
                            "regather": STEPS * per_step}
    assert got[0][0] == pytest.approx(
        whole[0][0], rel=1e-6 if over["dtype"] == torch.float32 else 1e-3)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("policy", ["all", "attn"])
def test_schedule_under_user_remat(policy):
    """With ``remat`` the user's policy decides what a cell keeps: under
    "all" and "attn" the backward gathers every leaf again, and the run is
    bitwise the unscheduled one under the same policy."""
    def trainer(sched):
        return Trainer(bundle=get_model("llama-debug", dtype=torch.float32),
                       optimizer=topt.adamw_cosine(1e-3), device="cpu",
                       plan=make_plan("fsdp", make_mesh(device="cpu")),
                       overlap_schedule=sched, loss_chunks=4, remat=True,
                       remat_policy=policy)

    with _world_of_one():
        t = trainer(True)
        batch = _batch(512)
        got, _ = _steps(t, batch, steps=2)
        want, _ = _steps(trainer(False), batch, steps=2)
        counts = t.plan_state.layer_schedule.counts
    assert got == want
    assert counts == {"gather": 2 * 2 * 7, "regather": 2 * 2 * 7}


@pytest.mark.parametrize("model,over", [
    ("llama-debug", {}), ("moe-debug", {"moe_dispatch": "ragged"})],
    ids=["llama-debug", "moe-debug-ragged"])
def test_single_device_schedule_holds_the_jax_scheduled_trajectory(model,
                                                                   over):
    """One device under ``overlap_schedule`` (the layer loop with nothing
    to gather, the fused hidden->loss in 8 chunks in place of the logits)
    against the JAX Trainer's scheduled single plan on the same weights
    and batch: 3 AdamW steps, losses within 1e-5 relative."""
    from distributed_training_guide_tpu_torch.models import from_jax

    jt = JTrainer(bundle=jget_model(model, dtype=jnp.float32, **over),
                  optimizer=jadamw(1e-3), donate=False,
                  plan=jmake_plan("single", jmake_mesh(
                      devices=jax.devices()[:1])), overlap_schedule=True)
    jstate = jt.init_state(0)
    params = from_jax.params_from_numpy(
        jax.tree.map(np.asarray, jstate.params), device="cpu")
    batch = _batch(jt.bundle.config.vocab_size)
    jb = {k: jax.device_put(jnp.asarray(v.numpy()),
                            jt.batch_shardings()[k]) for k, v in batch.items()}
    want = []
    for _ in range(STEPS):
        jstate, m = jt.step_fn(jstate, jb)
        want.append(float(m["loss"]))
    t = Trainer(bundle=get_model(model, dtype=torch.float32, **over),
                optimizer=topt.adamw_cosine(1e-3), device="cpu",
                overlap_schedule=True)
    assert t.fused_loss is not None and t.layer_schedule is not None
    state = t.init_state_from_params(params)
    got = []
    for _ in range(STEPS):
        state, m = t.step_fn(state, batch)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ring_holds_the_bulk_exchange():
    """``make_ragged_ep_dispatch(overlap=True)`` over 4 virtual members
    (``LocalExchange``: the blocks hop, each partial goes home) against
    the bulk exchange and the single device's ragged dispatch, fp32: the
    outputs bitwise the bulk's (the same products per row, the partials
    summed in member order), the grads of the rows, probs and expert
    stacks within 1e-6 of their largest element (an expert's weight grad
    is summed over the hops)."""
    cfg = dataclasses.replace(get_model("moe-debug", dtype=torch.float32,
                                        moe_dispatch="ragged").config,
                              num_experts=8)
    gen = torch.Generator().manual_seed(0)
    n, t, d, f = 4, 24, cfg.hidden_size, cfg.intermediate_size
    x = torch.randn(n * t, d, generator=gen)
    router = torch.randn(d, 8, generator=gen)
    w = [torch.randn(8, *sh, generator=gen) * 0.1
         for sh in ((d, f), (d, f), (f, d))]
    cot = torch.randn(n * t, d, generator=gen)

    def run(overlap):
        leaves = [v.clone().requires_grad_() for v in (x, router, *w)]
        xv, rv, *ws = leaves
        probs = torch.softmax(xv @ rv, -1)
        tp, ti = torch.topk(probs, cfg.experts_per_token, -1)
        tp = tp / tp.sum(-1, keepdim=True)
        disp = tmoe.make_ragged_ep_dispatch(LocalExchange(n), cfg,
                                            overlap=overlap)
        stacks = [[s[m * 2:(m + 1) * 2] for m in range(n)] for s in ws]
        y = torch.cat(disp(list(torch.chunk(xv, n)), list(torch.chunk(ti, n)),
                           list(torch.chunk(tp, n)), *stacks))
        return [y.detach(), *torch.autograd.grad(y, leaves, cot)]

    ring, bulk = run(True), run(False)
    assert torch.equal(ring[0], bulk[0])
    for name, a, b in zip(("dx", "drouter", "dgate", "dup", "ddown"),
                          ring[1:], bulk[1:]):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-6 * scale, name


@pytest.mark.parametrize("strategy,mesh,match", [
    ("pp", {"pp": 2}, "pipeline"),
    ("ddp", {"cp": 2}, "context parallelism"),
    ("fsdp", {"fsdp": 2}, "layers")],
    ids=["pp", "cp", "lora"])
def test_schedule_refused_where_jax_refuses_it(strategy, mesh, match):
    """The JAX Trainer's refusals (``tests/test_overlap.py``): under pp,
    under cp, and for a LoRA bundle (no stacked ``params['layers']``)."""
    from distributed_training_guide_tpu_torch.models.lora import lora_bundle

    bundle = get_model("llama-debug")
    if match == "layers":
        bundle = lora_bundle(bundle, rank=2)
    with fake_group(4):
        plan = make_plan(strategy, make_mesh(device="cpu", **mesh))
        with pytest.raises(ValueError, match=match):
            Trainer(bundle=bundle, optimizer=topt.adamw_cosine(1e-3),
                    plan=plan, device="meta", overlap_schedule=True)


def test_schedule_refused_for_a_family_without_layer_schedule():
    """A family whose apply takes no ``layer_schedule`` is refused, as the
    JAX Trainer refuses it."""
    from distributed_training_guide_tpu_torch.models.registry import (
        ModelBundle)

    b = get_model("llama-debug")

    def apply(cfg, params, ids, positions=None, *, remat=False):
        return b.apply(cfg, params, ids, positions, remat=remat)

    bundle = dataclasses.replace(b, apply=apply)
    assert isinstance(bundle, ModelBundle)
    with pytest.raises(ValueError, match="does not take a layer_schedule"):
        Trainer(bundle=bundle, optimizer=topt.adamw_cosine(1e-3),
                device="cpu", overlap_schedule=True)


def test_fused_loss_skipped_for_final_softcap():
    """Gemma-2's final_logit_softcap lives in the head, which the fused
    kernel bypasses: ``fused_loss_supported`` names it, the scheduled
    Trainer keeps the standard loss and trains, and ``--loss-chunks``
    (under a plan and on one device) refuses rather than drop the cap."""
    from distributed_training_guide_tpu_torch.ops.cross_entropy import (
        causal_lm_loss as loss_fn)

    bundle = get_model("llama-debug", dtype=torch.float32,
                       final_logit_softcap=30.0)
    reason = tov.fused_loss_supported(None, bundle.config,
                                      family_module("llama"), loss_fn)
    assert reason is not None and "softcap" in reason
    with _world_of_one():
        plan = make_plan("fsdp", make_mesh(device="cpu"))
        t = Trainer(bundle=bundle, optimizer=topt.adamw_cosine(1e-3),
                    plan=plan, device="cpu", overlap_schedule=True)
        assert t.plan_state.fused_loss is None
        losses, _ = _steps(t, _batch(512), steps=1)
        assert np.isfinite(losses[0][0])
        with pytest.raises(NotImplementedError, match="softcap"):
            Trainer(bundle=bundle, optimizer=topt.adamw_cosine(1e-3),
                    plan=plan, device="cpu", loss_chunks=4)
    with pytest.raises(NotImplementedError, match="softcap"):
        Trainer(bundle=bundle, optimizer=topt.adamw_cosine(1e-3),
                device="cpu", loss_chunks=4)


def _square_loss(logits, labels):
    """A custom loss: the mean square logit over the labelled rows."""
    return (logits.float().square().mean(-1)
            * (labels != -100)).sum() / labels.numel()


@pytest.mark.parametrize("strategy,mesh,kw", [
    ("fsdp", {"fsdp": 2}, {"loss_fn": _square_loss}),
    ("pp", {"pp": 2}, {"loss_chunks": 4}),
    ("ddp", {"cp": 2}, {"loss_chunks": 4}),
    ("pp_tp", {"pp": 2, "tp": 2}, {"loss_chunks": 4})],
    ids=["custom-loss", "chunks-pp", "chunks-cp", "chunks-pp-tp"])
def test_what_stays_refused_under_a_plan(strategy, mesh, kw):
    """A custom loss_fn under fsdp, and ``loss_chunks`` under pp and cp,
    build and step on meta on a fake 4-rank group; ``loss_chunks`` under
    pp x tp stays refused with the JAX pipeline's own error."""
    if strategy == "pp_tp":
        jt = JTrainer(bundle=jget_model("llama-debug"),
                      optimizer=jadamw(1e-3), donate=False,
                      plan=jmake_plan("pp_tp", jmake_mesh(
                          pp=2, tp=2, devices=jax.devices()[:4])), **kw)
        with pytest.raises(NotImplementedError) as want:
            jt.step_fn
    with fake_group(4):
        plan = make_plan(strategy, make_mesh(device="cpu", **mesh))
        if strategy == "pp_tp":
            with pytest.raises(NotImplementedError) as got:
                Trainer(bundle=get_model("llama-debug"),
                        optimizer=topt.adamw_cosine(1e-3), plan=plan,
                        device="meta", **kw)
            assert str(got.value) == str(want.value)
            return
        t = Trainer(bundle=get_model("llama-debug"),
                    optimizer=topt.adamw_cosine(1e-3), plan=plan,
                    device="meta", **kw)
        cp = mesh.get("cp", 1)
        ids = torch.empty(4, 32 // cp, dtype=torch.long, device="meta")
        batch = ({"input_ids": ids, "targets": ids, "labels": ids} if cp > 1
                 else {"input_ids": ids, "labels": ids})
        _, m = t.step_fn(t.init_state(0), batch)
        assert m["loss"].shape == () and m["grad_norm"].shape == ()
        assert (t.plan_state.fused_loss is not None) == ("loss_chunks" in kw)


PRICED = [("llama-debug", "fsdp", {"fsdp": 8}, {}),
          ("moe-debug", "ep_fsdp", {"ep": 4, "fsdp": 2},
           {"moe_dispatch": "ragged"})]


@pytest.mark.parametrize("model,strategy,mesh,over", PRICED,
                         ids=[f"{m}-{s}" for m, s, _, _ in PRICED])
def test_preflight_prices_the_schedule_as_jax(model, strategy, mesh, over):
    """A scheduled trainer's comm roofline against JAX's for the same
    trainer: the same rows, overlappable, exposed and overlapped bytes
    (fsdp gathers / reduce-scatters and the expert exchange hidden behind
    compute up to t_compute), ``t_exposed`` by JAX's formula over the
    port's link rate; the scheduled step runs on meta."""
    jt = JTrainer(bundle=jget_model(model, **over), optimizer=jadamw(1e-3),
                  plan=jmake_plan(strategy, jmake_mesh(**mesh)),
                  donate=False, overlap_schedule=True)
    want = jpre.comm_roofline(jt, global_batch=16, seq_length=32,
                              device_kind="v5p")
    with fake_group(8):
        plan = make_plan(strategy, make_mesh(device="cpu", **mesh))
        t = Trainer(bundle=get_model(model, **over),
                    optimizer=topt.adamw_cosine(1e-3), plan=plan,
                    device="meta", overlap_schedule=True)
        t.step_fn(t.init_state(0), {
            "input_ids": torch.empty(2, 32, dtype=torch.long, device="meta"),
            "labels": torch.empty(2, 32, dtype=torch.long, device="meta")})
        got = comm_roofline(t, global_batch=16, seq_length=32)
    assert got["overlap_schedule"] is True and want["overlap_schedule"]
    for key in ("per_collective_bytes_per_chip", "overlappable_bytes_per_chip",
                "exposed_bytes_per_chip", "overlapped_bytes_per_chip"):
        assert got[key] == want[key], key
    assert got["overlapped_bytes_per_chip"] > 0
    link, t_comp = got["link_bytes_per_s"], got["t_compute_s"]
    sched = got["overlappable_bytes_per_chip"]
    assert got["t_exposed_s"] == pytest.approx(
        got["exposed_bytes_per_chip"] / link + max(0.0, sched / link
                                                   - t_comp), rel=1e-6)
    assert got["mfu_ceiling_scheduled"] >= got["mfu_ceiling_serial"]
