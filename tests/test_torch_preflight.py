"""The port's preflight (``train/preflight.py``) against the JAX package's.

The port builds the state on the meta device under a fake process group of
the target world and runs one step there; JAX traces and lowers its step
on the conftest's 8 CPU devices. For llama-debug at fsdp 2 x tp 4 under
fp32, bf16-master and adam8bit, the per-device param, optimizer-state and
grad bytes equal the JAX report's, byte for byte, once the optimizers'
0-d step counters are set aside (optax keeps one per state, torch's AdamW
one per leaf). For llama-3.1-405b on the same mesh they equal the bytes of
JAX's ``NamedSharding.shard_shape`` taken without lowering, and
``comm_roofline``'s per-collective rows equal JAX's. A tp that does not
divide the heads prices the leaves as JAX shards them; the reference's 64-GPU shape
(fsdp 8 x tp 8) prices fp32 AdamW at 16 bytes a parameter, and one 405B
layer's fp32 AdamW state does not fit a card of 80 GB."""
import jax
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.parallel import make_mesh as jmake_mesh
from distributed_training_guide_tpu.parallel import make_plan as jmake_plan
from distributed_training_guide_tpu.train import Trainer as JTrainer
from distributed_training_guide_tpu.train import adamw_cosine as jadamw
from distributed_training_guide_tpu.train import preflight as jpre
from distributed_training_guide_tpu_torch.models import get_model
from distributed_training_guide_tpu_torch.parallel import make_mesh, make_plan
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train.preflight import (
    comm_roofline, fake_group, run_preflight)
from distributed_training_guide_tpu_torch.train.step import Trainer
import torch_threads  # noqa: F401  (one torch thread a test process)

POLICIES = ["fp32", "bf16-master", "adam8bit"]
MESH = {"fsdp": 2, "tp": 4}
GLOBAL_BATCH, SEQ = 8, 32


def _jax_trainer(name, policy):
    plan = jmake_plan("tp_fsdp", jmake_mesh(**MESH))
    return JTrainer(bundle=jget_model(name), optimizer=jadamw(1e-3),
                    plan=plan, precision=policy, donate=False)


def _port_report(name, policy):
    """The port's preflight on a fake world of 8 at ``MESH``, and the
    bytes of its state's 0-d counters."""
    with fake_group(8):
        plan = make_plan("tp_fsdp", make_mesh(device="cpu", **MESH))
        t = Trainer(bundle=get_model(name), optimizer=topt.adamw_cosine(1e-3),
                    plan=plan, precision=policy, device="meta")
        report = run_preflight(t, global_batch=GLOBAL_BATCH, seq_length=SEQ)
        return report, _port_counter_bytes(t)


def _jax_counter_bytes(trainer) -> int:
    shapes = jax.eval_shape(trainer.optimizer.init, trainer.param_shapes)
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree.leaves(shapes) if x.ndim == 0)


def _port_counter_bytes(trainer, state=None) -> int:
    state = trainer.init_state(0) if state is None else state
    opt = state.opt_state.optimizer
    return sum(t.numel() * t.element_size() for p in opt.state
               for t in topt.state_slots(opt, p).values() if t.ndim == 0)


@pytest.mark.parametrize("policy", POLICIES)
def test_llama_debug_bytes_equal_the_jax_report(policy):
    jt = _jax_trainer("llama-debug", policy)
    want = jpre.run_preflight(jt, global_batch=GLOBAL_BATCH, seq_length=SEQ)
    got, counters = _port_report("llama-debug", policy)
    assert got["lowered"] and got["n_devices"] == want["n_devices"] == 8
    assert {k: v for k, v in got["mesh"].items() if v > 1} == MESH
    for key in ("per_device_param_bytes", "per_device_grad_bytes_transient"):
        assert got[key] == want[key], key
    assert (got["per_device_opt_state_bytes"] - counters
            == want["per_device_opt_state_bytes"] - _jax_counter_bytes(jt))
    assert got["precision"]["policy"] == want["precision"]["policy"]
    assert got["serve_kv"]["bytes_per_slot_at_seq"] == (
        want["serve_kv"]["bytes_per_slot_at_seq"])


def _jax_shard_bytes(trainer) -> dict:
    """Per-device bytes from ``NamedSharding.shard_shape``, no lowering."""
    params = jpre._per_device_bytes(trainer.param_shapes,
                                    trainer.param_shardings)
    opt_shapes = jax.eval_shape(trainer.optimizer.init, trainer.param_shapes)
    opt = jpre._per_device_bytes(opt_shapes, trainer.opt_shardings_device)
    return {"params": params, "opt": opt - _jax_counter_bytes(trainer)}


@pytest.mark.parametrize("policy", POLICIES)
def test_llama_405b_bytes_equal_jax_shard_shapes(policy):
    want = _jax_shard_bytes(_jax_trainer("llama-3.1-405b", policy))
    got, counters = _port_report("llama-3.1-405b", policy)
    assert got["per_device_param_bytes"] == want["params"]
    assert got["per_device_opt_state_bytes"] - counters == want["opt"]


def test_comm_roofline_rows_equal_jax():
    jt = _jax_trainer("llama-3.1-405b", "fp32")
    want = jpre.comm_roofline(jt, global_batch=32, seq_length=4096,
                              device_kind="v5p")
    with fake_group(8):
        plan = make_plan("tp_fsdp", make_mesh(device="cpu", **MESH))
        t = Trainer(bundle=get_model("llama-3.1-405b"),
                    optimizer=topt.adamw_cosine(1e-3), plan=plan,
                    device="meta")
        got = comm_roofline(t, global_batch=32, seq_length=4096)
    assert got["per_collective_bytes_per_chip"] == (
        want["per_collective_bytes_per_chip"])
    assert got["attn_kv_len"] == want["attn_kv_len"]
    assert got["figures"] == "data sheet" and got["link_bytes_per_s"] == 450e9


def test_tp_that_does_not_divide_the_heads_raises_in_preflight():
    """llama-debug's 4 q heads under tp 8 no longer raise: attention runs
    whole on every tp rank (the replicated fallback), and chapter 07's
    preflight steps on meta and prices each leaf as JAX's shardings lay it
    out (q and kv sharded in fractions of a head, the MLP on its columns),
    byte for byte."""
    from distributed_training_guide_tpu_torch.chapters import c07_tp_fsdp

    rep = c07_tp_fsdp.main(["-m", "llama-debug", "-s", "32", "--preflight",
                            "--preflight-world", "8", "--tensor-parallel",
                            "8"])
    jt = JTrainer(bundle=jget_model("llama-debug"), optimizer=jadamw(1e-3),
                  plan=jmake_plan("tp_fsdp", jmake_mesh(tp=8)),
                  donate=False)
    want = _jax_shard_bytes(jt)
    assert rep["lowered"] and rep["n_devices"] == 8
    assert rep["per_device_param_bytes"] == want["params"]


def test_405b_at_the_reference_64_gpu_shape():
    """fsdp 8 x tp 8, fp32 AdamW: params, grads and two moments, 16 bytes
    a parameter over 64 GPUs, within 0.1% (the norms, replicated, are the
    difference), through chapter 05's entry point."""
    from distributed_training_guide_tpu_torch.chapters import c05_llama405b

    rep = c05_llama405b.main(["-m", "llama-3.1-405b", "-s", "4096", "-b",
                              "1", "--tensor-parallel", "8", "--preflight",
                              "--preflight-world", "64"])
    n = get_model("llama-3.1-405b").num_params()
    assert rep["n_devices"] == 64 and rep["strategy"] == "tp_fsdp"
    assert rep["per_device_param_bytes"] == pytest.approx(4 * n / 64,
                                                          rel=1e-3)
    assert rep["per_device_total_bytes"] == pytest.approx(16 * n / 64,
                                                          rel=1e-3)
    assert not rep["fits"] and rep["comm"]["target"] == "h100"


def test_one_405b_layer_of_fp32_adamw_does_not_fit_one_card():
    from distributed_training_guide_tpu_torch.chapters import c05_llama405b

    limit = (torch.cuda.mem_get_info()[1] if torch.cuda.is_available()
             else 80e9)     # the card's own memory, else the data sheet's
    argv = ["-m", "llama-3.1-405b", "-s", "4096", "-b", "1", "--preflight"]
    kw = {"model_overrides": {"num_layers": 1}}
    fp32 = c05_llama405b.main(argv, **kw)
    n = get_model("llama-3.1-405b", num_layers=1).num_params()
    assert fp32["per_device_total_bytes"] == pytest.approx(16 * n, rel=1e-3)
    assert not fp32["fits"] and fp32["device_bytes_limit"] == limit
    small = c05_llama405b.main(argv + ["--param-dtype", "bfloat16",
                                       "--optimizer", "adafactor"], **kw)
    assert small["fits"]
    assert small["per_device_total_bytes"] == pytest.approx(4 * n, rel=1e-2)


@pytest.mark.parametrize("strategy,mesh", [
    ("pp_fsdp", {"pp": 2, "fsdp": 2, "cp": 2}),
    ("fsdp", {"fsdp": 2, "cp": 4}),
    ("pp_tp", {"pp": 2, "tp": 2, "cp": 2})])
def test_cp_and_pp_priced_as_far_as_jax_prices_them(strategy, mesh):
    """Under context and pipeline parallelism the preflight runs the step
    on meta (the ring's exchanges and the pipeline's hops move nothing
    there), the per-device param and optimizer bytes equal JAX's
    ``shard_shape`` bytes (the [L] axis on pp), and ``comm_roofline``'s
    rows equal JAX's: its table prices no cp or pp traffic, and neither
    does the port's."""
    jt = JTrainer(bundle=jget_model("llama-debug"), optimizer=jadamw(1e-3),
                  plan=jmake_plan(strategy, jmake_mesh(**mesh)),
                  donate=False)
    want = _jax_shard_bytes(jt)
    want_comm = jpre.comm_roofline(jt, global_batch=GLOBAL_BATCH,
                                   seq_length=SEQ, device_kind="v5p")
    with fake_group(8):
        plan = make_plan(strategy, make_mesh(device="cpu", **mesh))
        t = Trainer(bundle=get_model("llama-debug"),
                    optimizer=topt.adamw_cosine(1e-3), plan=plan,
                    device="meta")
        got = run_preflight(t, global_batch=GLOBAL_BATCH, seq_length=SEQ)
        counters = _port_counter_bytes(t)
        comm = comm_roofline(t, global_batch=GLOBAL_BATCH, seq_length=SEQ)
    assert got["lowered"] and got["per_device_param_bytes"] == want["params"]
    assert got["per_device_opt_state_bytes"] - counters == want["opt"]
    assert comm["per_collective_bytes_per_chip"] == (
        want_comm["per_collective_bytes_per_chip"])
