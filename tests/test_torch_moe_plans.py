"""Chapter 10 of the port: a mixture of experts under the sharding plans,
outside the gloo gang of ``tests/test_torch_dist.py`` (which holds every
plan's trajectory, grads and checkpoint against the JAX package).

Here: ``chapters/c10_moe.py`` trains on 2 gloo ranks through the port's
``launch.local`` (ep 2, ragged); the preflight runs the step on
the meta device under ep 4 x fsdp 2 and ep 8 for moe-debug and
qwen3-30b-a3b, its per-device param and optimizer bytes equal JAX's
``NamedSharding.shard_shape`` bytes and its comm roofline's rows JAX's
(the ``ep_exchange`` row among them); ``LocalLayout.token_split`` gives
each rank's tokens their global b-major index; the Trainer refuses the
ragged exchange under cp, pp and tp as the JAX Trainer does; and a
plan at world 1 is the single device's program (no token split)."""
import os
import subprocess
import sys
from pathlib import Path

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
from distributed_training_guide_tpu_torch.parallel.plans import LocalLayout
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train.preflight import (
    comm_roofline, fake_group, run_preflight)
from distributed_training_guide_tpu_torch.train.step import Trainer
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]
GLOBAL_BATCH, SEQ = 8, 32


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_chapter_10_trains_on_two_gloo_ranks(tmp_path):
    """c10_moe through ``launch.local --nproc 2`` at ep 2 with the ragged
    exchange: the plan is ``ep``, two steps run and the info dict carries
    ``moe_dropped_frac`` 0 (the dense dispatch under ep runs in the
    ``tests/test_torch_dist.py`` gang)."""
    dispatch = "ragged"
    out = subprocess.run(
        [sys.executable, "-m", "distributed_training_guide_tpu_torch.launch."
         "local", "--nproc", "2", "--log-dir", str(tmp_path / "logs"), "--",
         sys.executable, "-m",
         "distributed_training_guide_tpu_torch.chapters.c10_moe", "-m",
         "moe-debug", "-d", "synthetic:3000", "-s", "32", "-b", "2",
         "--max-steps", "2", "--log-freq", "2", "--moe-dispatch", dispatch,
         "--device", "cpu"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=180)
    logs = "\n".join(p.read_text()[-3000:]
                     for p in sorted((tmp_path / "logs").glob("*.err")))
    assert out.returncode == 0, out.stderr[-3000:] + logs
    assert "strategy=ep" in out.stderr
    assert "'global_step': 2" in out.stderr
    assert "'moe_dropped_frac': 0.0" in out.stderr


def _jax_shard_bytes(trainer) -> dict:
    params = jpre._per_device_bytes(trainer.param_shapes,
                                    trainer.param_shardings)
    opt_shapes = jax.eval_shape(trainer.optimizer.init, trainer.param_shapes)
    opt = jpre._per_device_bytes(opt_shapes, trainer.opt_shardings_device)
    counters = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                   for x in jax.tree.leaves(opt_shapes) if x.ndim == 0)
    return {"params": params, "opt": opt - counters}


PREFLIGHT_CASES = [("moe-debug", "ep_fsdp", {"ep": 4, "fsdp": 2}, "ragged"),
                   ("moe-debug", "ep", {"ep": 8}, "dense"),
                   ("qwen3-30b-a3b", "ep_fsdp", {"ep": 4, "fsdp": 2},
                    "ragged")]
# full width, depth cut (the meta step's host time grows with the layers)
PREFLIGHT_LAYERS = 4


@pytest.mark.parametrize("model,strategy,mesh,dispatch", PREFLIGHT_CASES,
                         ids=[f"{m}-{s}-{d}" for m, s, _, d in
                              PREFLIGHT_CASES])
def test_preflight_prices_expert_parallelism_as_jax(model, strategy, mesh,
                                                    dispatch):
    """The step runs on meta through the expert exchange (nothing is read
    back: the window's offset is a tensor); per-device bytes equal JAX's
    shard shapes (each rank's E / ep experts) and the comm rows equal
    JAX's, ``ep_exchange`` priced."""
    over = dict(moe_dispatch=dispatch, num_layers=PREFLIGHT_LAYERS)
    jt = JTrainer(bundle=jget_model(model, **over),
                  optimizer=jadamw(1e-3),
                  plan=jmake_plan(strategy, jmake_mesh(**mesh)),
                  donate=False)
    want = _jax_shard_bytes(jt)
    want_comm = jpre.comm_roofline(jt, global_batch=GLOBAL_BATCH,
                                   seq_length=SEQ, device_kind="v5p")
    with fake_group(8):
        plan = make_plan(strategy, make_mesh(device="cpu", **mesh))
        t = Trainer(bundle=get_model(model, **over),
                    optimizer=topt.adamw_cosine(1e-3), plan=plan,
                    device="meta")
        assert (t.plan_state.moe_ep is not None) == (dispatch == "ragged")
        got = run_preflight(t, global_batch=GLOBAL_BATCH, seq_length=SEQ)
        state = t.init_state(0)
        opt = state.opt_state.optimizer
        counters = sum(s.numel() * s.element_size() for p in opt.state
                       for s in topt.state_slots(opt, p).values()
                       if s.ndim == 0)
        comm = comm_roofline(t, global_batch=GLOBAL_BATCH, seq_length=SEQ)
    assert got["lowered"] and got["per_device_param_bytes"] == want["params"]
    assert got["per_device_opt_state_bytes"] - counters == want["opt"]
    assert comm["per_collective_bytes_per_chip"] == (
        want_comm["per_collective_bytes_per_chip"])
    assert comm["per_collective_bytes_per_chip"]["ep_exchange"] > 0


@pytest.mark.parametrize("mesh,want_rows,seq", [
    ({"ep": 2, "cp": 2}, [(0, 0), (0, 16), (2, 0), (2, 16)], 32),
    ({"dp": 2, "ep": 2}, [(0, 0), (2, 0), (4, 0), (6, 0)], 16)])
def test_token_split_gives_each_rank_its_global_token_index(mesh, want_rows,
                                                            seq):
    """On a world of 4 (each rank's mesh coordinates taken in turn), each
    rank's [2, 16] routed tokens (its rows; under cp its shard of a
    32-token sequence) carry their global index row * seq + position, the
    single device's b-major order; the routing exchange spans every axis
    that splits tokens (4 ranks), the ep exchange ep."""
    from distributed_training_guide_tpu_torch.models import moe
    from distributed_training_guide_tpu_torch.parallel.mesh import (
        AXIS_NAMES, mesh_shape_for)

    shape = dict(zip(AXIS_NAMES, mesh_shape_for(4, **mesh)))
    with fake_group(4):
        plan = make_plan("ep", make_mesh(device="cpu", **mesh))
        cfg = get_model("moe-debug").config
        specs = _flat(plan.param_specs(moe.param_logical_axes(cfg),
                                       moe.param_shapes(cfg)))
        for rank, (row0, col0) in enumerate(want_rows):
            coords, r = {}, rank
            for axis in reversed(AXIS_NAMES):
                coords[axis], r = r % shape[axis], r // shape[axis]
            plan.mesh.get_local_rank = coords.__getitem__
            layout = LocalLayout(plan, specs, cfg, moe.LAYOUT_PATHS)
            split = layout.token_split(torch.zeros(2, 16, 64))
            assert split.route.size == 4 and split.ep.size == 2
            want = ((row0 + torch.arange(2))[:, None] * seq
                    + (col0 + torch.arange(16))[None, :])
            assert torch.equal(split.token_index.reshape(2, 16), want), rank


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("strategy,mesh,what", [
    ("ep", {"ep": 2, "cp": 2}, "context"),
    ("pp", {"pp": 2}, "pipeline"),
    ("tp", {"tp": 2}, "tensor")])
def test_ragged_dispatch_is_refused_where_jax_refuses_it(strategy, mesh,
                                                         what):
    """The ragged exchange runs over the data axes only: under cp, pp or
    tp the Trainer raises the JAX Trainer's ValueError; the dense dispatch
    runs there."""
    with fake_group(4):
        plan = make_plan(strategy, make_mesh(device="cpu", **mesh))
        with pytest.raises(ValueError, match=f"under {what} parallelism"):
            Trainer(bundle=get_model("moe-debug", moe_dispatch="ragged"),
                    optimizer=topt.adamw_cosine(1e-3), plan=plan,
                    device="meta")
        Trainer(bundle=get_model("moe-debug"),
                optimizer=topt.adamw_cosine(1e-3), plan=plan, device="meta")


@pytest.mark.parametrize("strategy", ["ep", "ep_fsdp", "tp", "ddp"])
def test_a_plan_at_world_one_routes_as_the_single_device(strategy):
    """At world 1 every axis is one rank: no token split (the dense and
    ragged dispatch are the single device's own) and no expert exchange,
    which is what lets the card's world-1 runs equal the single plan."""
    from distributed_training_guide_tpu_torch.models import moe

    with fake_group(1):
        plan = make_plan(strategy, make_mesh(device="cpu"))
        t = Trainer(bundle=get_model("moe-debug", moe_dispatch="ragged"),
                    optimizer=topt.adamw_cosine(1e-3), plan=plan,
                    device="meta")
        ps = t.plan_state
        assert ps.moe_ep is None and ps.layout.ep_exchange is None
        assert ps.layout.token_split(torch.zeros(2, 16, 64)) is None
        assert not ps.layout.gathered_by_dispatch
        assert moe.make_ragged_ep_dispatch(None, t.bundle.config) is None
