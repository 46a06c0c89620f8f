"""Worker of ``tests/test_torch_dist.py``: one rank of a gloo gang started
by the port's own ``launch.local`` (the torchrun env contract), running
every sharding plan of the port on the CPU. It imports no jax: the JAX
reference runs in the test process, which hands over the initial params
and the batches as ``.npz`` files in ``--dir``; rank 0 writes each
scenario's results back there.

Scenarios (each on the same llama-debug weights, fp32, AdamW 1e-3):
- ``traj_<name>``: two steps of ddp, zero1, zero2 (grad_accum 2),
  fsdp 4, tp 4 (llama-debug's 2 kv heads split in halves) and tp_fsdp
  2 x 2 on this rank's rows of the batch, and fsdp under remat "all" and
  tp_fsdp under "attn" (the per-layer gathers rerun in the recompute);
  the losses, grad norms, final params (gathered) and what each rank
  holds;
- ``uneven``: one ddp step where the -100 labels fall unevenly on ranks;
- ``restore``: save under fsdp 4 after one step, restore under tp_fsdp
  2 x 2, take the next step; beside it the next step of the fsdp run;
- ``refusal``: a ``Trainer`` under the ``single`` plan on the 4-rank
  mesh, which must raise rather than train each rank alone.
"""
import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_training_guide_tpu_torch.checkpoint import (  # noqa: E402
    CheckpointIO, restore_train_state, stamp_host_state)
from distributed_training_guide_tpu_torch.launch import (  # noqa: E402
    maybe_initialize_distributed)
from distributed_training_guide_tpu_torch.models import (  # noqa: E402
    from_jax, get_model)
from distributed_training_guide_tpu_torch.parallel import (  # noqa: E402
    make_mesh, make_plan)
from distributed_training_guide_tpu_torch.train import (  # noqa: E402
    optimizer as topt)
from distributed_training_guide_tpu_torch.train.state import (  # noqa: E402
    host_state_dict, named_leaves)
from distributed_training_guide_tpu_torch.train.step import (  # noqa: E402
    Trainer)

# (name, strategy, mesh axes, grad_accum, remat policy or None)
TRAJECTORIES = [("ddp", "ddp", {}, 1, None), ("zero1", "zero1", {}, 1, None),
                ("zero2", "zero2", {}, 2, None),
                ("fsdp", "fsdp", {"fsdp": 4}, 1, None),
                ("tp", "tp", {"tp": 4}, 1, None),
                ("tp_fsdp", "tp_fsdp", {"fsdp": 2, "tp": 2}, 1, None),
                ("fsdp_remat_all", "fsdp", {"fsdp": 4}, 1, "all"),
                ("tp_fsdp_remat_attn", "tp_fsdp", {"fsdp": 2, "tp": 2}, 1,
                 "attn")]


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _trainer(strategy, mesh_kw, accum=1, remat=None):
    plan = make_plan(strategy, make_mesh(device="cpu", **mesh_kw))
    return Trainer(bundle=get_model("llama-debug", dtype=torch.float32),
                   optimizer=topt.adamw_cosine(1e-3), plan=plan,
                   grad_accum=accum, device="cpu", remat=remat is not None,
                   remat_policy=remat or "all")


def _rows(trainer, ids: np.ndarray) -> dict:
    """This rank's rows of a global batch ([B, S] or [A, B, S])."""
    plan = trainer.plan
    n = ids.shape[-2] // plan.data_parallel_size
    mine = ids[..., plan.data_rank * n:(plan.data_rank + 1) * n, :]
    return torch.from_numpy(np.ascontiguousarray(mine)).long()


def _full_params(trainer, state) -> dict:
    ps = trainer.plan_state
    return {p: ps.plan.dtensor(t.detach(), ps.specs[p],
                               ps.shapes[p]).full_tensor().numpy()
            for p, t in named_leaves(state.params)}


def _record_grad_shapes(state) -> dict:
    """Shapes of the grads the optimizer is handed at each step (zero2:
    each rank's shard only), by the id of the tensor it steps."""
    seen: dict = {}

    def hook(opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    seen[id(p)] = list(p.grad.shape)

    state.opt_state.optimizer.register_step_pre_hook(hook)
    return seen


def _held(trainer, state, grad_shapes) -> dict:
    """What this rank holds: each param's local shape, its optimizer
    shard's shape and the shapes the last step handed the optimizer."""
    opt = state.opt_state.optimizer
    sh = state.sharding
    out = {}
    for path, p in named_leaves(state.params):
        leaf = sh.update_leaf(path, p)
        out[path] = {
            "param": list(p.shape),
            "exp_avg": list(opt.state[leaf]["exp_avg"].shape),
            "grad": grad_shapes[id(leaf)],
            "placements": [f"Shard({x.dim})" if x.is_shard() else
                           "Replicate" for x in trainer.plan_state.plan.
                           placements(trainer.plan_state.specs[path])],
        }
    return out


def trajectories(params, batches, out_dir, rank):
    facts = {}
    for name, strategy, mesh_kw, accum, remat in TRAJECTORIES:
        t = _trainer(strategy, mesh_kw, accum, remat)
        state = t.init_state_from_params(params)
        grad_shapes = _record_grad_shapes(state)
        ids = batches[f"accum{accum}"]
        batch = {"input_ids": _rows(t, ids), "labels": _rows(t, ids)}
        losses, norms = [], []
        for _ in range(2):
            state, m = t.step_fn(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        full = _full_params(t, state)
        facts[name] = _held(t, state, grad_shapes)
        if rank == 0:
            np.savez(out_dir / f"traj_{name}.npz", losses=losses,
                     norms=norms, **{f"p/{k}": v for k, v in full.items()})
    if rank == 0:
        (out_dir / "held.json").write_text(json.dumps(facts))


def uneven(params, batches, out_dir, rank):
    t = _trainer("ddp", {})
    state = t.init_state_from_params(params)
    ids = batches["accum1"]
    labels = batches["uneven_labels"]
    state, m = t.step_fn(state, {"input_ids": _rows(t, ids),
                                 "labels": _rows(t, labels)})
    if rank == 0:
        np.savez(out_dir / "uneven.npz", loss=float(m["loss"]))


def restore(params, batches, out_dir, rank):
    ids = batches["accum1"]
    exp = out_dir / "ckpt"
    t = _trainer("fsdp", {"fsdp": 4})
    state = t.init_state_from_params(params)
    batch = {"input_ids": _rows(t, ids), "labels": _rows(t, ids)}
    state, _ = t.step_fn(state, batch)
    io = CheckpointIO(exp)
    host = stamp_host_state(host_state_dict(), t)
    host["global_step"] = 1
    io.save(state, host)
    io.close()
    state, m = t.step_fn(state, batch)
    straight = float(m["loss"])

    t2 = _trainer("tp_fsdp", {"fsdp": 2, "tp": 2})
    io2 = CheckpointIO(exp)
    state2, host2 = restore_train_state(io2, t2)
    batch2 = {"input_ids": _rows(t2, ids), "labels": _rows(t2, ids)}
    state2, m2 = t2.step_fn(state2, batch2)
    if rank == 0:
        np.savez(out_dir / "restore.npz", straight=straight,
                 resumed=float(m2["loss"]), step=state2.step,
                 global_step=host2["global_step"],
                 count=state2.opt_state.count)


def refusal(out_dir, rank):
    try:
        _trainer("single", {})
        msg = None
    except ValueError as exc:
        msg = str(exc)
    if rank == 0:
        (out_dir / "refusal.json").write_text(json.dumps({"error": msg}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    args = ap.parse_args()
    out_dir = Path(args.dir)
    torch.set_num_threads(1)
    maybe_initialize_distributed("cpu")
    rank = int(os.environ["RANK"])
    init = dict(np.load(out_dir / "init.npz"))
    params = from_jax.params_from_numpy(_unflatten(init), device="cpu")
    batches = dict(np.load(out_dir / "batches.npz"))
    trajectories(params, batches, out_dir, rank)
    uneven(params, batches, out_dir, rank)
    restore(params, batches, out_dir, rank)
    refusal(out_dir, rank)
    torch.distributed.destroy_process_group()
    if rank == 0:
        (out_dir / "done").write_text("ok")


if __name__ == "__main__":
    main()
