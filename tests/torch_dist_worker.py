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
  holds; and ``overlap.npz`` / ``overlap.json``: fsdp 4, zero1, tp_fsdp
  2 x 2 and zero2 (grad_accum 2) under the overlap schedule against the
  same plans unscheduled, both with ``loss_chunks`` 4 (the same fused
  loss), their losses, norms and params, and the schedule's gather
  counts; ``loss_chunks`` 4 under tp 4 (the fused loss, vocab-parallel);
  and the first step's grads of tp 4 (sequence
  parallelism) under the fused vocab-parallel loss and under the dense
  loss;
- ``uneven``: one ddp step where the -100 labels fall unevenly on ranks;
- ``restore``: save under fsdp 4 after one step, restore under tp_fsdp
  2 x 2, take the next step; beside it the next step of the fsdp run;
- ``refusal``: a ``Trainer`` under the ``single`` plan on the 4-rank
  mesh, which must raise rather than train each rank alone;
- ``guards``: ``process0_first`` and ``process_ordered`` (odd ranks
  first), each rank appending to ``guards.txt`` inside the block;
- ``traj_gpt2_tp``: two steps of gpt2-debug under tp 4 (one head a rank,
  the fused QKV sharded on its trailing heads axis, the vocab-parallel
  tied head) from its own weights;
- ``traj_neox_tp_fsdp``: two steps of neox-debug under tp 2 x fsdp 2 (the
  parallel residual's two partial sums reduced once, the fused QKV
  gathered on fsdp and sharded on tp);
- ``traj_lora_tp``: two LoRA-only steps of llama-debug under tp 4 without
  sequence parallelism (the adapters of wq / wv / wo / down, whole on
  every rank where their base leaf is tp-sharded: their grads summed over
  tp);
- ``moe_<name>``: two steps of moe-debug under each plan of ``MOE_RUNS``
  (ep 4, ep 2 x fsdp 2, ddp 4 and fsdp 4 under the dense and the ragged
  dispatch; pp 2 x dp 2 and ep 2 x cp 2 dense, and both again at capacity
  factor 0.5, where pairs drop; tp 2 x dp 2 dense on a variant with
  qwen1.5-moe's wiring, its shared expert among them; ep 4 and ep 2 x
  fsdp 2 ragged under the overlap schedule: the double-buffered ring),
  each
  rank fed ``data/loader.py:local_batch``: losses, ``moe_dropped_frac``,
  final params and what each rank holds; the grads of the first step
  under ddp 4 and tp 2 x dp 2 at ``router_aux_coef`` 1 (``moe_grads``);
  and an ep 4 state saved after a step, restored under ep 2 x fsdp 2 and
  under fsdp 4 (``moe.json``).

``--scenario`` runs one other scenario alone instead, for its own test file:
- ``sharded_load`` (4 ranks, ``tests/test_torch_hf_convert_runs.py``): a
  converted checkpoint in ``--dir/conv`` loaded under fsdp 4, tp 4 and
  tp_fsdp 2 x 2, and a converted Qwen3-MoE in ``--dir/conv_moe`` under
  ep_fsdp 2 x 2, each rank reading its own slices, against the whole
  load's shards, and one step from each against one from the whole params;
- ``quantize`` (4 ranks, ``tests/test_torch_precision.py``): adam8bit's
  block quantization of a leaf whose tp shards split its blocks, against
  the single-device quantizer, and a tp 4 adam8bit run over such a leaf
  through a save and restore;
- ``offload`` (2 ranks, ``tests/test_torch_offload.py``): fsdp 2 with the
  params and optimizer state offloaded, under fp32 and adam8bit, against
  the same runs without, also through a save and restore and under the
  guard's skip;
- ``cp_pp`` (4 ranks, ``tests/test_torch_cp_pp.py``): two steps of each
  context- and pipeline-parallel plan of ``CP_PP_RUNS`` (the ring at cp 4,
  cp 2 x fsdp 2 and cp 2 x tp 2, Ulysses at cp 2 and at cp 4 (kv heads
  not divisible), neox-debug's ring at cp 4, pp 2 x dp 2, pp 4 on llama-debug cut to 4 layers, pp 2 x fsdp 2,
  pp 2 x tp 2, pp 2 x cp 2 under the ring and Ulysses), each rank fed
  ``data/loader.py:local_batch`` of the global batch; one ring step at cp
  4 on labels with -100 at shard edges; and a pp 2 x fsdp 2 state saved
  after a step and restored under fsdp 4.
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


LORA_TARGETS = ("wq", "wv", "wo", "down")


def _trainer(strategy, mesh_kw, accum=1, remat=None, model="llama-debug",
             lora=False, sp=None, overlap=False, loss_chunks=0):
    from distributed_training_guide_tpu_torch.models.lora import lora_bundle

    plan = make_plan(strategy, make_mesh(device="cpu", **mesh_kw),
                     sequence_sharded=sp)
    bundle = get_model(model, dtype=torch.float32)
    if lora:
        bundle = lora_bundle(bundle, rank=4, targets=LORA_TARGETS)
    return Trainer(bundle=bundle, optimizer=topt.adamw_cosine(1e-3),
                   plan=plan, grad_accum=accum, device="cpu",
                   remat=remat is not None, remat_policy=remat or "all",
                   lora_only=lora, overlap_schedule=overlap,
                   loss_chunks=loss_chunks)


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


def _two_steps(t, params, ids, out_dir, name, rank):
    state = t.init_state_from_params(params)
    batch = {"input_ids": _rows(t, ids), "labels": _rows(t, ids)}
    losses = []
    for _ in range(2):
        state, m = t.step_fn(state, batch)
        losses.append(float(m["loss"]))
    full = _full_params(t, state)
    if rank == 0:
        np.savez(out_dir / f"traj_{name}.npz", losses=losses,
                 **{f"p/{k}": v for k, v in full.items()})


def families(batches, out_dir, rank):
    """gpt2-debug under tp 4, neox-debug under tp 2 x fsdp 2, and LoRA on
    llama-debug under tp 4 without sequence parallelism, each from its
    own JAX init."""
    ids = batches["accum1"]
    for name, strategy, mesh_kw, kw in (
            ("gpt2_tp", "tp", {"tp": 4}, dict(model="gpt2-debug")),
            ("neox_tp_fsdp", "tp_fsdp", {"fsdp": 2, "tp": 2},
             dict(model="neox-debug")),
            ("lora_tp", "tp", {"tp": 4}, dict(lora=True, sp=False))):
        init = dict(np.load(out_dir / f"{name}_init.npz"))
        params = from_jax.params_from_numpy(_unflatten(init), device="cpu")
        _two_steps(_trainer(strategy, mesh_kw, **kw), params, ids, out_dir,
                   name, rank)


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


# (name, strategy, mesh axes, grad_accum): scheduled against unscheduled
OVERLAP_RUNS = [("fsdp", "fsdp", {"fsdp": 4}, 1), ("zero1", "zero1", {}, 1),
                ("tp_fsdp", "tp_fsdp", {"fsdp": 2, "tp": 2}, 1),
                ("zero2", "zero2", {}, 2)]


def _run(t, params, batch, steps=2) -> tuple:
    state = t.init_state_from_params(params)
    losses, norms = [], []
    for _ in range(steps):
        state, m = t.step_fn(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, _full_params(t, state)


def overlap(params, batches, out_dir, rank):
    """The overlap schedule and the fused loss under the plans: each run's
    losses, norms and gathered params in ``overlap.npz``, keyed by run."""
    out, facts = {}, {}
    for name, strategy, mesh_kw, accum in OVERLAP_RUNS:
        ids = batches[f"accum{accum}"]
        for sched in (False, True):
            t = _trainer(strategy, mesh_kw, accum, overlap=sched,
                         loss_chunks=4)
            batch = {"input_ids": _rows(t, ids), "labels": _rows(t, ids)}
            losses, norms, full = _run(t, params, batch)
            key = f"{name}/{'sched' if sched else 'unsched'}"
            out.update({f"{key}/losses": losses, f"{key}/norms": norms,
                        **{f"{key}/p/{k}": v for k, v in full.items()}})
            if sched:
                facts[name] = dict(t.plan_state.layer_schedule.counts)
    # (fsdp's loss_chunks run is the unscheduled one above)
    ids = batches["accum1"]
    t = _trainer("tp", {"tp": 4}, loss_chunks=4)
    batch = {"input_ids": _rows(t, ids), "labels": _rows(t, ids)}
    losses, _, full = _run(t, params, batch)
    out.update({"chunks_tp/losses": losses,
                **{f"chunks_tp/p/{k}": v for k, v in full.items()}})
    # the grad-level pin of the vocab-parallel fused loss (tp 4 with
    # sequence parallelism) against the dense loss
    for name, chunks in (("fused", 4), ("dense", 0)):
        t = _trainer("tp", {"tp": 4}, loss_chunks=chunks)
        state = t.init_state_from_params(params)
        batch = {"input_ids": _rows(t, ids), "labels": _rows(t, ids)}
        paths = [p for p, _ in named_leaves(state.params)]
        got = _first_grads(t, state, batch, paths)
        out.update({f"grads_{name}/{p}": g for p, g in got.items()})
    if rank == 0:
        np.savez(out_dir / "overlap.npz", **out)
        (out_dir / "overlap.json").write_text(json.dumps(facts))


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


def guards(out_dir, rank):
    """``process0_first`` and ``process_ordered`` on the gang: each rank
    appends its name to one file inside the guarded block, the first group
    after a pause, so a guard that let the rest in early shows."""
    import time

    from distributed_training_guide_tpu_torch.utils import (process0_first,
                                                            process_ordered)

    path = out_dir / "guards.txt"

    def mark(tag):
        with open(path, "a") as fp:
            fp.write(f"{tag}{rank}\n")

    with process0_first():
        if rank == 0:
            time.sleep(0.3)
        mark("p0first:")
    with process_ordered(rank % 2 == 1):
        if rank % 2 == 1:
            time.sleep(0.3)
        mark("odd_first:")


def _all(flag: bool) -> bool:
    """True when ``flag`` holds on every rank."""
    t = torch.tensor([int(flag)])
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MIN)
    return bool(t.item())


def sharded_load(out_dir, rank):
    from distributed_training_guide_tpu_torch.models.hf_convert import (
        load_pretrained)

    conv = out_dir / "conv"
    gen = np.random.RandomState(0)
    ids = gen.randint(0, 512, (8, 32))
    result = {}
    for name, strategy, mesh_kw in (("fsdp", "fsdp", {"fsdp": 4}),
                                    ("tp", "tp", {"tp": 4}),
                                    ("tp_fsdp", "tp_fsdp",
                                     {"fsdp": 2, "tp": 2})):
        t = _trainer(strategy, mesh_kw)
        ps = t.plan_state
        mine = load_pretrained(t.bundle, t.plan, conv, device="cpu")
        whole = load_pretrained(t.bundle, None, conv, device="cpu")
        whole_flat = dict(named_leaves(whole))
        equal = all(torch.equal(local, t.plan.shard(ps.specs[path],
                                                     whole_flat[path]))
                    for path, local in named_leaves(mine))
        sharded_leaves = sum(
            tuple(local.shape) != tuple(whole_flat[path].shape)
            for path, local in named_leaves(mine))
        batch = {"input_ids": _rows(t, ids), "labels": _rows(t, ids)}
        _, m1 = t.step_fn(t.init_state_from_params(mine, sharded=True),
                          batch)
        _, m2 = t.step_fn(t.init_state_from_params(whole), batch)
        result[name] = {"equal": _all(equal),
                        "sharded_leaves": sharded_leaves,
                        "step_equal": _all(float(m1["loss"])
                                           == float(m2["loss"]))}
    # a converted Qwen3-MoE checkpoint under ep 2 x fsdp 2: the expert
    # stacks' experts axis on ep, their embed axis on fsdp
    bundle = get_model(f"hf:{out_dir / 'hf_moe'}", dtype=torch.float32,
                       moe_dispatch="ragged")
    t = Trainer(bundle=bundle, optimizer=topt.adamw_cosine(1e-3),
                plan=make_plan("ep_fsdp", make_mesh(device="cpu", ep=2,
                                                    fsdp=2)), device="cpu")
    mine = load_pretrained(bundle, t.plan, out_dir / "conv_moe",
                           device="cpu")
    whole_params = load_pretrained(bundle, None, out_dir / "conv_moe",
                                   device="cpu")
    whole = dict(named_leaves(whole_params))
    local = dict(named_leaves(mine))
    r = {"equal": _all(all(torch.equal(v, t.plan.shard(
             t.plan_state.specs[path], whole[path]))
                           for path, v in local.items())),
         "sharded_leaves": sum(tuple(v.shape) != tuple(whole[path].shape)
                               for path, v in local.items()),
         "expert_shapes": {leaf: [list(whole[f"layers/moe/{leaf}"].shape),
                                  list(local[f"layers/moe/{leaf}"].shape)]
                           for leaf in ("gate", "up", "down")}}
    batch = {"input_ids": _rows(t, ids % 128), "labels": _rows(t, ids % 128)}
    _, m1 = t.step_fn(t.init_state_from_params(mine, sharded=True), batch)
    _, m2 = t.step_fn(t.init_state_from_params(whole_params), batch)
    r["step_equal"] = _all(float(m1["loss"]) == float(m2["loss"]))
    result["moe_ep_fsdp"] = r
    if rank == 0:
        (out_dir / "sharded_load.json").write_text(json.dumps(result))


def quantize(out_dir, rank):
    from distributed_training_guide_tpu_torch.parallel.plans import (
        LeafLayout)
    from distributed_training_guide_tpu_torch.train.precision import (
        dequantize_blockwise, dequantize_sharded, quantize_blockwise,
        quantize_sharded, straddles_shards)

    plan = make_plan("tp", make_mesh(device="cpu", tp=4))
    gen = np.random.RandomState(1)
    result = {}
    for d in (520, 500):
        x = torch.from_numpy(gen.standard_normal((6, d)).astype(np.float32))
        spec = (None, "tp")
        layout = LeafLayout(plan, spec, (6, d))
        cols = plan.shard(spec, torch.arange(d)[None, :])[0]
        for sqrt in (False, True):
            v = x.abs() if sqrt else x
            want = quantize_blockwise(v, 128, sqrt_domain=sqrt)
            got = quantize_sharded(plan.shard(spec, v), 128, sqrt, layout)
            back = dequantize_sharded(got, sqrt, layout, 128)
            result[f"{d}-{'nu' if sqrt else 'mu'}"] = {
                "straddles": straddles_shards(layout, 128),
                "q": _all(torch.equal(got.q, want.q[:, cols])),
                "scale": _all(torch.equal(got.scale, want.scale)),
                "dequant": _all(torch.equal(back, dequantize_blockwise(
                    want, sqrt_domain=sqrt)[:, cols]))}
    # a tp 4 adam8bit run whose vocab shards (130 of 520) split the blocks,
    # saved after step 1 and restored into a fresh trainer
    exp = out_dir / "ckpt8"

    def trainer():
        return Trainer(bundle=get_model("llama-debug", dtype=torch.float32,
                                        vocab_size=520),
                       optimizer=topt.adamw_cosine(1e-3),
                       plan=make_plan("tp", make_mesh(device="cpu", tp=4)),
                       precision="adam8bit", device="cpu")
    ids = gen.randint(0, 520, (2, 32))
    t = trainer()
    state = t.init_state(0)
    batch = {"input_ids": _rows(t, ids), "labels": _rows(t, ids)}
    losses = []
    for step in range(3):
        state, m = t.step_fn(state, batch)
        losses.append(float(m["loss"]))
        if step == 0:
            io = CheckpointIO(exp)
            host = stamp_host_state(host_state_dict(), t)
            host["global_step"] = 1
            io.save(state, host)
            io.close()
    t2 = trainer()
    state2, _ = restore_train_state(CheckpointIO(exp), t2)
    resumed = []
    for _ in range(2):
        state2, m = t2.step_fn(state2, batch)
        resumed.append(float(m["loss"]))
    result["train"] = {"losses": losses, "resumed": resumed}
    if rank == 0:
        (out_dir / "quantize.json").write_text(json.dumps(result))


def offload(out_dir, rank):
    gen = np.random.RandomState(2)
    ids = gen.randint(0, 512, (4, 32))
    exp = out_dir / "ckpt_off"

    def trainer(precision, off, guard="off"):
        return Trainer(bundle=get_model("llama-debug", dtype=torch.float32),
                       optimizer=topt.adamw_cosine(1e-3),
                       plan=make_plan("fsdp", make_mesh(device="cpu",
                                                        fsdp=2)),
                       precision=precision, device="cpu", guard_policy=guard,
                       offload_opt_state=off, offload_params=off)

    def run(t, steps, state=None, save_at=None):
        state = t.init_state(0) if state is None else state
        batch = {"input_ids": _rows(t, ids), "labels": _rows(t, ids)}
        out = []
        for step in range(1, steps + 1):
            state, m = t.step_fn(state, batch)
            out.append([float(m["loss"]), float(m["grad_norm"])])
            if step == save_at:
                io = CheckpointIO(exp)
                host = stamp_host_state(host_state_dict(), t)
                host["global_step"] = step
                io.save(state, host)
                io.close()
        full = {p: v.tolist() for p, v in _full_params(t, state).items()}
        return out, full, state

    result = {}
    for precision in ("fp32", "adam8bit"):
        plain, pfull, _ = run(trainer(precision, False), 3)
        t = trainer(precision, True)
        off, ofull, state = run(t, 3, save_at=1)
        on_host = _all(state.offload.on_host(state))
        t2 = trainer(precision, True)
        restored, _ = restore_train_state(CheckpointIO(exp), t2)
        resumed, rfull, _ = run(t2, 2, state=restored)
        result[precision] = {
            "plain": plain, "offload": off, "resumed": resumed,
            "params_equal": pfull == ofull, "resumed_params_equal":
                rfull == pfull, "on_host": on_host,
            "bytes_on_host": state.offload.host_bytes(state)}
        import shutil

        torch.distributed.barrier()
        if rank == 0:
            shutil.rmtree(exp, ignore_errors=True)
        torch.distributed.barrier()
    os.environ["DTG_FAULT_NAN_LOSS_STEP"] = "1"
    try:
        plain, pfull, _ = run(trainer("fp32", False, "skip"), 3)
        off, ofull, _ = run(trainer("fp32", True, "skip"), 3)
    finally:
        del os.environ["DTG_FAULT_NAN_LOSS_STEP"]
    result["guard_skip"] = {"plain": plain, "offload": off,
                            "params_equal": pfull == ofull}
    if rank == 0:
        (out_dir / "offload.json").write_text(json.dumps(result))


# (name, init file, strategy, mesh axes, context_impl)
CP_PP_RUNS = [
    ("ring_cp4", "init", "ddp", {"cp": 4}, "ring"),
    ("ring_cp2_fsdp2", "init", "fsdp", {"cp": 2, "fsdp": 2}, "ring"),
    ("ring_cp2_tp2", "init", "tp", {"cp": 2, "tp": 2}, "ring"),
    ("ulysses_cp2", "init", "ddp", {"cp": 2}, "ulysses"),
    # cp 4 does not divide llama-debug's 2 kv heads: the gathered path
    ("ulysses_cp4", "init", "ddp", {"cp": 4}, "ulysses"),
    ("neox_ring_cp4", "neox_init", "ddp", {"cp": 4}, "ring"),
    ("pp2_dp2", "init", "pp", {"pp": 2}, "ring"),
    ("pp4", "l4_init", "pp", {"pp": 4}, "ring"),
    ("pp2_fsdp2", "init", "pp_fsdp", {"pp": 2, "fsdp": 2}, "ring"),
    ("pp2_tp2", "init", "pp_tp", {"pp": 2, "tp": 2}, "ring"),
    ("pp2_cp2_ring", "init", "pp", {"pp": 2, "cp": 2}, "ring"),
    ("pp2_cp2_ulysses", "init", "pp", {"pp": 2, "cp": 2}, "ulysses"),
]
_CP_PP_MODELS = {"init": ("llama-debug", {}),
                 "l4_init": ("llama-debug", {"num_layers": 4}),
                 "neox_init": ("neox-debug", {})}


def _cp_pp_trainer(init, strategy, mesh_kw, context_impl):
    model, over = _CP_PP_MODELS[init]
    plan = make_plan(strategy, make_mesh(device="cpu", **mesh_kw))
    return Trainer(bundle=get_model(model, dtype=torch.float32, **over),
                   optimizer=topt.adamw_cosine(1e-3), plan=plan,
                   device="cpu", context_impl=context_impl)


def _cp_pp_batch(t, ids, labels=None):
    """This rank's share of the global batch: its rows (M microbatches
    under pp), its sequence shard and shifted targets under cp."""
    from distributed_training_guide_tpu_torch.data.loader import local_batch

    plan, ps = t.plan, t.plan_state
    cp = plan.sizes["cp"]
    return local_batch(
        ids, ids if labels is None else labels, data_rank=plan.data_rank,
        data_size=plan.data_parallel_size,
        microbatches=1 if ps.pipeline is None else ps.pipeline.M,
        seq_rank=plan.mesh.get_local_rank("cp") if cp > 1 else 0,
        seq_size=cp)


# (name, init, strategy, mesh axes, dispatch)
MOE_RUNS = [
    ("ep4", "moe", "ep", {"ep": 4}, "dense"),
    ("ep4_ragged", "moe", "ep", {"ep": 4}, "ragged"),
    ("ep2_fsdp2", "moe", "ep_fsdp", {"ep": 2, "fsdp": 2}, "dense"),
    ("ep2_fsdp2_ragged", "moe", "ep_fsdp", {"ep": 2, "fsdp": 2}, "ragged"),
    ("ddp4", "moe", "ddp", {}, "dense"),
    ("ddp4_ragged", "moe", "ddp", {}, "ragged"),
    ("fsdp4", "moe", "fsdp", {"fsdp": 4}, "dense"),
    ("fsdp4_ragged", "moe", "fsdp", {"fsdp": 4}, "ragged"),
    ("tp2_shared", "moe_shared", "tp", {"tp": 2}, "dense"),
    ("pp2", "moe", "pp", {"pp": 2}, "dense"),
    ("ep2_cp2", "moe", "ep", {"ep": 2, "cp": 2}, "dense"),
    ("ddp4_cf05", "moe_cf05", "ddp", {}, "dense"),
    ("ep2_cp2_cf05", "moe_cf05", "ep", {"ep": 2, "cp": 2}, "dense"),
    ("ep4_ragged_ring", "moe", "ep", {"ep": 4}, "ragged"),
    ("ep2_fsdp2_ragged_ring", "moe", "ep_fsdp", {"ep": 2, "fsdp": 2},
     "ragged"),
]
# moe-debug with qwen1.5-moe's wiring (QKV biases, un-normalized top-k,
# a shared expert) at widths tp 2 divides
MOE_SHARED = dict(attn_bias=True, norm_topk_prob=False,
                  shared_expert_intermediate=32)
# moe-debug's weights at a capacity factor where the dense dispatch drops
MOE_CF05 = dict(capacity_factor=0.5)


def _moe_trainer(init, strategy, mesh_kw, dispatch, overlap=False, **over):
    plan = make_plan(strategy, make_mesh(device="cpu", **mesh_kw))
    over = {**{"moe_shared": MOE_SHARED, "moe_cf05": MOE_CF05}.get(init, {}),
            **over}
    return Trainer(bundle=get_model("moe-debug", dtype=torch.float32,
                                    moe_dispatch=dispatch, **over),
                   optimizer=topt.adamw_cosine(1e-3), plan=plan,
                   device="cpu", pp_microbatches=2,
                   overlap_schedule=overlap)


def _first_grads(t, state, batch, paths) -> dict:
    """The summed grads of ``paths`` the optimizer is handed at the first
    step (gathered whole)."""
    ps = t.plan_state
    leaves = dict(named_leaves(state.params))
    seen = {}

    def hook(opt, args, kwargs):
        for path in paths:
            g = leaves[path].grad
            seen[path] = ps.plan.dtensor(g.detach().clone(), ps.specs[path],
                                         ps.shapes[path]).full_tensor()
    handle = state.opt_state.optimizer.register_step_pre_hook(hook)
    t.step_fn(state, batch)
    handle.remove()
    return {p: g.numpy() for p, g in seen.items()}


def moe(out_dir, rank):
    batches = dict(np.load(out_dir / "batches.npz"))
    ids = batches["accum1"]
    params = {k: from_jax.params_from_numpy(
        _unflatten(dict(np.load(out_dir / f"{k}_init.npz"))), device="cpu")
        for k in ("moe", "moe_shared")}
    params["moe_cf05"] = params["moe"]
    facts = {}
    for name, init, strategy, mesh_kw, dispatch in MOE_RUNS:
        t = _moe_trainer(init, strategy, mesh_kw, dispatch,
                         overlap=name.endswith("_ring"))
        state = t.init_state_from_params(params[init])
        grad_shapes = _record_grad_shapes(state)
        batch = _cp_pp_batch(t, ids)
        losses, dropped = [], []
        for _ in range(2):
            state, m = t.step_fn(state, batch)
            losses.append(float(m["loss"]))
            dropped.append(float(m.get("moe_dropped_frac", -1.0)))
        full = _full_params(t, state)
        facts[name] = _held(t, state, grad_shapes)
        if rank == 0:
            np.savez(out_dir / f"moe_{name}.npz", losses=losses,
                     dropped=dropped,
                     **{f"p/{k}": v for k, v in full.items()})
    grads = {}
    for name, init, strategy, mesh_kw in (
            ("ddp4", "moe", "ddp", {}),
            ("tp2_shared", "moe_shared", "tp", {"tp": 2})):
        t = _moe_trainer(init, strategy, mesh_kw, "dense",
                         router_aux_coef=1.0)
        state = t.init_state_from_params(params[init])
        paths = [p for p, _ in named_leaves(state.params)
                 if p.startswith("layers/moe/")]
        got = _first_grads(t, state, _cp_pp_batch(t, ids), paths)
        grads.update({f"{name}/{p}": g for p, g in got.items()})
    if rank == 0:
        np.savez(out_dir / "moe_grads.npz", **grads)
    # ep 4 saved after one step, restored under ep 2 x fsdp 2
    exp = out_dir / "ckpt_moe"
    t = _moe_trainer("moe", "ep", {"ep": 4}, "ragged")
    state = t.init_state_from_params(params["moe"])
    batch = _cp_pp_batch(t, ids)
    state, _ = t.step_fn(state, batch)
    io = CheckpointIO(exp)
    host = stamp_host_state(host_state_dict(), t)
    host["global_step"] = 1
    io.save(state, host)
    io.close()
    state, m = t.step_fn(state, batch)
    facts["restore"] = {"straight": float(m["loss"])}
    for key, strategy, mesh_kw in (("ep_fsdp", "ep_fsdp",
                                    {"ep": 2, "fsdp": 2}),
                                   ("fsdp", "fsdp", {"fsdp": 4})):
        t2 = _moe_trainer("moe", strategy, mesh_kw, "ragged")
        state2, host2 = restore_train_state(CheckpointIO(exp), t2)
        state2, m2 = t2.step_fn(state2, _cp_pp_batch(t2, ids))
        facts["restore"][key] = {"resumed": float(m2["loss"]),
                                 "step": int(state2.step),
                                 "global_step": int(host2["global_step"])}
    if rank == 0:
        (out_dir / "moe.json").write_text(json.dumps(facts))


def cp_pp(out_dir, rank):
    batches = dict(np.load(out_dir / "batches.npz"))
    ids = batches["ids"]
    params = {k: from_jax.params_from_numpy(
        _unflatten(dict(np.load(out_dir / f"{k}.npz"))), device="cpu")
        for k in _CP_PP_MODELS}
    result = {}
    for name, init, strategy, mesh_kw, impl in CP_PP_RUNS:
        t = _cp_pp_trainer(init, strategy, mesh_kw, impl)
        state = t.init_state_from_params(params[init])
        batch = _cp_pp_batch(t, ids)
        losses = []
        for _ in range(2):
            state, m = t.step_fn(state, batch)
            losses.append(float(m["loss"]))
        full = _full_params(t, state)
        if rank == 0:
            np.savez(out_dir / f"cp_pp_{name}.npz", losses=losses,
                     **{f"p/{k}": v for k, v in full.items()})
    # -100 labels at shard edges: the target of a shard's last row is the
    # next shard's first label
    t = _cp_pp_trainer("init", "ddp", {"cp": 4}, "ring")
    _, m = t.step_fn(t.init_state_from_params(params["init"]),
                     _cp_pp_batch(t, ids, batches["uneven_labels"]))
    result["uneven_loss"] = float(m["loss"])
    # pp 2 x fsdp 2 saved after one step, restored under fsdp 4
    exp = out_dir / "ckpt_pp"
    t = _cp_pp_trainer("init", "pp_fsdp", {"pp": 2, "fsdp": 2}, "ring")
    state = t.init_state_from_params(params["init"])
    batch = _cp_pp_batch(t, ids)
    state, _ = t.step_fn(state, batch)
    io = CheckpointIO(exp)
    host = stamp_host_state(host_state_dict(), t)
    host["global_step"] = 1
    io.save(state, host)
    io.close()
    state, m = t.step_fn(state, batch)
    result["straight"] = float(m["loss"])
    t2 = _cp_pp_trainer("init", "fsdp", {"fsdp": 4}, "ring")
    state2, host2 = restore_train_state(CheckpointIO(exp), t2)
    state2, m2 = t2.step_fn(state2, _cp_pp_batch(t2, ids))
    result.update(resumed=float(m2["loss"]), step=int(state2.step),
                  global_step=int(host2["global_step"]))
    if rank == 0:
        (out_dir / "cp_pp.json").write_text(json.dumps(result))


SCENARIOS = {"sharded_load": sharded_load, "quantize": quantize,
             "offload": offload, "cp_pp": cp_pp}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--scenario", default=None, choices=sorted(SCENARIOS))
    args = ap.parse_args()
    out_dir = Path(args.dir)
    torch.set_num_threads(1)
    maybe_initialize_distributed("cpu")
    rank = int(os.environ["RANK"])
    if args.scenario is not None:
        SCENARIOS[args.scenario](out_dir, rank)
        torch.distributed.destroy_process_group()
        if rank == 0:
            (out_dir / "done").write_text("ok")
        return
    init = dict(np.load(out_dir / "init.npz"))
    params = from_jax.params_from_numpy(_unflatten(init), device="cpu")
    batches = dict(np.load(out_dir / "batches.npz"))
    trajectories(params, batches, out_dir, rank)
    overlap(params, batches, out_dir, rank)
    uneven(params, batches, out_dir, rank)
    restore(params, batches, out_dir, rank)
    refusal(out_dir, rank)
    guards(out_dir, rank)
    families(batches, out_dir, rank)
    moe(out_dir, rank)
    torch.distributed.destroy_process_group()
    if rank == 0:
        (out_dir / "done").write_text("ok")


if __name__ == "__main__":
    main()
