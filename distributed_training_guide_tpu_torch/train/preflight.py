"""Pre-flight: the per-device memory budget and a partitioning check,
with nothing allocated.

Counterpart of ``distributed_training_guide_tpu/train/preflight.py``. The
reference's 405B chapter walks the memory math by hand (params + grads +
Adam moments against 80 GB, ``05-training-llama-405b/README.md:191-224``)
and finds partitioning mistakes at full scale. Where the JAX function
traces and SPMD-lowers the whole step with abstract params, the port builds
the state on the ``meta`` device (shapes only) under a **fake process
group** of the target world (``fake_group``: torch's ``"fake"`` backend,
whose collectives move nothing), and runs one ``Trainer.step_fn`` on meta
tensors: a shape or divisibility error raises in seconds on a CPU host,
and the per-rank bytes are read off the state the plan actually built
(its local shards of params, grads and optimizer state under the precision
policy), with the keys of the JAX report: the fp32 baseline and the
policy's reduction, the MoE dispatch transients, the serve-side KV and
weight pricing, and ``comm_roofline``, the ring-collective cost model.

Every kernel wrapper takes its plain version on a meta tensor (nothing
runs on the card). The step's optimizer runs torch's or the port's own
update on meta; the card's fused AdamW kernel is the one part that does
not, and the report names it (``optimizer_on_meta``): its state shapes are
the same tensors the rules table laid out. The budget is set against the
card's memory where the preflight runs beside one
(``torch.cuda.mem_get_info``), else against the target's data-sheet HBM
(``utils/mfu.py:TARGETS``).
"""
from __future__ import annotations

import contextlib
import logging
import math
import os

import torch

LOGGER = logging.getLogger(__name__)

DEFAULT_TARGET = "h100"     # the card of the reference's 64-GPU recipe


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A process group of ``world`` ranks in which this process is
    ``rank`` and whose collectives move nothing (torch's ``"fake"``
    backend): what a plan for a target world is built under, on one host.
    It must be the only group of the process."""
    import torch.distributed as dist
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "the preflight needs its own fake process group: run it before "
            "maybe_initialize_distributed, or in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(tree) -> int:
    from .state import named_leaves

    return sum(_nbytes(t) for _, t in named_leaves(tree))


def _state_bytes(state) -> dict:
    """Per-rank bytes of a state: params (this rank's shards), the
    optimizer's per-leaf slots, and the ZeRO update shards (a copy of each
    param shard the optimizer steps)."""
    from .optimizer import state_slots

    opt = state.opt_state.optimizer
    update = {} if state.sharding is None else state.sharding.update
    opt_b = sum(_nbytes(t) for leaf in opt.state
                for t in state_slots(opt, leaf).values())
    return {"params": _tree_bytes(state.params), "opt_state": opt_b,
            "update_shards": sum(_nbytes(t) for t in update.values())}


def _grad_bytes(state, dtype) -> int:
    from .state import named_leaves

    return sum(t.numel() * (dtype.itemsize if dtype is not None
                            else t.element_size())
               for _, t in named_leaves(state.params))


def comm_roofline(trainer, *, global_batch: int, seq_length: int,
                  device_kind: str = DEFAULT_TARGET,
                  assume_overlap: bool = True) -> dict:
    """Analytical per-collective bytes per device and a roofline for the
    trainer's plan, the JAX function's cost model: a ring all-gather or
    reduce-scatter of ``n`` bytes over an axis of ``k`` moves ``(k-1)/k *
    n`` per device, an all-reduce ``2(k-1)/k * n``; weight collectives on
    the fsdp axis only, 4 tp all-reduces of the activations per layer,
    bf16 weights and activations, fp32 grad reduction; priced over one
    link bandwidth per target (``utils/mfu.py:TARGETS``: data-sheet
    figures, not measurements; one tier, no NVLink / InfiniBand split)."""
    from ..utils.mfu import (banded_attention_kv_length, target_spec,
                             transformer_flops_per_token)

    cfg = trainer.bundle.config
    sizes = ({} if trainer.plan is None else trainer.plan.sizes)
    fsdp, tp = sizes.get("fsdp", 1), sizes.get("tp", 1)
    dp, ep = sizes.get("dp", 1), sizes.get("ep", 1)
    n_chips = 1 if trainer.plan is None else trainer.plan.size()

    e = cfg.hidden_size
    n_layers = cfg.num_layers
    d = cfg.head_size
    hq, hkv = cfg.num_heads * d, getattr(cfg, "num_kv_heads",
                                         cfg.num_heads) * d
    inter = getattr(cfg, "intermediate_size", 4 * e)
    # MoE: every expert's weights ride the fsdp collectives, while the
    # compute counts active params only
    n_experts = getattr(cfg, "num_experts", 1)
    w_layer = (e * hq + 2 * e * hkv + hq * e
               + n_experts * 3 * e * inter) * 2 / tp
    w_embed = (cfg.vocab_size * e * 2
               * (1 if getattr(cfg, "tie_word_embeddings", False) else 2)) / tp
    weight_bytes = n_layers * w_layer + w_embed

    rows_local = global_batch / max(dp * fsdp, 1)
    act_bytes = rows_local * seq_length * e * 2          # [b_loc, S, E] bf16

    def ag_rs(n, k):
        return (k - 1) / k * n if k > 1 else 0.0

    def ar(n, k):
        return 2 * (k - 1) / k * n if k > 1 else 0.0

    ep_exchange = (4 * n_layers * ag_rs(act_bytes, ep)
                   if n_experts > 1 else 0.0)
    loss_bytes = rows_local * seq_length * 4
    loss_psum = 4 * ar(loss_bytes, tp) if tp > 1 else 0.0
    table = {
        "fsdp_allgather_weights": 2 * ag_rs(weight_bytes, fsdp),
        "fsdp_reducescatter_grads": ag_rs(weight_bytes * 2, fsdp),
        "tp_allreduce_activations": 4 * n_layers * ar(act_bytes, tp),
        "dp_allreduce_grads": ar(weight_bytes * 2 / max(fsdp, 1), dp),
        "ep_exchange": ep_exchange,
        "loss_psum": loss_psum,
    }
    comm_bytes = sum(table.values())

    spec = target_spec(device_kind)
    link, peak = spec["link_bytes_per_s"], spec["peak_flops"]
    attn_kv = banded_attention_kv_length(cfg, seq_length)
    flops_per_token = transformer_flops_per_token(
        trainer.bundle.num_active_params(), n_layers, e, seq_length,
        vocab_size=cfg.vocab_size, attn_kv_len=attn_kv)
    t_comp = (flops_per_token * global_batch * seq_length) / (peak * n_chips)
    t_comm = comm_bytes / link
    # exposed-vs-overlapped pricing (ops/overlap.py): under
    # --overlap-schedule the per-layer weight gathers / reduce-scatters
    # and the expert exchange have layer compute to hide behind, so only
    # their overflow past t_compute is exposed; the rest (tp all-reduces
    # between products, the loss sums, the bulk dp reduce) stays serial.
    # Without the schedule the whole comm budget is priced exposed
    overlap_on = bool(getattr(trainer, "overlap_schedule", False))
    schedulable = (table["fsdp_allgather_weights"]
                   + table["fsdp_reducescatter_grads"]
                   + table["ep_exchange"])
    if overlap_on:
        exposed_bytes = comm_bytes - schedulable
        t_exposed = exposed_bytes / link + max(0.0,
                                               schedulable / link - t_comp)
        overlapped_bytes = comm_bytes - exposed_bytes
    else:
        exposed_bytes, overlapped_bytes = comm_bytes, 0.0
        t_exposed = t_comm
    report = {
        "target": device_kind,
        "figures": "data sheet",
        "attn_kv_len": attn_kv,
        "per_collective_bytes_per_chip": {k: int(v) for k, v in table.items()},
        "comm_bytes_per_chip": int(comm_bytes),
        "link_bytes_per_s": link,
        "peak_flops_per_chip": peak,
        "t_compute_s": t_comp,
        "t_comm_s": t_comm,
        "comm_to_compute": t_comm / t_comp if t_comp else float("inf"),
        "mfu_ceiling_overlapped": (t_comp / max(t_comp, t_comm)
                                   if t_comp else 0.0),
        "mfu_ceiling_serial": t_comp / (t_comp + t_comm) if t_comp else 0.0,
        "overlap_schedule": overlap_on,
        "overlappable_bytes_per_chip": int(schedulable),
        "exposed_bytes_per_chip": int(exposed_bytes),
        "overlapped_bytes_per_chip": int(overlapped_bytes),
        "t_exposed_s": t_exposed,
        "mfu_ceiling_scheduled": (t_comp / (t_comp + t_exposed)
                                  if t_comp else 0.0),
    }
    if not assume_overlap:
        report["mfu_ceiling_overlapped"] = report["mfu_ceiling_serial"]
    return report


def price_post_colocation(trainer, *, n_slots: int, page_size: int = 16,
                          max_len: int = 2048, kv_dtype=None,
                          weight_dtype=None, teacher_bundle=None,
                          budget_bytes: int | None = None) -> dict:
    """Price the post-training loop's CO-RESIDENT memory: everything that
    lives on the card at once for rollout -> score -> update -> publish
    (``post/loop.py``): the trainer's policy state (params and optimizer
    state, the adapters' alone under ``lora_only``, and the transient
    grads), the serve engine's merged policy copy at its ``weight_dtype``
    and its page pool, and an optional teacher / reward model's params.
    The state is built on the meta device, so nothing is allocated; with
    ``budget_bytes`` an impossible colocation refuses here, before the
    first allocation. The grads are priced as the JAX function prices
    them, at the params' bytes (under ``lora_only`` the port's backward
    holds the adapters' grads alone, so this bounds them from above);
    the optimizer's 0-d step counters are the port's own. Under a plan the
    policy's bytes are one rank's, over the plan's shardings (build the
    trainer under the target world's ``fake_group``), as the JAX function
    prices them; the engine's copy and pool stay whole."""
    import dataclasses

    from ..serve.kv_pages import (kv_dtype_name, kv_page_bytes,
                                  pages_for_tokens)
    from ..serve.weights import weight_dtype_name, weight_tree_bytes

    cfg = trainer.bundle.config
    meta = dataclasses.replace(trainer, device="meta",
                               optimizer=trainer.base_optimizer,
                               offload_opt_state=False,
                               offload_params=False)
    b = _state_bytes(meta.init_state(0))
    params_b, opt_b = b["params"], b["opt_state"]
    grad_b = params_b          # transient, resident at the update boundary
    # the engine serves the MERGED policy (the base layout for a LoRA
    # bundle) at its weight_dtype: the QLoRA colocation is an int8 base
    # copy beside fp adapters in the trainer and the teacher
    base_bundle = getattr(trainer.bundle, "lora_base", None) or trainer.bundle
    engine_shapes = base_bundle.init(cfg, 0, device="meta")
    if weight_dtype is None:
        wname = "model"
        engine_params_b = _tree_bytes(engine_shapes)
    else:
        wname = weight_dtype_name(cfg, weight_dtype)
        engine_params_b = weight_tree_bytes(engine_shapes, wname,
                                            base_bundle.family)
    n_pages = 1 + n_slots * pages_for_tokens(max_len, page_size)
    pool_b = kv_page_bytes(cfg, page_size=page_size, n_pages=n_pages,
                           kv_dtype=kv_dtype_name(cfg, kv_dtype))
    teacher_b = 0
    if teacher_bundle is not None:
        teacher_b = _tree_bytes(teacher_bundle.init(
            teacher_bundle.config, 0, device="meta"))
    total = params_b + opt_b + grad_b + engine_params_b + pool_b + teacher_b
    report = {
        "policy_param_bytes": params_b,
        "policy_opt_state_bytes": opt_b,
        "policy_grad_bytes_transient": grad_b,
        "engine_param_bytes": engine_params_b,
        "engine_weight_dtype": wname,
        "engine_pool_bytes": pool_b,
        "engine_pool_pages": n_pages,
        "teacher_param_bytes": teacher_b,
        "total_bytes": total,
        "lora_only": bool(trainer.lora_only),
    }
    gib = 1 / 2**30
    LOGGER.info(
        f"post colocation: policy {params_b * gib:.3f} GiB params + "
        f"{opt_b * gib:.3f} GiB opt + {grad_b * gib:.3f} GiB grads, "
        f"engine {engine_params_b * gib:.3f} GiB merged copy + "
        f"{pool_b * gib:.3f} GiB pool ({n_pages} pages), teacher "
        f"{teacher_b * gib:.3f} GiB -> total {total * gib:.3f} GiB"
        + (f" vs budget {budget_bytes * gib:.3f} GiB"
           if budget_bytes else ""))
    if budget_bytes is not None and total > budget_bytes:
        raise ValueError(
            f"post-training colocation needs {total} bytes "
            f"({total * gib:.2f} GiB: policy state "
            f"{(params_b + opt_b + grad_b) * gib:.2f} + engine "
            f"{(engine_params_b + pool_b) * gib:.2f} + teacher "
            f"{teacher_b * gib:.2f}) but the budget is {budget_bytes} "
            f"({budget_bytes * gib:.2f} GiB) — shrink the pool "
            f"(n_slots/max_len/kv_dtype), use LoRA adapters "
            f"(lora_only), or drop the co-resident teacher")
    return report


def _meta_batch(trainer, global_batch: int, seq_length: int) -> dict:
    """This rank's rows of a global batch, as meta int64 ids (under cp its
    sequence shard and targets)."""
    data = 1 if trainer.plan is None else trainer.plan.data_parallel_size
    cp = 1 if trainer.plan is None else trainer.plan.sizes["cp"]
    if global_batch % (data * trainer.grad_accum):
        raise ValueError(
            f"global batch {global_batch} is not divisible by data ranks "
            f"({data}) x gradient accumulation ({trainer.grad_accum})")
    if seq_length % cp:
        raise ValueError(f"sequence {seq_length} is not divisible by cp "
                         f"({cp})")
    rows = global_batch // (data * trainer.grad_accum)
    seq = seq_length // cp
    shape = ((trainer.grad_accum, rows, seq) if trainer.grad_accum > 1
             else (rows, seq))
    ids = torch.empty(shape, dtype=torch.int64, device="meta")
    return {"input_ids": ids, ("targets" if cp > 1 else "labels"): ids}


def _device_limit(target_device: str) -> tuple:
    """(bytes, source) the budget is held against: the card's total memory
    where one is present, else the target's data-sheet HBM."""
    from ..utils.mfu import target_spec

    if torch.cuda.is_available():
        return int(torch.cuda.mem_get_info()[1]), "torch.cuda.mem_get_info"
    return int(target_spec(target_device)["hbm_bytes"]), (
        f"{target_device} data sheet")


def run_preflight(trainer, *, global_batch: int, seq_length: int,
                  target_device: str | None = None) -> dict:
    """Build ``trainer``'s state on meta, take one step on a meta batch
    (``global_batch`` rows over the plan's data ranks, ``seq_length``
    tokens), and report the per-device budget (bytes unless noted).
    ``trainer`` must be on ``device="meta"``; under a plan, its mesh is
    built under ``fake_group`` of the target world."""
    if trainer.device.type != "meta":
        raise ValueError(f"the preflight runs a trainer on device='meta', "
                         f"not {trainer.device}")
    target_device = target_device or DEFAULT_TARGET
    state = trainer.init_state(0)
    batch = _meta_batch(trainer, global_batch, seq_length)
    trainer.step_fn(state, batch)      # raises on a shape / layout error

    opt = state.opt_state.optimizer
    on_meta = (f"torch.optim.AdamW, single-tensor (the card runs it fused)"
               if isinstance(opt, torch.optim.AdamW)
               else type(opt).__name__)
    b = _state_bytes(state)
    params_b, opt_b = b["params"], b["opt_state"] + b["update_shards"]
    policy = trainer.precision
    grad_b = _grad_bytes(state, policy.accum_dtype
                         if trainer.grad_accum > 1 else None)
    sizes = {} if trainer.plan is None else trainer.plan.sizes
    report = {
        "per_device_param_bytes": params_b,
        "per_device_opt_state_bytes": opt_b,
        "per_device_grad_bytes_transient": grad_b,
        "per_device_state_total_bytes": params_b + opt_b,
        "per_device_update_shard_bytes": b["update_shards"],
        "n_devices": 1 if trainer.plan is None else trainer.plan.size(),
        "mesh": {k: int(v) for k, v in sizes.items()},
        "strategy": ("single" if trainer.plan is None
                     else trainer.plan.strategy),
        "lowered": True,
        "optimizer_on_meta": on_meta,
    }
    # the policy against the fp32 baseline: fp32 params and the base
    # optimizer's fp32 state on the same plan
    state32 = trainer.fp32_reference_state()
    b32 = _state_bytes(state32)
    params32_b = b32["params"]
    opt32_b = b32["opt_state"] + b32["update_shards"]
    grad32_b = _grad_bytes(state32, torch.float32)
    total_b = params_b + opt_b + grad_b
    total32_b = params32_b + opt32_b + grad32_b
    report["precision"] = {
        "policy": policy.name,
        "per_device_opt_state_bytes_fp32": opt32_b,
        "per_device_total_bytes_fp32": total32_b,
        "opt_state_reduction": round(opt32_b / opt_b, 2) if opt_b else 1.0,
        "total_state_reduction": (round(total32_b / total_b, 2)
                                  if total_b else 1.0),
    }
    limit, source = _device_limit(target_device)
    report["device_bytes_limit"] = limit
    report["device_bytes_limit_source"] = source
    report["per_device_total_bytes"] = total_b
    report["fits"] = total_b <= limit
    # the largest leaf's fp32 copy: the transient an optimizer that
    # computes in fp32 adds on top of the state, one leaf at a time
    report["largest_leaf_fp32_bytes"] = max(p.numel() * 4
                                            for p in opt.state)
    off = {"params": bool(trainer.offload_params),
           "opt_state": bool(trainer.offload_opt_state)}
    off["host_bytes_between_steps"] = (
        (params_b + b["update_shards"] if off["params"] else 0)
        + (b["opt_state"] if off["opt_state"] else 0))
    report["offload"] = off
    gib = 1 / 2**30
    LOGGER.info(
        f"preflight OK: the step runs on meta on mesh {report['mesh']}; per "
        f"device params {params_b * gib:.2f} GiB + opt {opt_b * gib:.2f} GiB "
        f"+ transient grads {grad_b * gib:.2f} GiB = {total_b * gib:.2f} GiB "
        f"against {limit * gib:.2f} GiB ({source}): "
        f"{'fits' if report['fits'] else 'does NOT fit'}")
    LOGGER.info(
        f"precision policy '{policy.name}': optimizer state "
        f"{report['precision']['opt_state_reduction']:.2f}x smaller than "
        f"fp32, total state (params+opt+grads) "
        f"{report['precision']['total_state_reduction']:.2f}x smaller "
        f"({total32_b * gib:.2f} -> {total_b * gib:.2f} GiB per device)")

    cfg = trainer.bundle.config
    if hasattr(cfg, "num_experts"):
        # the MoE dispatch transients per layer: dense = [E, C, D] in,
        # [E, C, F] inner, [E, C, D] out (padding included); ragged = the
        # same over the [kT, *] sorted buffer
        t = global_batch * seq_length
        k, e_cnt = cfg.experts_per_token, cfg.num_experts
        cap = max(int(math.ceil(cfg.capacity_factor * k * t / e_cnt)), 1)
        itemsize = cfg.dtype.itemsize
        d_model, f_ff = cfg.hidden_size, cfg.intermediate_size
        dense_b = e_cnt * cap * (2 * d_model + f_ff) * itemsize
        ragged_b = k * t * (2 * d_model + f_ff) * itemsize
        mode = getattr(cfg, "moe_dispatch", "dense")
        report["moe_dispatch"] = {
            "mode": mode,
            "per_layer_dense_dispatch_bytes": dense_b,
            "per_layer_ragged_dispatch_bytes": ragged_b,
            "dense_over_ragged": round(dense_b / ragged_b, 2),
        }
    report["serve_kv"] = _serve_kv(trainer, seq_length, params_b)
    report["serve_weights"] = _serve_weights(trainer)

    report["comm"] = comm = comm_roofline(
        trainer, global_batch=global_batch, seq_length=seq_length,
        device_kind=target_device)
    mib = 1 / 2**20
    rows = "; ".join(f"{k} {v * mib:.0f} MiB" for k, v in
                     comm["per_collective_bytes_per_chip"].items() if v)
    LOGGER.info(
        f"comm roofline ({target_device}, data-sheet figures): "
        f"{rows or 'no cross-device collectives'} | t_comm "
        f"{comm['t_comm_s'] * 1e3:.1f} ms vs t_compute "
        f"{comm['t_compute_s'] * 1e3:.1f} ms -> MFU ceiling "
        f"{comm['mfu_ceiling_overlapped']:.1%} overlapped / "
        f"{comm['mfu_ceiling_serial']:.1%} serial")
    return report


def _serve_kv(trainer, seq_length: int, params_b: int) -> dict:
    """The serve-side KV pricing of the JAX report (``serve/kv_pages.py``
    arithmetic): a decode slot at the training context, in pages."""
    from ..serve.kv_pages import KV_DTYPES, kv_page_bytes, pages_for_tokens

    cfg = trainer.bundle.config
    page_size = 16
    pages_per_slot = pages_for_tokens(seq_length, page_size)
    per_page = kv_page_bytes(cfg, page_size=page_size)
    per_slot = per_page * pages_per_slot
    tp = 1 if trainer.plan is None else trainer.plan.sizes["tp"]
    only_tp = trainer.plan is not None and all(
        a == "tp" or v == 1 for a, v in trainer.plan.sizes.items())
    kv_shards = tp if (tp > 1 and only_tp and cfg.num_kv_heads % tp == 0
                       and cfg.num_heads % tp == 0) else 1
    shared_tokens = min(512, seq_length)
    by_dtype = {name: kv_page_bytes(cfg, page_size=page_size, kv_dtype=name)
                for name in KV_DTYPES}
    slot_by_dtype = {name: b * pages_per_slot for name, b in by_dtype.items()}
    int8_ratio = round(by_dtype["int8"] / by_dtype["fp32"], 4)
    reprefill_flops = 2 * trainer.bundle.num_active_params() * seq_length
    spec_k, horizon_k = 4, 8

    def amortized(a: float) -> int:
        return int(params_b / sum(a ** j for j in range(spec_k + 1)))

    return {
        "page_size": page_size,
        "pages_per_slot_at_seq": pages_per_slot,
        "bytes_per_page": per_page,
        "bytes_per_slot_at_seq": per_slot,
        "dense_bytes_per_slot": kv_page_bytes(
            cfg, page_size=1, n_pages=cfg.max_position_embeddings),
        "decode_read_bytes_per_token_flash": per_slot,
        "decode_traffic_bytes_per_token_gather": 3 * per_slot,
        "shared_prefix_tokens_nominal": shared_tokens,
        "shared_prefix_bytes_amortized_per_extra_slot":
            per_page * (shared_tokens // page_size),
        "kv_shards": kv_shards,
        "bytes_per_page_per_chip": per_page // kv_shards,
        "bytes_per_slot_per_chip_at_seq": per_slot // kv_shards,
        "handoff_bytes_same_host": 0,
        "handoff_bytes_cross_host_at_seq": per_slot,
        "verify_read_bytes_per_step_flash": per_slot,
        "verify_traffic_bytes_per_step_gather": 3 * per_slot,
        "chunk_prefill_read_bytes_per_chunk_flash": per_slot,
        "chunk_prefill_traffic_bytes_per_chunk_gather": 3 * per_slot,
        "bytes_per_page_by_kv_dtype": by_dtype,
        "bytes_per_slot_by_kv_dtype": slot_by_dtype,
        "int8_bytes_vs_fp32": int8_ratio,
        "handoff_wire_bytes_by_kv_dtype": slot_by_dtype,
        "handoff_wire_int8_vs_fp32": int8_ratio,
        "host_tier_bytes_per_spilled_slot_at_seq": per_slot,
        "host_tier_bytes_per_spilled_slot_by_kv_dtype": slot_by_dtype,
        "host_tier_slots_per_gib": max(1, (1 << 30) // per_slot),
        "directory_pull_wire_bytes_at_seq": per_slot,
        "reprefill_flops_at_seq": reprefill_flops,
        "reprefill_flops_per_pull_byte": round(reprefill_flops / per_slot, 2),
        "spec_k_nominal": spec_k,
        "weight_read_bytes_per_token_spec_off": params_b,
        "weight_read_bytes_per_token_spec_accept_0.7": amortized(0.7),
        "weight_read_bytes_per_token_spec_accept_1.0": amortized(1.0),
        "verify_read_bytes_per_token_flash_accept_1.0":
            per_slot // (spec_k + 1),
        "decode_horizon_nominal": horizon_k,
        "horizon_dispatches_per_step": round(1 / horizon_k, 4),
        "horizon_block_bytes_per_slot": horizon_k * 4,
        "horizon_reserve_pages_worst_case":
            -(-(page_size - 1 + horizon_k) // page_size),
    }


def _serve_weights(trainer) -> dict:
    """Serve-side weight storage by dtype (``serve/weights.py``), from the
    model's meta shapes."""
    from ..serve.weights import weight_bytes_by_dtype

    bundle = trainer.bundle
    shapes = bundle.init(bundle.config, 0, device="meta")
    by_dtype = weight_bytes_by_dtype(shapes, bundle.family)
    out = {"weight_bytes_by_dtype": by_dtype,
           "publish_payload_bytes_by_dtype": dict(by_dtype),
           "swap_payload_bytes_by_dtype": dict(by_dtype),
           "int8_supported": "int8" in by_dtype}
    if "int8" in by_dtype:
        out["int8_bytes_vs_fp32"] = round(by_dtype["int8"] / by_dtype["fp32"],
                                          4)
    return out


def preflight_world(args) -> int:
    """The world a chapter's preflight builds its plan for:
    ``--preflight-world``, else the launcher's ``WORLD_SIZE`` /
    ``NUM_PROCESSES``, else 1."""
    world = getattr(args, "preflight_world", None)
    if world:
        return int(world)
    return int(os.environ.get("WORLD_SIZE")
               or os.environ.get("NUM_PROCESSES") or 1)
