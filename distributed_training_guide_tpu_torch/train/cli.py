"""The chapters' CLI and training loop, on one card or under a plan.

Counterpart of ``distributed_training_guide_tpu/train/cli.py``: the same
flag surface and defaults (plus ``--device``), the same host state,
fence-every banking of the per-step loss, ``log_freq`` info dict
(running_loss, grad_norm, tokens_per_s, mfu, time/*, memory, and
``moe_dropped_frac`` for MoE models), ``--max-steps``,
``--steps-per-epoch`` and ``--profile-dir`` (a ``torch.profiler`` trace of
steps 10-15). With ``-e NAME`` the run lives in ``<save-dir>/NAME``: it
resumes from the newest verifiable checkpoint there (or starts fresh),
saves every ``--ckpt-freq`` steps (``--keep-checkpoints``,
``--async-checkpoint``, ``--checkpoint-full-crc``), and tracks with wandb
under ``--wandb``. ``--optimizer``, ``--precision-policy``,
``--param-dtype``, ``--remat-policy``, ``--mmap-data``, ``--pretrained``,
``--preflight``, ``--lora-rank`` (``--lora-alpha``, ``--lora-targets``:
adapters on a frozen base, ``models/lora.py``), ``--context-impl`` and
``--cp-hop-loop`` (context parallelism's ring or Ulysses, chapter 08),
``--overlap-schedule`` (``ops/overlap.py``: the fsdp gathers issued a
layer ahead, the fused hidden->loss, the expert ring) and ``--loss-chunks``
(under a plan, the fused loss of ``ops/overlap.py:make_fused_loss``) are
the JAX package's, and ``run_training(..., pp_microbatches=)`` sets the
pipeline's microbatches (chapter 09). The fault drills of
``utils/faults.py`` and the heartbeat of ``utils/heartbeat.py`` are wired
in. A flag whose feature a later slice ports raises
``NotImplementedError`` naming its ROADMAP.md item when it is set away
from its default.

``run_training(args, plan_factory)`` is what a chapter calls: the factory
builds the sharding plan (``parallel/plans.py:make_plan``) once the
process group is up (``launch/distributed.py``); without one the run is
chapter 01's single-device loop. Under a plan each rank loads its rows of
a global batch of ``batch_size x data ranks x grad_accum`` (under pp each
of the M microbatches split over the data ranks; under cp its sequence
shard and the shifted targets), tokens/s counts every rank's tokens and
MFU divides by the mesh's devices, and only process 0 logs, tracks, beats
the heartbeat and writes the profile.
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from pathlib import Path
from typing import Optional

LOGGER = logging.getLogger(__name__)

# flag dest -> (its default, the ROADMAP.md queue 1 item that ports it)
_UNPORTED_FLAGS = {
    "native_loader": (False, "'Runtime robustness and tooling'"),
}


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def get_parser() -> argparse.ArgumentParser:
    """The JAX package's chapter flag surface, plus ``--device``."""
    parser = argparse.ArgumentParser(
        prog="python -m distributed_training_guide_tpu_torch.train")
    parser.add_argument("-e", "--experiment-name", default=None)
    parser.add_argument("-d", "--dataset-name", default="synthetic",
                        required=False)
    parser.add_argument("--dataset-subset", default=None)
    parser.add_argument("-m", "--model-name", default=None, required=True)
    parser.add_argument("--save-dir", default="../outputs")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--num-epochs", default=100, type=int)
    parser.add_argument("--lr", default=3e-5, type=float)
    parser.add_argument("--optimizer", default="adamw",
                        choices=["adamw", "adafactor", "lion"])
    parser.add_argument("-b", "--batch-size", default=1, type=int)
    parser.add_argument("--log-freq", default=10, type=int)
    parser.add_argument("--ckpt-freq", default=500, type=int)
    parser.add_argument("-s", "--seq-length", default=1024, type=int)
    parser.add_argument("--steps-per-epoch", default=None, type=int,
                        help="cap steps per epoch (smoke runs)")
    parser.add_argument("--grad-accum", default=1, type=int)
    parser.add_argument("--checkpoint-activations", action="store_true",
                        help="remat decoder layers (torch.utils.checkpoint)")
    parser.add_argument("--remat-policy", default="all",
                        choices=["all", "dots", "attn", "attn_mlp"],
                        help="what survives forward under remat "
                             "(ops/remat.py): all = recompute everything, "
                             "dots = keep the projections' outputs, attn = "
                             "keep the attention output (the flash kernel's "
                             "o and lse), attn_mlp = attn + the MLP's inner "
                             "activation")
    parser.add_argument("--attn-impl", default="auto",
                        choices=["auto", "xla", "flash"])
    parser.add_argument("--context-impl", default="ring",
                        choices=["ring", "ulysses"],
                        help="cp>1 attention: the zigzag ring "
                             "(ops/ring_attention.py) or Ulysses' "
                             "all-to-all (ops/ulysses_attention.py); inert "
                             "at cp 1")
    parser.add_argument("--cp-hop-loop", default="auto",
                        choices=["auto", "scan", "unrolled"],
                        help="the JAX ring's hop-loop form; the port has "
                             "one loop (op-for-op the same per hop), so "
                             "the value is validated and logged only")
    parser.add_argument("--max-steps", default=None, type=int)
    parser.add_argument("--guard-policy", default="off",
                        choices=["off", "skip", "abort"],
                        help="non-finite loss/grad-norm policy "
                             "(train/guards.py)")
    parser.add_argument("--guard-max-skips", default=5, type=_positive_int,
                        metavar="N")
    parser.add_argument("--pretrained", default=None, metavar="DIR")
    parser.add_argument("--native-loader", action="store_true")
    parser.add_argument("--mmap-data", default=None, metavar="DIR")
    parser.add_argument("--async-checkpoint", action="store_true")
    parser.add_argument("--keep-checkpoints", default=2, type=_positive_int,
                        metavar="N")
    parser.add_argument("--loss-chunks", type=int, default=0,
                        help=">0: compute the loss in sequence chunks, never "
                             "holding full [B,S,V] logits")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--wandb-project", default=None)
    parser.add_argument("--wandb-per-host", action="store_true")
    parser.add_argument("--lora-rank", default=0, type=int, metavar="R",
                        help="train LoRA adapters of rank R on a FROZEN "
                             "base model instead of full parameters "
                             "(llama family; composes with --pretrained "
                             "and every plan). 0 = off")
    parser.add_argument("--lora-alpha", default=16.0, type=float,
                        help="LoRA scale numerator (delta = alpha/R * A@B)")
    parser.add_argument("--lora-targets", default="wq,wv",
                        help="comma list of adapted projections "
                             "(wq,wk,wv,wo,gate,up,down)")
    parser.add_argument("--moe-dispatch", default=None,
                        choices=["dense", "ragged"],
                        help="MoE expert dispatch (MoE models only): dense = "
                             "[E, C, D] capacity buffers, overflow drops to "
                             "the residual; ragged = dropless sort + grouped "
                             "GEMMs (the K5/K6 kernels on the card). Default: "
                             "the config's (dense)")
    parser.add_argument("--checkpoint-full-crc", action="store_true")
    parser.add_argument("--sliding-window", default=None, type=int,
                        metavar="W",
                        help="sliding-window attention over the previous W "
                             "tokens (the banded flash kernels)")
    parser.add_argument("--overlap-schedule", action="store_true",
                        help="the overlap schedule (ops/overlap.py): each "
                             "layer's fsdp gathers issued a layer ahead and "
                             "again in its backward, the fused "
                             "hidden->loss, the ragged expert ring")
    parser.add_argument("--precision-policy", default="fp32",
                        metavar="POLICY",
                        help="storage-precision policy (train/precision.py): "
                             "fp32, bf16-master, adam8bit or a '+' "
                             "composition")
    parser.add_argument("--param-dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--fence-every", type=_positive_int, default=1,
                        metavar="N",
                        help="host-read the loss every N steps instead of "
                             "every step")
    parser.add_argument("--timer-sync", action="store_true",
                        help="fence the phase timers with "
                             "torch.cuda.synchronize")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of steps 10-15 "
                             "into this dir")
    parser.add_argument("--preflight", action="store_true",
                        help="don't train: build the state on the meta "
                             "device, run one step on a meta batch, and "
                             "print the per-device memory budget and the "
                             "comm roofline (train/preflight.py)")
    parser.add_argument("--preflight-target", default=None, metavar="KIND",
                        help="card the budget and roofline price (h100, "
                             "the default)")
    parser.add_argument("--preflight-world", default=None,
                        type=_positive_int, metavar="N",
                        help="ranks the preflight plans for (a chapter's "
                             "64-GPU shape from one host; default: the "
                             "launcher's WORLD_SIZE, else 1)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where training runs (default cuda; cpu runs "
                             "the plain PyTorch path)")
    return parser


def check_ported_flags(args) -> None:
    """Refuse, before any work, a flag whose feature is not ported."""
    for dest, (default, item) in _UNPORTED_FLAGS.items():
        if getattr(args, dest, default) != default:
            raise NotImplementedError(
                f"--{dest.replace('_', '-')} is not ported yet (ROADMAP.md "
                f"queue 1, {item})")
    from .precision import resolve_policy

    resolve_policy(args.precision_policy)


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def run_training(args, plan_factory=None, *, device=None,
                 extra_log: Optional[dict] = None,
                 model_overrides: Optional[dict] = None,
                 offload_opt_state: bool = False,
                 offload_params: bool = False,
                 pp_microbatches: Optional[int] = None) -> dict:
    """The training loop. ``plan_factory() -> ShardingPlan`` is the one
    thing chapters customize (None: one device). Returns the host state,
    the last info dict, the state, every logged info dict, whether the run
    resumed, each checkpoint save's log (bytes, seconds) and the seconds
    the ``--pretrained`` load took, for tests and the card's smoke run. ``model_overrides`` replaces config fields of the
    preset (e.g. ``num_layers`` to cut depth). ``offload_*``: the
    optimizer state / params in host memory between steps
    (``train/offload.py``). ``--pretrained DIR`` starts from a converted
    checkpoint (``models/hf_convert.py``; each rank reads its own shards);
    ``--preflight`` trains nothing and returns the budget report of
    ``train/preflight.py`` for this model, plan and flags (the trainer on
    the meta device). ``pp_microbatches``: the pipeline's M under a pp
    plan (2 pp by default)."""
    if getattr(args, "fence_every", 1) < 1:
        raise SystemExit(f"--fence-every must be >= 1, got "
                         f"{args.fence_every}")
    check_ported_flags(args)
    import torch

    from .._device import resolve_device
    from ..checkpoint import (CheckpointIO, restore_train_state,
                              stamp_host_state)
    from ..data import BatchLoader, get_tokenizer, load_and_preprocess_data
    from ..models import get_model
    from ..utils import (LocalTimer, compute_mfu, device_sync, get_mem_stats,
                         init_logging, transformer_flops_per_token)
    from ..utils.faults import maybe_crash
    from ..utils.heartbeat import HeartbeatWriter
    from ..utils.procguards import is_process0, process_count, process_index
    from ..utils.tracking import make_tracker
    from .guards import GuardMonitor
    from .optimizer import OPTIMIZERS, lr_at_step
    from .state import host_state_dict
    from .step import Trainer

    preflight = getattr(args, "preflight", False)
    device = resolve_device("meta" if preflight else
                            device if device is not None
                            else getattr(args, "device", None))
    init_logging(process_index(), process_count())
    if not is_process0():
        logging.getLogger().setLevel(logging.WARNING)
    plan = plan_factory() if plan_factory is not None else None
    LOGGER.info(vars(args))
    overrides = dict(model_overrides or {})
    if args.param_dtype == "bfloat16":
        overrides["param_dtype"] = torch.bfloat16
    if getattr(args, "sliding_window", None):
        overrides["sliding_window"] = args.sliding_window
    if getattr(args, "moe_dispatch", None):
        overrides["moe_dispatch"] = args.moe_dispatch
    try:
        bundle = get_model(args.model_name, **overrides)
    except TypeError as exc:
        if "moe_dispatch" in overrides:
            raise SystemExit(
                f"--moe-dispatch is only valid for MoE models; "
                f"{args.model_name!r} rejected it ({exc})")
        raise
    cfg = bundle.config
    lora_rank = getattr(args, "lora_rank", 0)
    if lora_rank:
        from ..models.lora import lora_bundle, num_trainable_params

        bundle = lora_bundle(bundle, rank=lora_rank,
                             alpha=getattr(args, "lora_alpha", 16.0),
                             targets=tuple(getattr(
                                 args, "lora_targets", "wq,wv").split(",")))
        LOGGER.info(f"LoRA: rank {lora_rank}, "
                    f"{num_trainable_params(bundle):,} trainable adapter "
                    f"params over a frozen {bundle.num_params():,}-param base")
    if plan is None:
        LOGGER.info(f"Training {bundle.num_params():,} model parameters on "
                    f"{device} strategy=single")
    else:
        LOGGER.info(f"Training {bundle.num_params():,} model parameters on "
                    f"mesh {plan.sizes} strategy={plan.strategy} ({device})")
    from ..ops.ring_attention import accept_hop_loop

    accept_hop_loop(getattr(args, "cp_hop_loop", "auto"),
                    1 if plan is None else plan.sizes.get("cp", 1))
    seq_length = min(args.seq_length, cfg.max_position_embeddings)
    trainer = Trainer(
        bundle=bundle, optimizer=OPTIMIZERS[args.optimizer](args.lr),
        grad_accum=args.grad_accum, remat=args.checkpoint_activations,
        remat_policy=args.remat_policy, loss_chunks=args.loss_chunks,
        attn_impl=args.attn_impl, guard_policy=args.guard_policy,
        precision=args.precision_policy, device=device, plan=plan,
        offload_opt_state=offload_opt_state, offload_params=offload_params,
        lora_only=bool(lora_rank),
        context_impl=getattr(args, "context_impl", "ring"),
        overlap_schedule=getattr(args, "overlap_schedule", False),
        pp_microbatches=pp_microbatches)
    guard = GuardMonitor(args.guard_policy, args.guard_max_skips)
    data_ranks = 1 if plan is None else plan.data_parallel_size
    global_batch = args.batch_size * data_ranks * args.grad_accum
    if preflight:
        from .preflight import run_preflight

        return run_preflight(trainer, global_batch=global_batch,
                             seq_length=seq_length,
                             target_device=args.preflight_target)

    tokenizer = get_tokenizer(args.model_name)
    dataset = load_and_preprocess_data(
        args.dataset_name, tokenizer, seq_length,
        max_position_embeddings=cfg.max_position_embeddings, seed=args.seed,
        dataset_subset=args.dataset_subset,
        mmap_dir=args.mmap_data)
    LOGGER.info(f"{len(dataset)} training sequences of length {seq_length}")
    sizes = {} if plan is None else plan.sizes
    pipe = getattr(trainer.plan_state, "pipeline", None)
    loader = BatchLoader(dataset, global_batch, device=device,
                         grad_accum=args.grad_accum, seed=args.seed,
                         data_rank=0 if plan is None else plan.data_rank,
                         data_size=data_ranks,
                         microbatches=1 if pipe is None else pipe.M,
                         seq_rank=(plan.mesh.get_local_rank("cp")
                                   if sizes.get("cp", 1) > 1 else 0),
                         seq_size=sizes.get("cp", 1))
    steps_per_epoch = len(loader)
    if args.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)
    LOGGER.info(f"{steps_per_epoch} batches per epoch (global batch "
                f"{global_batch})")

    # ---- experiment dir + resume (reference 01:80-110) --------------------
    exp_dir = Path(args.save_dir)
    is_experiment = args.experiment_name is not None
    if is_experiment:
        exp_dir = exp_dir / args.experiment_name
    io = (CheckpointIO(exp_dir, async_save=args.async_checkpoint,
                       keep_n=args.keep_checkpoints,
                       full_crc=args.checkpoint_full_crc)
          if is_experiment else None)
    host_state = host_state_dict()
    load_s = None       # seconds to load --pretrained weights
    resumed = io is not None and io.can_resume()
    if resumed:
        # policy-aware: an fp32 checkpoint restored into a precision-policy
        # run is re-encoded with a logged warning
        state, host_state = restore_train_state(io, trainer)
    elif args.pretrained:
        from ..models.hf_convert import load_pretrained
        from ..models.lora import load_pretrained_lora

        t0 = time.perf_counter()
        params = (load_pretrained_lora(bundle, plan, args.pretrained,
                                       seed=args.seed, device=device)
                  if lora_rank else
                  load_pretrained(bundle, plan, args.pretrained,
                                  device=device))
        state = trainer.init_state_from_params(params, args.seed,
                                               sharded=plan is not None)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        load_s = time.perf_counter() - t0
        LOGGER.info(f"Loaded pretrained weights from {args.pretrained} in "
                    f"{load_s:.2f} s")
    else:
        state = trainer.init_state(args.seed)
    if is_experiment:
        LOGGER.info(f"Resumed={resumed} | {host_state}")
        exp_dir.mkdir(parents=True, exist_ok=True)
    # stamped into every manifest: a restore under another
    # --precision-policy fails loudly (or re-encodes an fp32 checkpoint)
    stamp_host_state(host_state, trainer)
    tracker = make_tracker(
        args, mode="per-host" if args.wandb_per_host else "process0",
        exp_dir=exp_dir if is_experiment else None, config=vars(args))

    sync_fn = (device_sync if args.timer_sync and device.type == "cuda"
               else None)
    timers = {k: LocalTimer(sync_fn=sync_fn) for k in ["data", "step"]}
    flops_per_token = transformer_flops_per_token(
        bundle.num_active_params(), cfg.num_layers, cfg.hidden_size,
        seq_length, vocab_size=cfg.vocab_size)
    tok_per_step = trainer.tokens_per_step(args.batch_size, seq_length)
    n_chips = 1 if plan is None else plan.size()
    # a no-op unless $HEARTBEAT_FILE is set; process 0 beats for the gang
    heartbeat = HeartbeatWriter()
    if not is_process0():
        heartbeat.path = None
    profile_dir = args.profile_dir if is_process0() else None
    last_info: dict = {}
    infos: list = []
    prof = None
    profile_done = False
    profile_start_step = 0
    done = False
    pending_losses = []  # (step, loss, notfinite) banked between fences

    def drain_losses():
        for step_no, loss, flag in pending_losses:
            if flag is not None and guard.observe(
                    float(flag), step_no, {"loss": float(loss)}):
                continue
            host_state["running_loss"] += float(loss)
        pending_losses.clear()

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        for epoch in range(host_state["epoch"], args.num_epochs):
            host_state["epoch"] = epoch
            loader.set_epoch(epoch)
            LOGGER.info(f"Begin epoch {epoch} at step "
                        f"{host_state['epoch_step']}")
            batches = loader.epoch_batches(
                start_step=host_state["epoch_step"])
            for i_step in range(host_state["epoch_step"], steps_per_epoch):
                with timers["data"]:
                    batch = next(batches)
                with timers["step"]:
                    state, metrics = trainer.step_fn(state, batch)
                    # a log boundary drains inside the step timer, so the
                    # device work of the whole fence group is timed
                    pending_losses.append(
                        (host_state["global_step"] + 1, metrics["loss"],
                         metrics.get("notfinite") if guard.enabled
                         else None))
                    if (len(pending_losses) >= args.fence_every
                            or (host_state["global_step"] + 1)
                            % args.log_freq == 0):
                        drain_losses()
                host_state["global_step"] += 1
                host_state["epoch_step"] += 1
                heartbeat.beat(host_state["global_step"])

                if profile_dir:  # trace a ~5-step steady window
                    if prof is None and host_state["global_step"] >= 10:
                        prof = _profiler(device)
                        prof.__enter__()
                        profile_start_step = host_state["global_step"]
                    elif (prof is not None and not profile_done
                          and host_state["global_step"]
                          >= profile_start_step + 5):
                        _finish_profile(prof, profile_dir)
                        profile_done = True

                if host_state["global_step"] % args.log_freq == 0:
                    drain_losses()
                    ms_per_step = sum(t.avg_elapsed_ms()
                                      for t in timers.values())
                    tokens_per_s = 1000 * tok_per_step / max(ms_per_step,
                                                             1e-9)
                    info = {
                        "global_step": host_state["global_step"],
                        "lr": lr_at_step(host_state["global_step"], args.lr),
                        "running_loss": (host_state["running_loss"]
                                         / args.log_freq),
                        "grad_norm": float(metrics["grad_norm"]),
                        **{k: float(v) for k, v in metrics.items()
                           if k not in ("loss", "grad_norm")},
                        "epoch": epoch,
                        "epoch_progress": (host_state["epoch_step"]
                                           / steps_per_epoch),
                        "num_batches_remaining": steps_per_epoch - i_step,
                        **get_mem_stats(device),
                        "tokens_per_s": tokens_per_s,
                        "mfu": compute_mfu(tokens_per_s, flops_per_token,
                                           n_chips, device=device),
                        "time/total": ms_per_step,
                        **{f"time/{k}": t.avg_elapsed_ms()
                           for k, t in timers.items()},
                        **({"guard_skipped": guard.total_skipped}
                           if guard.enabled else {}),
                        **(extra_log or {}),
                    }
                    LOGGER.info(info)
                    tracker.log(info, step=host_state["global_step"])
                    last_info = info
                    infos.append(info)
                    host_state["running_loss"] = 0.0
                    for t in timers.values():
                        t.reset()

                if (io is not None
                        and host_state["global_step"] % args.ckpt_freq == 0):
                    drain_losses()    # host_state is about to be persisted
                    LOGGER.info("Saving checkpoint.")
                    io.save(state, host_state)

                # after the checkpoint block: an injected crash at step N
                # leaves the step-N checkpoint (if any) published
                maybe_crash(host_state["global_step"])

                if (args.max_steps
                        and host_state["global_step"] >= args.max_steps):
                    done = True
                    break
            drain_losses()
            host_state["epoch_step"] = 0
            if done:
                break
    finally:
        if prof is not None and not profile_done:
            _finish_profile(prof, profile_dir)
        try:
            if io is not None:
                io.close()     # finalize any in-flight async checkpoint
        finally:
            tracker.finish()
    return {"host_state": host_state, "last_info": last_info,
            "state": state, "infos": infos, "resumed": resumed,
            "checkpoint_saves": io.save_log if io is not None else [],
            "pretrained_load_s": load_s}


def _finish_profile(prof, profile_dir: str) -> None:
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    LOGGER.info(f"profiler trace written to {path}")
