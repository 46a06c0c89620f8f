"""Config-driven training engine: the JSON-config surface of the reference's
DeepSpeed chapter.

Counterpart of ``distributed_training_guide_tpu/train/engine.py``: a JSON
config (``ds_config.json``-style) drives the ZeRO stage, batch sizes,
gradient accumulation, precision and the optimizer, and the engine owns
the step and the checkpoints. Stages map to the port's sharding plans
(``parallel/plans.py``):

    stage 0 -> ddp, stage 1 -> zero1 (optimizer state sharded),
    stage 2 -> zero2 (optimizer state + accumulation buffer sharded),
    stage 3 -> fsdp (params sharded too)

and ``tensor_parallel`` > 1 to ``tp`` (``tp_fsdp`` at stage 3; ZeRO-1 / 2
keep their optimizer-state sharding under tp); ``pipeline_parallel`` > 1
to ``pp`` / ``pp_tp`` / ``pp_fsdp`` / ``pp_tp_fsdp`` (``pp_microbatches``)
and ``context_parallel`` > 1 adds a cp axis (``context_impl``: "ring" or
"ulysses"; ``cp_hop_loop`` is validated and logged), as the JAX engine
builds them. The keys are the JAX engine's: ``model``,
``zero_optimization.stage``, ``tensor_parallel``,
``train_micro_batch_size_per_gpu``, ``gradient_accumulation_steps``,
``optimizer`` (``AdamW`` / ``Adafactor`` / ``Lion`` and their params),
``scheduler`` (the flat ``{t_max, eta_min_ratio, warmup_steps, decay}`` or
DeepSpeed's ``WarmupCosineLR`` / ``WarmupDecayLR``), ``precision`` (or
``optimizer.params.precision``), ``bf16.enabled`` (the compute dtype),
``gradient_clipping``, ``activation_checkpointing`` (a bool or ``{"enabled",
"policy"}``), ``step_guards``, ``attn_impl``, ``loss_chunks``,
``moe_dispatch``, ``seed``, ``lora`` (``{"rank", "alpha", "targets"}``:
LoRA adapters on a frozen base, ``models/lora.py``), and the offloads,
``offload_optimizer`` /
``offload_params`` or DeepSpeed's ``zero_optimization.offload_optimizer``
/ ``offload_param`` (a bool or ``{"device": "cpu"}``; ``"none"``
disables). ``expert_parallel`` > 1 builds ``ep`` (``ep_fsdp`` at stage
3), refusing tp, pp and ZeRO-1 / 2 beside it as the JAX engine does.
``overlap_schedule`` turns on the overlap schedule (``ops/overlap.py``).

The engine starts the process group it needs
(``launch.maybe_initialize_distributed``: the torchrun env contract, or a
world of one) on ``device`` (default cuda) and ``close()`` takes it down
again. ``train_batch(batch)`` is one whole step (forward, backward,
update: what DeepSpeed's ``backward()`` + ``step()`` pair does), on this
rank's rows of the global batch.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

_STAGE_TO_STRATEGY = {0: "ddp", 1: "zero1", 2: "zero2", 3: "fsdp"}


def _ds_offload_enabled(v) -> bool:
    """DeepSpeed offload values: a bool, or ``{"device": "cpu" / "nvme" /
    "none"}``, where device "none" is the canonical way to disable."""
    if isinstance(v, dict):
        return v.get("device", "none") not in ("none", None)
    return bool(v)


def _scheduler_config(sched: dict) -> dict:
    """The flat native spelling of ``scheduler``; DeepSpeed's
    ``{"type", "params"}`` spelling maps onto it (its decay ends at
    ``total_num_steps``), and a param the engine would drop raises."""
    if "type" not in sched and "params" not in sched:
        return sched
    stype = sched.get("type", "WarmupCosineLR")
    if stype not in ("WarmupCosineLR", "WarmupDecayLR"):
        raise ValueError(
            f"scheduler.type {stype!r} is not supported (WarmupCosineLR or "
            f"WarmupDecayLR); or use the flat native spelling {{t_max, "
            f"eta_min_ratio, warmup_steps, decay}}")
    p = sched.get("params", {})
    known = {"total_num_steps", "warmup_num_steps"}
    if stype == "WarmupCosineLR":
        known.add("cos_min_ratio")
    unknown = set(p) - known
    if unknown:
        raise ValueError(
            f"scheduler.params {sorted(unknown)} are not supported for "
            f"{stype} (supported: {sorted(known)}); remove them or port the "
            f"values to the flat native spelling")
    total = p.get("total_num_steps", 1000)
    warmup = p.get("warmup_num_steps", 0)
    return {"t_max": max(total - warmup, 1), "warmup_steps": warmup,
            "eta_min_ratio": (p.get("cos_min_ratio", 0.01)
                              if stype == "WarmupCosineLR" else 0.0),
            "decay": "cosine" if stype == "WarmupCosineLR" else "linear"}


def _optimizer(config: dict):
    """(optimizer spec, precision policy name, normalized scheduler)."""
    from .optimizer import adafactor_cosine, adamw_cosine, lion_cosine

    opt_type = config.get("optimizer", {}).get("type", "AdamW").lower()
    opt_cfg = dict(config.get("optimizer", {}).get("params", {}))
    nested = opt_cfg.pop("precision", None)
    top = config.get("precision")
    if nested and top and nested != top:
        raise ValueError(
            f"optimizer.params.precision={nested!r} conflicts with "
            f"top-level precision={top!r}; set one")
    precision = nested or top or "fp32"
    known = {"adamw": {"lr", "betas", "eps", "weight_decay"},
             "adam": {"lr", "betas", "eps", "weight_decay"},
             "adafactor": {"lr", "weight_decay"},
             "lion": {"lr", "betas", "weight_decay"}}.get(opt_type)
    unknown = set(opt_cfg) - known if known is not None else set()
    if unknown:
        raise ValueError(
            f"optimizer.params {sorted(unknown)} are not supported for "
            f"optimizer.type {opt_type!r} (supported: {sorted(known)}); "
            f"remove them or switch type")
    sched = _scheduler_config(config.get("scheduler", {}))
    common = dict(weight_decay=opt_cfg.get("weight_decay", 0.01),
                  t_max=sched.get("t_max", 1000),
                  eta_min_ratio=sched.get("eta_min_ratio", 0.01),
                  warmup_steps=sched.get("warmup_steps", 0),
                  decay=sched.get("decay", "cosine"),
                  grad_clip=config.get("gradient_clipping"))
    if opt_type in ("adamw", "adam"):
        betas = opt_cfg.get("betas", [0.9, 0.999])
        spec = adamw_cosine(opt_cfg.get("lr", 3e-5), b1=betas[0],
                            b2=betas[1], eps=opt_cfg.get("eps", 1e-8),
                            **common)
    elif opt_type == "adafactor":
        spec = adafactor_cosine(opt_cfg.get("lr", 3e-5), **common)
    elif opt_type == "lion":
        betas = opt_cfg.get("betas", [0.9, 0.99])
        spec = lion_cosine(opt_cfg.get("lr", 1e-5), b1=betas[0],
                           b2=betas[1], **common)
    else:
        raise ValueError(f"unknown optimizer.type {opt_type!r}; use AdamW, "
                         f"Adafactor, or Lion")
    return spec, precision, sched


def plan_for_stage(stage: int, tp: int, pp: int = 1, ep: int = 1) -> tuple:
    """(strategy, zero1, zero2) of a ZeRO stage, tensor-, pipeline- and
    expert-parallel sizes: the ``make_plan`` arguments (ZeRO-1 / 2 stay
    sharded when tensor_parallel rewrites the strategy; None lets the
    strategy say). The JAX engine's refusals: ep beside tp or pp, and
    ZeRO-1 / 2 with pp or ep."""
    if stage not in _STAGE_TO_STRATEGY:
        raise ValueError(f"zero_optimization.stage must be 0-3, got "
                         f"{stage!r}")
    if ep > 1 and (tp > 1 or pp > 1):
        raise ValueError(
            "expert_parallel composes with data/fsdp axes only (the ep "
            "plans); drop tensor_parallel/pipeline_parallel or ep")
    if stage in (1, 2) and (pp > 1 or ep > 1):
        raise ValueError(
            "ZeRO stage 1/2 shards optimizer/grad state over the data "
            "axes of ddp/tp plans; with pipeline_parallel or "
            "expert_parallel use stage 0 or 3")
    if ep > 1:
        strategy = "ep_fsdp" if stage == 3 else "ep"
    elif pp > 1:
        strategy = ("pp_tp_fsdp" if tp > 1 and stage == 3
                    else "pp_tp" if tp > 1
                    else "pp_fsdp" if stage == 3 else "pp")
    elif tp > 1:
        strategy = "tp_fsdp" if stage == 3 else "tp"
    else:
        strategy = _STAGE_TO_STRATEGY[stage]
    return strategy, (stage in (1, 2)) or None, (stage == 2) or None


class TrainingEngine:
    """``initialize(config)``'s engine: the trainer, its state and the
    checkpoint writers of one JSON config. ``model_overrides`` replaces
    config fields of the model (e.g. ``num_layers`` to cut depth)."""

    def __init__(self, config: dict | str | Path, *, device=None,
                 model_overrides: Optional[dict] = None):
        import torch
        import torch.distributed as dist

        from .._device import resolve_device
        from ..launch import maybe_initialize_distributed
        from ..models import get_model

        if not isinstance(config, dict):
            with open(config) as fp:
                config = json.load(fp)
        self.config = config
        device = resolve_device(device)

        bf16 = config.get("bf16", {}).get("enabled", True)
        overrides = {"dtype": torch.bfloat16 if bf16 else torch.float32,
                     **(model_overrides or {})}
        if config.get("moe_dispatch"):
            overrides["moe_dispatch"] = config["moe_dispatch"]
        try:
            bundle = get_model(config["model"], **overrides)
        except TypeError as exc:
            if "moe_dispatch" not in overrides:
                raise
            raise ValueError(
                f"moe_dispatch={config['moe_dispatch']!r} is only valid for "
                f"MoE models; {config['model']!r} rejected it ({exc})")
        # {"rank": 8, "alpha": 16, "targets": ["wq", "wv"]}: adapters on a
        # frozen base, the optimizer restricted to them (lora_only)
        lora_cfg = config.get("lora")
        if lora_cfg:
            from ..models.lora import DEFAULT_TARGETS, lora_bundle

            bundle = lora_bundle(
                bundle, rank=lora_cfg.get("rank", 8),
                alpha=lora_cfg.get("alpha", 16.0),
                targets=tuple(lora_cfg.get("targets", DEFAULT_TARGETS)))

        stage = config.get("zero_optimization", {}).get("stage", 0)
        tp = config.get("tensor_parallel", 1)
        pp = config.get("pipeline_parallel", 1)
        cp = config.get("context_parallel", 1)
        ep = config.get("expert_parallel", 1)
        plan_args = plan_for_stage(stage, tp, pp, ep)  # fails before the group
        self._owns_group = not dist.is_initialized()
        self._ios: dict[str, Any] = {}
        maybe_initialize_distributed(device)
        try:
            self._build(config, bundle, stage == 3, (tp, pp, cp, ep),
                        plan_args, device)
        except BaseException:
            self.close()
            raise

    def _build(self, config: dict, bundle, fsdp: bool, sizes: tuple,
               plan_args: tuple, device) -> None:
        import torch.distributed as dist

        from ..ops.ring_attention import accept_hop_loop
        from ..parallel import make_mesh, make_plan
        from .guards import GuardMonitor
        from .step import Trainer

        n = dist.get_world_size()
        tp, pp, cp, ep = sizes
        denom = tp * pp * cp * ep
        if n % denom:
            raise ValueError(f"{n} ranks not divisible by tensor x "
                             f"pipeline x context x expert = {denom}")
        mesh_kw = {k: v for k, v in dict(tp=tp, pp=pp, cp=cp, ep=ep).items()
                   if v > 1}
        if fsdp:
            mesh_kw["fsdp"] = n // denom
        strategy, zero1, zero2 = plan_args
        plan = make_plan(strategy, make_mesh(device=device, **mesh_kw),
                         zero1=zero1, zero2=zero2)
        accept_hop_loop(config.get("cp_hop_loop", "auto"), cp)

        optimizer, precision, self.scheduler_config = _optimizer(config)
        ac = config.get("activation_checkpointing", False)
        if isinstance(ac, dict):
            remat, remat_policy = ac.get("enabled", True), ac.get("policy",
                                                                   "all")
        else:
            remat, remat_policy = bool(ac), "all"
        sg = config.get("step_guards", {})
        guard_policy = sg.get("policy", "off")
        self._guard = GuardMonitor(guard_policy,
                                   sg.get("max_consecutive_skips", 5))
        zero = config.get("zero_optimization", {})
        self.trainer = Trainer(
            bundle=bundle, optimizer=optimizer, plan=plan,
            grad_accum=config.get("gradient_accumulation_steps", 1),
            remat=remat, remat_policy=remat_policy,
            attn_impl=config.get("attn_impl", "auto"),
            guard_policy=guard_policy,
            loss_chunks=config.get("loss_chunks", 0),
            precision=precision, device=device,
            offload_opt_state=bool(
                config.get("offload_optimizer", False)
                or _ds_offload_enabled(zero.get("offload_optimizer", False))),
            offload_params=bool(
                config.get("offload_params", False)
                or _ds_offload_enabled(zero.get("offload_param", False))),
            lora_only=bool(config.get("lora")),
            overlap_schedule=bool(config.get("overlap_schedule", False)),
            pp_microbatches=config.get("pp_microbatches"),
            context_impl=config.get("context_impl", "ring"))
        self.state = self.trainer.init_state(config.get("seed", 0))
        self._step = 0       # host mirror of state.step

    # ---- the DeepSpeed surface ---------------------------------------------
    @property
    def micro_batch_size(self) -> int:
        return self.config.get("train_micro_batch_size_per_gpu", 1)

    @property
    def global_batch_size(self) -> int:
        return (self.micro_batch_size * self.trainer.plan.data_parallel_size
                * self.trainer.grad_accum)

    def train_batch(self, batch: dict) -> dict:
        """Forward, backward and the update on this rank's rows (what
        ``model_engine.backward(loss); model_engine.step()`` do). Returns
        the metrics as device scalars; with step guards on, host floats and
        ``guard_skipped`` (the policy is enforced on this step's flag)."""
        self.state, metrics = self.trainer.step_fn(self.state, batch)
        self._step += 1
        if self._guard.enabled:
            out = {k: float(v) for k, v in metrics.items()}
            skipped = self._guard.observe(out.get("notfinite", 0.0),
                                          step=self._step, metrics=out)
            out["guard_skipped"] = float(skipped)
            return out
        return dict(metrics)

    def _io_for(self, save_dir: str | Path, tag: Optional[str]):
        """One ``CheckpointIO`` per destination, reused across calls and
        closed by ``close()``."""
        from ..checkpoint import CheckpointIO

        key = str(Path(save_dir) / (tag or ""))
        io = self._ios.get(key)
        if io is None:
            io = self._ios[key] = CheckpointIO(key)
        return io

    def save_checkpoint(self, save_dir: str | Path,
                        tag: Optional[str] = None) -> None:
        from ..checkpoint import stamp_host_state
        from .state import host_state_dict

        host = host_state_dict()
        host["global_step"] = self._step
        stamp_host_state(host, self.trainer)
        self._io_for(save_dir, tag).save(self.state, host)

    def load_checkpoint(self, save_dir: str | Path,
                        tag: Optional[str] = None) -> dict:
        from ..checkpoint import restore_train_state

        self.state, host = restore_train_state(self._io_for(save_dir, tag),
                                               self.trainer)
        self._step = int(host.get("global_step", 0))
        return host

    def close(self) -> None:
        """Flush and release every checkpoint writer, and take down the
        process group this engine started."""
        import torch.distributed as dist

        try:
            for io in self._ios.values():
                io.close()
            self._ios.clear()
        finally:
            if self._owns_group and dist.is_initialized():
                dist.destroy_process_group()


def initialize(config: dict | str | Path, **kw) -> TrainingEngine:
    """``deepspeed.initialize`` analogue."""
    return TrainingEngine(config, **kw)
