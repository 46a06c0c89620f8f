"""The train step of the single-device plan.

Counterpart of ``distributed_training_guide_tpu/train/step.py``'s
``Trainer``. Where the JAX step is one compiled program, the port's is
eager PyTorch: forward (bf16 compute from fp32 params; attention through
the flash kernels on the card), backward, the fp32 grad norm, the guard,
then AdamW and its schedule, updating the state in place. Gradient
accumulation sums the microbatch grads into the fp32 ``.grad`` buffers
and divides by ``grad_accum``, as the JAX scan does. A model with
``apply_with_aux`` (MoE) trains on ``ce + router_aux_coef * aux`` and
reports the router's ``moe_dropped_frac``, averaged over microbatches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .._device import resolve_device
from ..models.registry import ModelBundle, family_module
from ..ops.cross_entropy import causal_lm_loss, chunked_causal_lm_loss
from .guards import apply_step_guard, validate_guard_policy
from .precision import resolve_policy
from .state import TrainState

# Trainer fields of the JAX package that later slices port, and where
_UNPORTED = {
    "context_impl": "'Context parallel, pipeline parallel and overlap'",
    "offload_opt_state": "'Chapter 05 recipe and conversion'",
    "offload_params": "'Chapter 05 recipe and conversion'",
    "lora_only": "'Other dense families' (LoRA)",
    "overlap_schedule": "'Context parallel, pipeline parallel and overlap'",
    "pp_microbatches": "'Context parallel, pipeline parallel and overlap'",
}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass
class Trainer:
    """Builds the state and takes optimizer steps for one model on one
    device. ``optimizer`` is a ``train.optimizer`` spec (``adamw_cosine``);
    ``device`` defaults to cuda."""

    bundle: ModelBundle
    optimizer: Any
    grad_accum: int = 1
    remat: bool = False
    remat_policy: str = "all"
    loss_chunks: int = 0   # >0: chunked CE from hidden states
    attn_impl: str = "auto"
    loss_fn: Callable = causal_lm_loss
    guard_policy: str = "off"   # "off" | "skip" | "abort" (train/guards.py)
    precision: Any = "fp32"
    device: Any = None
    plan: Any = None            # only the single-device plan is ported
    context_impl: Any = None
    offload_opt_state: bool = False
    offload_params: bool = False
    lora_only: bool = False
    overlap_schedule: bool = False
    pp_microbatches: Any = None

    def __post_init__(self):
        validate_guard_policy(self.guard_policy)
        self.precision = resolve_policy(self.precision)
        if self.plan not in (None, "single"):
            raise NotImplementedError(
                f"plan {self.plan!r}: only the single-device plan is ported "
                f"(ROADMAP.md queue 1, 'Distributed plans')")
        for name, item in _UNPORTED.items():
            if getattr(self, name) not in (None, False):
                raise NotImplementedError(
                    f"Trainer({name}=...) is not ported yet (ROADMAP.md "
                    f"queue 1, {item})")
        if self.remat and self.remat_policy != "all":
            raise NotImplementedError(
                f"remat_policy {self.remat_policy!r}: only 'all' is ported "
                f"(ROADMAP.md queue 1, 'Remat policies, precision and "
                f"optimizers')")
        if self.loss_chunks > 0 and self.loss_fn is not causal_lm_loss:
            raise NotImplementedError(
                "loss_chunks hardwires the causal-LM loss; drop the custom "
                "loss_fn or the chunking")
        self.device = resolve_device(self.device)

    # ---- init --------------------------------------------------------------
    def _fresh_state(self, params, seed: int) -> TrainState:
        params = _map(params, lambda t: t.requires_grad_(True))
        opt_state = self.optimizer.init(_leaves(params))
        rng = torch.Generator(device=self.device)
        rng.manual_seed(int(seed))
        return TrainState(step=0, params=params, opt_state=opt_state,
                          rng=rng)

    def init_state(self, seed: int) -> TrainState:
        """Random init from ``seed``, on the trainer's device."""
        cfg = self.bundle.config
        return self._fresh_state(
            self.bundle.init(cfg, seed, device=self.device), seed)

    def init_state_from_params(self, params, seed: int = 0) -> TrainState:
        """Fresh optimizer state around given params (copied to the
        trainer's device, so the caller's tensors are never updated)."""
        return self._fresh_state(
            _map(params, lambda t: t.detach().to(self.device, copy=True)),
            seed)

    # ---- the step ----------------------------------------------------------
    def _loss(self, params, mb: dict) -> tuple:
        """(loss, extra metrics) of one microbatch; the extras are
        detached fp32 scalars."""
        cfg = self.bundle.config
        kw = dict(positions=mb.get("positions"), remat=self.remat,
                  remat_policy=self.remat_policy, attn_impl=self.attn_impl,
                  return_hidden=self.loss_chunks > 0)
        extras, aux_loss = {}, None
        if self.bundle.apply_with_aux is not None:
            out, aux, extras = self.bundle.apply_with_aux(
                cfg, params, mb["input_ids"], return_metrics=True, **kw)
            aux_loss = getattr(cfg, "router_aux_coef", 0.0) * aux
            extras = {k: v.detach() for k, v in extras.items()}
        else:
            out = self.bundle.apply(cfg, params, mb["input_ids"], **kw)
        if self.loss_chunks > 0:
            w_out = family_module(self.bundle.family).output_weights(cfg,
                                                                     params)
            loss = chunked_causal_lm_loss(out, w_out, mb["labels"],
                                          num_chunks=self.loss_chunks)
        else:
            loss = self.loss_fn(out, mb["labels"])
        return (loss if aux_loss is None else loss + aux_loss), extras

    def step_fn(self, state: TrainState, batch: dict) -> tuple:
        """One optimizer step on ``batch`` ({"input_ids", "labels"}
        [B, S], or [A, B, S] under grad accumulation). Updates ``state`` in
        place and returns (state, {"loss", "grad_norm"[, "notfinite"]}),
        the metrics as fp32 device scalars."""
        leaves = _leaves(state.params)
        state.opt_state.optimizer.zero_grad(set_to_none=True)
        if self.grad_accum > 1:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            extras = {}
            for a in range(self.grad_accum):
                mb_loss, mb_extras = self._loss(
                    state.params, {k: v[a] for k, v in batch.items()})
                mb_loss.backward()
                loss = loss + mb_loss.detach()
                for k, v in mb_extras.items():
                    extras[k] = extras.get(k, 0.0) + v / self.grad_accum
            loss = loss / self.grad_accum
            grads = [p.grad for p in leaves]
            torch._foreach_div_(grads, float(self.grad_accum))
        else:
            loss, extras = self._loss(state.params, batch)
            loss.backward()
            loss = loss.detach()
            grads = [p.grad for p in leaves]
        metrics = {
            "loss": loss.to(torch.float32),
            "grad_norm": torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads))),
            **{k: v.to(torch.float32) for k, v in extras.items()},
        }
        apply_update = True
        if self.guard_policy != "off":
            metrics, apply_update = apply_step_guard(self.guard_policy,
                                                     metrics)
        if apply_update:
            state.opt_state.step()
        state.step += 1
        return state, metrics

    # ---- accounting --------------------------------------------------------
    def tokens_per_step(self, per_device_batch: int, seq_len: int) -> int:
        """Tokens per optimizer step (batch * seq * grad_accum)."""
        return per_device_batch * seq_len * self.grad_accum
