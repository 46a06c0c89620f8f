"""The train step of the single-device plan.

Counterpart of ``distributed_training_guide_tpu/train/step.py``'s
``Trainer``. Where the JAX step is one compiled program, the port's is
eager PyTorch: forward (bf16 compute; attention through the flash kernels
on the card), backward, the fp32 grad norm, the guard, then the optimizer
and its schedule, updating the state in place. ``remat`` checkpoints each
layer under ``remat_policy`` (``ops/remat.py:REMAT_POLICIES``).

``precision`` (``train/precision.py``) sets the storage: params in the
policy's dtype (or the model's, ``--param-dtype``), the optimizer state in
its form, and the gradient-accumulation buffer in ``accum_dtype``; the
optimizer computes in fp32 (``train/optimizer.py``). ``base_optimizer`` is
the spec without the policy: its fp32 layout is the restore target of a
checkpoint written before a run adopted a policy (``encode_fp32_state``).

Gradient accumulation sums the microbatch grads into the ``.grad``
buffers (or, where the policy's ``accum_dtype`` differs from the params',
into buffers of that dtype) and divides by ``grad_accum``, as the JAX scan
does. A model with ``apply_with_aux`` (MoE) trains on ``ce +
router_aux_coef * aux`` and reports the router's ``moe_dropped_frac``,
averaged over microbatches. ``DTG_FAULT_NAN_LOSS_STEP=N`` (read when the
Trainer is built) makes the loss of the step taken at ``state.step == N``
NaN, the guard drill.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .._device import resolve_device
from ..models.registry import ModelBundle, family_module
from ..ops.cross_entropy import causal_lm_loss, chunked_causal_lm_loss
from ..ops.remat import REMAT_POLICIES, resolve_remat_policy
from .guards import apply_step_guard, validate_guard_policy
from .precision import cast_floats, resolve_policy
from .state import TrainState, named_leaves

__all__ = ["REMAT_POLICIES", "Trainer"]

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


def _global_norm(grads: list) -> torch.Tensor:
    """The fp32 global L2 norm of a list of grads of any float dtype."""
    if all(g.dtype == torch.float32 for g in grads):
        norms = torch._foreach_norm(grads)
    else:
        norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
                 for g in grads]
    return torch.linalg.vector_norm(torch.stack(norms))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass
class Trainer:
    """Builds the state and takes optimizer steps for one model on one
    device. ``optimizer`` is a ``train.optimizer`` spec (``adamw_cosine``,
    ``adafactor_cosine``, ``lion_cosine``); ``device`` defaults to cuda."""

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
        resolve_remat_policy(self.remat_policy)
        self.base_optimizer = self.optimizer
        if self.plan not in (None, "single"):
            raise NotImplementedError(
                f"plan {self.plan!r}: only the single-device plan is ported "
                f"(ROADMAP.md queue 1, 'Distributed plans')")
        for name, item in _UNPORTED.items():
            if getattr(self, name) not in (None, False):
                raise NotImplementedError(
                    f"Trainer({name}=...) is not ported yet (ROADMAP.md "
                    f"queue 1, {item})")
        if self.loss_chunks > 0 and self.loss_fn is not causal_lm_loss:
            raise NotImplementedError(
                "loss_chunks hardwires the causal-LM loss; drop the custom "
                "loss_fn or the chunking")
        self.device = resolve_device(self.device)
        from ..utils.faults import active_faults

        self._nan_fault_step = active_faults().nan_loss_step

    # ---- init --------------------------------------------------------------
    def _fresh_state(self, params, seed: int, policy=None,
                     optimizer=None) -> TrainState:
        policy = self.precision if policy is None else policy
        params = _map(policy.cast_params(params),
                      lambda t: t.requires_grad_(True))
        opt_state = (optimizer or self.optimizer).init(_leaves(params),
                                                       policy)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(int(seed))
        return TrainState(step=0, params=params, opt_state=opt_state,
                          rng=rng)

    def init_state(self, seed: int) -> TrainState:
        """Random init from ``seed``, on the trainer's device, stored under
        the precision policy."""
        cfg = self.bundle.config
        return self._fresh_state(
            self.bundle.init(cfg, seed, device=self.device), seed)

    def init_state_from_params(self, params, seed: int = 0) -> TrainState:
        """Fresh optimizer state around given params (copied to the
        trainer's device, so the caller's tensors are never updated)."""
        return self._fresh_state(
            _map(params, lambda t: t.detach().to(self.device, copy=True)),
            seed)

    def fp32_reference_state(self, seed: int = 0) -> TrainState:
        """A state in the layout before any policy: fp32 params and the
        base optimizer's fp32 state (the restore target of a checkpoint
        written by an fp32 run)."""
        from .precision import POLICIES

        params = cast_floats(self.bundle.init(self.bundle.config, seed,
                                              device=self.device),
                             torch.float32)
        return self._fresh_state(params, seed, POLICIES["fp32"],
                                 self.base_optimizer)

    def encode_fp32_state(self, state32: TrainState) -> TrainState:
        """Re-encode an fp32-layout state into this trainer's policy: the
        params cast, each optimizer slot stored in the policy's form (Adam's
        moments quantized under adam8bit), the counts and generator
        carried over."""
        if self.precision.is_noop:
            return state32
        state = self._fresh_state(
            _map(state32.params, lambda t: t.detach()), 0)
        opt32 = state32.opt_state.optimizer
        opt = state.opt_state.optimizer
        policy = self.precision
        for (_, p32), (_, p) in zip(named_leaves(state32.params),
                                    named_leaves(state.params)):
            opt.state[p] = {k: policy.store_moment(v.float(), opt.SLOTS[k])
                            for k, v in opt32.state[p32].items()
                            if k != "step"}
        count = state32.opt_state.count
        state.opt_state.set_count(count)
        if hasattr(opt, "count"):
            opt.count = count
        state.step = state32.step
        state.rng.set_state(state32.rng.get_state())
        return state

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
        buffers = None      # the accumulation buffers, where not .grad
        if self.grad_accum > 1:
            accum = self.precision.accum_dtype
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            extras = {}
            for a in range(self.grad_accum):
                mb_loss, mb_extras = self._loss(
                    state.params, {k: v[a] for k, v in batch.items()})
                mb_loss.backward()
                if any(p.dtype != accum for p in leaves):
                    mb = [p.grad.to(accum) for p in leaves]
                    if buffers is None:
                        buffers = mb
                    else:
                        torch._foreach_add_(buffers, mb)
                    for p in leaves:
                        p.grad = None
                loss = loss + mb_loss.detach()
                for k, v in mb_extras.items():
                    extras[k] = extras.get(k, 0.0) + v / self.grad_accum
            loss = loss / self.grad_accum
            grads = [p.grad for p in leaves] if buffers is None else buffers
            torch._foreach_div_(grads, float(self.grad_accum))
        else:
            loss, extras = self._loss(state.params, batch)
            loss.backward()
            loss = loss.detach()
            grads = [p.grad for p in leaves]
        if (self._nan_fault_step is not None
                and state.step == self._nan_fault_step):
            loss = torch.full_like(loss, float("nan"))
        metrics = {
            "loss": loss.to(torch.float32),
            "grad_norm": _global_norm(grads),
            **{k: v.to(torch.float32) for k, v in extras.items()},
        }
        apply_update = True
        if self.guard_policy != "off":
            metrics, apply_update = apply_step_guard(self.guard_policy,
                                                     metrics)
        if apply_update:
            state.opt_state.step(buffers)
        state.step += 1
        return state, metrics

    # ---- accounting --------------------------------------------------------
    def tokens_per_step(self, per_device_batch: int, seq_len: int) -> int:
        """Tokens per optimizer step (batch * seq * grad_accum)."""
        return per_device_batch * seq_len * self.grad_accum
