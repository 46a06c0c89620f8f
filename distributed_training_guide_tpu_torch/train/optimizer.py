"""Optimizer + LR schedule.

Counterpart of ``distributed_training_guide_tpu/train/optimizer.py``:
AdamW (``torch.optim.AdamW``, fused on the card) with the JAX package's
warmup + cosine (or linear) decay to ``lr * eta_min_ratio`` over ``t_max``
steps, flat after, through a ``LambdaLR``. optax reads the schedule at
the update count before its increment, so update 0 uses ``lr(0)``: the
optimizer steps first and the scheduler after. Weight decay is decoupled
and applies to every leaf, norms included (optax's unmasked ``adamw``),
and ``eps`` sits outside the square root in both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


def make_schedule(lr: float, t_max: int = 1000, eta_min_ratio: float = 0.01,
                  warmup_steps: int = 0,
                  decay: str = "cosine") -> Callable[[int], float]:
    """step -> learning rate: warmup, then decay to ``lr*eta_min_ratio``
    over ``t_max`` steps ("cosine", the reference's CosineAnnealingLR, or
    "linear"), flat after."""
    if decay not in ("cosine", "linear"):
        raise ValueError(f"decay must be cosine|linear, got {decay!r}")
    eta_min = lr * eta_min_ratio

    def schedule(step: int) -> float:
        warm = (min(step / max(warmup_steps, 1), 1.0) if warmup_steps
                else 1.0)
        t = min(max(step - warmup_steps, 0), t_max)
        if decay == "cosine":
            val = eta_min + (lr - eta_min) * 0.5 * (
                1 + math.cos(math.pi * t / t_max))
        else:
            val = eta_min + (lr - eta_min) * (1 - t / t_max)
        return warm * val

    return schedule


def cosine_schedule(lr: float, t_max: int = 1000,
                    eta_min_ratio: float = 0.01,
                    warmup_steps: int = 0) -> Callable[[int], float]:
    return make_schedule(lr, t_max, eta_min_ratio, warmup_steps, "cosine")


def lr_at_step(step: int, lr: float, t_max: int = 1000,
               eta_min_ratio: float = 0.01, warmup_steps: int = 0) -> float:
    """Host-side value of the cosine schedule for logging."""
    return cosine_schedule(lr, t_max, eta_min_ratio, warmup_steps)(step)


@dataclasses.dataclass
class OptState:
    """The optimizer and its schedule: what optax keeps as one state."""

    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler

    def step(self) -> None:
        self.optimizer.step()
        self.scheduler.step()


@dataclasses.dataclass(frozen=True)
class AdamWCosine:
    """``adamw_cosine``'s hyper-parameters; ``init(params)`` builds the
    state around a list of leaf tensors."""

    lr: float
    schedule: Callable[[int], float]
    weight_decay: float
    b1: float
    b2: float
    eps: float

    def init(self, params: list) -> OptState:
        opt = torch.optim.AdamW(
            params, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay,
            fused=all(p.is_cuda for p in params) or None)
        factor = ((lambda step: self.schedule(step) / self.lr) if self.lr
                  else (lambda step: 0.0))
        return OptState(opt, torch.optim.lr_scheduler.LambdaLR(opt, factor))


def adamw_cosine(lr: float, *, t_max: int = 1000,
                 eta_min_ratio: float = 0.01, warmup_steps: int = 0,
                 weight_decay: float = 0.01, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 decay: str = "cosine") -> AdamWCosine:
    return AdamWCosine(lr, make_schedule(lr, t_max, eta_min_ratio,
                                         warmup_steps, decay),
                       weight_decay, b1, b2, eps)


def _unported(name: str):
    def build(lr: float, **kwargs):
        raise NotImplementedError(
            f"--optimizer {name} is not ported yet (ROADMAP.md queue 1, "
            f"'Remat policies, precision and optimizers')")
    return build


# name -> constructor, the dispatch of the CLI's --optimizer
OPTIMIZERS = {"adamw": adamw_cosine, "adafactor": _unported("adafactor"),
              "lion": _unported("lion")}
