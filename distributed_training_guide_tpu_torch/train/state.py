"""Training state.

Counterpart of ``distributed_training_guide_tpu/train/state.py``: params,
optimizer state (the optimizer and its schedule), step counter and the
training generator. Unlike the JAX pytree, the port's state is updated in
place by ``Trainer.step_fn``; the LR schedule follows the optimizer's
own update count.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class TrainState:
    step: int                  # optimizer steps taken (skipped ones too)
    params: Any                # nested dict of leaf tensors
    opt_state: Any             # train.optimizer.OptState
    rng: torch.Generator


def host_state_dict(epoch: int = 0, epoch_step: int = 0,
                    running_loss: float = 0.0) -> dict:
    """The host-side loop state (the reference's ``state`` dict)."""
    return {
        "epoch": epoch,
        "global_step": 0,
        "epoch_step": epoch_step,
        "running_loss": running_loss,
    }
