"""Training state, and its flat form in a checkpoint.

Counterpart of ``distributed_training_guide_tpu/train/state.py``: params,
optimizer state (the optimizer and its schedule), step counter and the
training generator. Unlike the JAX pytree, the port's state is updated in
place by ``Trainer.step_fn``; the LR schedule follows the optimizer's
own update count.

``state_tensors`` is the state as a flat dict of named tensors, the form a
checkpoint stores (``checkpoint/orbax_io.py``): every key is a parameter
**path**, never an index into the optimizer, so a checkpoint is read back
into whatever optimizer holds the same leaves:

- ``params/<path>``: each leaf;
- ``opt_state/<path>/<slot>``: the optimizer's state of that leaf (an int8
  moment as ``<slot>.q`` and ``<slot>.scale``; torch's AdamW also keeps a
  per-leaf ``step``);
- ``opt_state/count``: updates applied (the schedule's count);
- ``step``: optimizer steps taken, skipped ones too; ``rng``: the training
  generator's state.

The param and slot entries are views of the live tensors, so a
checkpoint read fills them in place; ``load_state_tensors`` then applies
the host-side counters.
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


def named_leaves(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a nested dict, paths joined with "/", in the
    order ``Trainer`` hands the leaves to the optimizer."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in named_leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def state_tensors(state: TrainState) -> dict:
    """The state as ``{name: tensor}`` (see the module docstring)."""
    from .optimizer import state_slots

    opt = state.opt_state.optimizer
    flat = {}
    for path, p in named_leaves(state.params):
        flat[f"params/{path}"] = p.detach()
        for slot, t in state_slots(opt, p).items():
            flat[f"opt_state/{path}/{slot}"] = t
    flat["opt_state/count"] = torch.tensor(state.opt_state.count,
                                           dtype=torch.int64)
    flat["step"] = torch.tensor(state.step, dtype=torch.int64)
    flat["rng"] = state.rng.get_state()
    return flat


def load_state_tensors(state: TrainState, flat: dict) -> TrainState:
    """Apply the counters and generator of ``flat`` (made by
    ``state_tensors(state)`` and then filled by a checkpoint read) to
    ``state``; the params and slots were filled in place."""
    count = int(flat["opt_state/count"])
    state.opt_state.set_count(count)
    opt = state.opt_state.optimizer
    if hasattr(opt, "count"):
        opt.count = count
    state.step = int(flat["step"])
    state.rng.set_state(flat["rng"])
    return state
