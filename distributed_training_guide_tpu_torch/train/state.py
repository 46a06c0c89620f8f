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
the host-side counters. Under a sharding plan (``TrainState.sharding``)
each param and slot entry is a ``DTensor`` over this rank's shard, laid
out by the plan's rules (DCP writes the shards and reshards on a read
into another plan), and a param whose optimizer state is sharded where
the param is not (ZeRO) keys its slots by its update shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class TrainState:
    step: int                  # optimizer steps taken (skipped ones too)
    params: Any                # nested dict of leaf tensors
    opt_state: Any             # train.optimizer.OptState
    rng: torch.Generator
    sharding: Any = None       # under a plan: train.step's PlanState
    offload: Any = None        # train.offload.HostOffload, or None


def host_state_dict(epoch: int = 0, epoch_step: int = 0,
                    running_loss: float = 0.0) -> dict:
    """The host-side loop state (the reference's ``state`` dict)."""
    return {
        "epoch": epoch,
        "global_step": 0,
        "epoch_step": epoch_step,
        "running_loss": running_loss,
    }


def resident(state: TrainState):
    """Context manager: the state's offloaded tensors on its device for
    the block (``train/offload.py``); a no-op without offload."""
    off = getattr(state, "offload", None)
    return contextlib.nullcontext() if off is None else off.resident(state)


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
    sh = state.sharding
    flat = {}
    for path, p in named_leaves(state.params):
        if sh is None:
            flat[f"params/{path}"] = p.detach()
            for slot, t in state_slots(opt, p).items():
                flat[f"opt_state/{path}/{slot}"] = t
            continue
        flat[f"params/{path}"] = sh.param_dtensor(path, p.detach())
        for slot, t in state_slots(opt, sh.update_leaf(path, p)).items():
            flat[f"opt_state/{path}/{slot}"] = sh.slot_dtensor(path, slot, t,
                                                               opt)
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
    if state.sharding is not None:
        state.sharding.reshard_update_leaves(state)
    return state
