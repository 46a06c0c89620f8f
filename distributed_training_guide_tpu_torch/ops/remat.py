"""Rematerialization policies: what a checkpointed layer keeps from its
forward.

Counterpart of the JAX package's ``jax.checkpoint`` policies and
``checkpoint_name`` tags (``train/step.py:REMAT_POLICIES``). A layer runs
under ``torch.utils.checkpoint`` (non-reentrant); a policy other than
"all" selects, through ``create_selective_checkpoint_contexts``, the
operations whose outputs are saved instead of recomputed in backward:

- "all": nothing is saved (``nothing_saveable``);
- "dots": the outputs of matrix products with no batch dimensions
  (``aten.mm`` / ``aten.addmm``: the projections), as
  ``checkpoint_dots_with_no_batch_dims``;
- "attn": the operations run under the names "attn_out", "flash_out" and
  "flash_lse", as ``save_only_these_names``: the einsum attention's output
  and the flash forward's (o, lse), so backward never reruns the flash
  forward kernel (K1);
- "attn_mlp": "attn" and "mlp_act", the gated MLP's inner activation.

A name is a scope, not a tensor label: ``with checkpoint_name("mlp_act"):``
around the one operation that makes the tagged tensor. The flash forward
is a ``torch.library`` custom op (``ops/flash_attention.py``), so the policy
sees it as one operation and can keep its outputs; a kernel launched
through ctypes inside an ordinary function would be invisible to it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_ACTIVE = threading.local()


@contextlib.contextmanager
def checkpoint_name(*names: str):
    """Name the operations run inside this scope (``jax.ad_checkpoint.
    checkpoint_name`` for the tensors they make)."""
    prev = getattr(_ACTIVE, "names", frozenset())
    _ACTIVE.names = prev | frozenset(names)
    try:
        yield
    finally:
        _ACTIVE.names = prev


def active_names() -> frozenset:
    return getattr(_ACTIVE, "names", frozenset())


@dataclasses.dataclass(frozen=True)
class SavePolicy:
    """What a checkpointed layer saves: the outputs of the operations run
    under any of ``names``, and with ``dots`` every product with no batch
    dimensions."""

    names: frozenset = frozenset()
    dots: bool = False


# matrix products with no batch dimensions (x @ W reaches aten.mm through
# matmul's reshape; a bias add makes it addmm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

REMAT_POLICIES = {
    "all": None,
    "dots": SavePolicy(dots=True),
    "attn": SavePolicy(names=frozenset({"attn_out", "flash_out",
                                        "flash_lse"})),
    "attn_mlp": SavePolicy(names=frozenset({"attn_out", "flash_out",
                                            "flash_lse", "mlp_act"})),
}


def resolve_remat_policy(policy) -> Optional[SavePolicy]:
    """A ``REMAT_POLICIES`` name (None: "all"), or a SavePolicy."""
    if policy is None or isinstance(policy, SavePolicy):
        return policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; choose from "
                         f"{sorted(REMAT_POLICIES)}")
    return REMAT_POLICIES[policy]


def _policy_fn(policy: SavePolicy):
    def decide(ctx, op, *args, **kwargs):
        if (policy.dots and op in _DOTS) or (policy.names
                                             & active_names()):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return decide


def remat(fn, *args, policy=None):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant),
    saving what ``policy`` names (a name of ``REMAT_POLICIES`` or a
    SavePolicy; None or "all" saves nothing)."""
    policy = resolve_remat_policy(policy)
    if policy is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          _policy_fn(policy)))
