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
- "attn_mlp": "attn" and "mlp_act", the gated MLP's inner activation;
- ``save_anything_except(*names)``: everything the backward needs but the
  tensors made under ``names``, as ``save_anything_except_these_names``
  (the overlap schedule's cells, ``ops/overlap.py``, under
  "fsdp_gather"). Nothing is recomputed but those tensors: the layer runs
  once, autograd saves what it always saves, and a saved tensor that an
  operation under the names made (``remade_by`` registers it with the
  closure that makes it again), or a view of one, is dropped and made
  again when the backward unpacks it
  (``torch.autograd.graph.saved_tensors_hooks``). A selective checkpoint
  would cache every operation's output instead, which JAX's policy does
  not: it saves residuals.

A name is a scope, not a tensor label: ``with checkpoint_name("mlp_act"):``
around the one operation that makes the tagged tensor. The flash forward
is a ``torch.library`` custom op (``ops/flash_attention.py``), so the policy
sees it as one operation and can keep its outputs; a kernel launched
through ctypes inside an ordinary function would be invisible to it.
Operations run under ``uncached()`` are invisible to the policy's cache
too: they run again in the recompute, and the cache (which matches
operations by their order) neither holds their outputs nor expects them
in the same order in both passes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import weakref
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
    # not empty: save what the backward needs but the tensors made under
    # these names (``names`` and ``dots`` then unused; no recompute)
    except_names: frozenset = frozenset()


def save_anything_except(*names: str) -> SavePolicy:
    """Save what the backward needs but the tensors made under ``names``
    (``jax.checkpoint_policies.save_anything_except_these_names``)."""
    return SavePolicy(except_names=frozenset(names))


class _Remake:
    """A dropped saved tensor: the closure that makes its base again, and
    the view of that base it was."""

    def __init__(self, remake, t: torch.Tensor):
        self.remake = remake
        self.view = (t.shape, t.stride(), t.storage_offset())

    def __call__(self) -> torch.Tensor:
        return self.remake().as_strided(*self.view)


class _Dropped:
    """One ``save_anything_except`` scope: the tensors made under its
    names, by storage (a weak reference each: a dead tensor's storage may
    be reused), each with its remake."""

    def __init__(self, names: frozenset):
        self.names = names
        self.table: dict = {}

    def add(self, t: torch.Tensor, remake) -> None:
        if not t.is_meta:          # every meta storage sits at address 0
            self.table[t.untyped_storage().data_ptr()] = (weakref.ref(t),
                                                          remake)

    def pack(self, t: torch.Tensor):
        hit = (None if t.is_meta
               else self.table.get(t.untyped_storage().data_ptr()))
        if hit is None or hit[0]() is None:
            return t
        return _Remake(hit[1], t)

    @staticmethod
    def unpack(x):
        return x() if isinstance(x, _Remake) else x


def remade_by(t: torch.Tensor, remake) -> torch.Tensor:
    """Register ``t``, made under the active names, as made again by
    ``remake()`` with the innermost ``save_anything_except`` scope that
    drops one of those names; outside such a scope nothing happens."""
    for scope in reversed(getattr(_ACTIVE, "dropping", ())):
        if scope.names & active_names():
            scope.add(t, remake)
            break
    return t


def _save_anything_except(fn, args, names: frozenset):
    scope = _Dropped(names)
    prev = getattr(_ACTIVE, "dropping", ())
    _ACTIVE.dropping = prev + (scope,)
    try:
        with torch.autograd.graph.saved_tensors_hooks(scope.pack,
                                                      scope.unpack):
            return fn(*args)
    finally:
        _ACTIVE.dropping = prev


@contextlib.contextmanager
def uncached():
    """Run the operations of this scope with the dispatch modes suspended:
    a selective checkpoint's cache neither sees nor keeps them, and the
    recompute runs them again (a collective whose forward and recompute
    differ: a prefetched gather that the forward only waits for)."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


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
    SavePolicy; None or "all" saves nothing); a ``save_anything_except``
    policy runs ``fn`` once and drops only the tensors made under its
    names."""
    policy = resolve_remat_policy(policy)
    if policy is None:
        return checkpoint(fn, *args, use_reentrant=False)
    if policy.except_names:
        return _save_anything_except(fn, args, policy.except_names)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          _policy_fn(policy)))
