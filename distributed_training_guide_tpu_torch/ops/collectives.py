"""Autograd-aware collectives over one process group (one mesh axis).

Counterpart of ``distributed_training_guide_tpu/ops/collectives.py``. The
JAX module's ``sub_fp32_guard`` widens bf16 collectives to fp32 because
XLA's CPU runtime aborts on them; gloo and NCCL reduce bf16 natively, so
the port has no such guard and nothing is widened.

The forward calls ``torch.distributed._functional_collectives``; each op
is paired with the backward that keeps every rank's gradient the gradient
of one global loss (Megatron's conjugate operators):

- ``all_gather``: tiled gather along ``dim``; backward reduce-scatters
  (sums) the gradient back to the shards. An fsdp parameter gather, and
  sequence parallelism's gather before a sublayer.
- ``reduce_scatter``: sum, then keep this rank's chunk of ``dim``;
  backward all-gathers. Sequence parallelism's exit from a sublayer.
- ``all_reduce``: sum whose backward is the identity (every rank goes on
  with the same sum and differentiates it once): a row-parallel output,
  the vocab shards' partial sums of the loss.
- ``copy_to``: identity whose backward sums over the group: the input of
  column-parallel products that every rank of the group reads.

A ``group`` of ``None`` means no group: each op is then the identity (the
plain single-device form).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

# the names of newer torch; the older ones take the same arguments
_GATHER = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
_SCATTER = (getattr(funcol, "reduce_scatter_single", None)
            or funcol.reduce_scatter_tensor)


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _gather(x, dim, group):
    return _wait(_GATHER(x.contiguous(), dim, group))


def _scatter(x, dim, group):
    return _wait(_SCATTER(x.contiguous(), "sum", dim, group))


def _reduce(x, group):
    return _wait(funcol.all_reduce(x.contiguous(), "sum", group))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    if group is None:
        return x
    return _AllGather.apply(x, dim % x.ndim, group)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    if group is None:
        return x
    return _ReduceScatter.apply(x, dim % x.ndim, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return _AllReduce.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return _CopyTo.apply(x, group)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place sum (or ``op``) of a tensor outside autograd: grads and
    statistics."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x
