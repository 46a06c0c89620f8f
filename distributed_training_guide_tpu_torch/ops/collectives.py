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
- ``gather_replicated``: tiled gather along ``dim`` whose backward keeps
  this rank's slice of the cotangent, which every rank holds whole: the
  input of a computation every rank of the group runs alike (a custom
  loss on the global logits, a sublayer run whole on every tp rank).
- ``gather_tiled``: the tiled gather with no autograd, by c10d's
  ``all_gather_into_tensor``: the serve forwards under a plan.

A ``group`` of ``None`` means no group: each op is then the identity (the
plain single-device form).

Context, pipeline and expert parallelism exchange tensors between the
members of one mesh axis (``MemberExchange``): a permutation (the ring's
rotations and zigzag relayout, the pipeline's hops), an all-to-all
(Ulysses), an all-gather (Ulysses where cp does not divide the heads; the
expert exchange's rows and routing) and a reduce-scatter (the expert
exchange's partial combine going home). ``AxesExchange`` gathers over
several mesh axes at once (the MoE routing of every rank that holds other
tokens).
``post_permute`` is an autograd-aware permutation posted at once and
waited later (the expert ring of ``models/moe.py``: the gradients travel
the inverse permutation, posted in the backward of the wait and waited in
the backward of the post).
``GroupExchange`` holds this rank's one member of a process group and
sends through ``dist.batch_isend_irecv`` / ``all_to_all_single``;
``LocalExchange`` holds every member in one process, so the ring and the
pipeline run over virtual members on one device (the card check, and the
CPU tests against the JAX package on one process).
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


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def gather_tiled(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` all-gathered along ``dim`` over ``group`` (rank order), with
    no autograd, by c10d's ``all_gather_into_tensor``: the serve forwards
    (``serve/sharding.py``) run without grads, and gloo's functional
    all-gather of CUDA tensors (two tp ranks on one card) crashes where
    the c10d one does not."""
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def gather_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    if group is None:
        return x
    return _GatherReplicated.apply(x, dim % x.ndim, group)


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


# ---------------------------------------------------------------------------
# Exchanges between the members of one mesh axis (context and pipeline
# parallelism): a permutation of tensors (ring rotations, the zigzag
# relayout, pipeline hops) and an all-to-all (Ulysses)
# ---------------------------------------------------------------------------

class _Done:
    """A permutation whose tensors are already in place."""

    def __init__(self, out: list):
        self.out = out

    def wait(self) -> list:
        return self.out


class _Posted:
    """A permutation posted through ``batch_isend_irecv``: ``wait`` ends
    every send and receive and returns what arrived. The posted ops (and
    the buffers they send) live until then."""

    def __init__(self, works: list, ops: list, out: list):
        self.works, self.ops, self.out = works, ops, out

    def wait(self) -> list:
        for w in self.works:
            w.wait()
        self.works, self.ops = [], []
        return self.out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 (one chunk per member); the same
    exchange carries the gradient back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if not x.is_meta:                       # meta: shapes only
        dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _split_cat(xs: list, split_dim: int, cat_dim: int) -> list:
    """Member j receives chunk j of every member's tensor, concatenated
    along ``cat_dim`` in member order."""
    n = len(xs)
    chunks = [torch.chunk(x, n, dim=split_dim) for x in xs]
    return [torch.cat([chunks[i][j] for i in range(n)], dim=cat_dim)
            for j in range(n)]


class MemberExchange:
    """The members ``0 .. size-1`` of one mesh axis (cp's ring positions,
    pp's stages), of which this process holds ``local``. Every exchange
    takes one item per local member, in ``local``'s order:

    - ``permute(items, perm)``: ``perm`` is a list of (source, destination)
      member pairs (``jax.lax.ppermute``'s); each item is a list of
      tensors, and member d receives the item of the s with (s, d) in
      ``perm``, or zeros where no pair names d. Returns a handle whose
      ``wait()`` gives the received items: the sends are posted at once,
      so work queued before ``wait`` overlaps them.
    - ``all_to_all(xs, split_dim, cat_dim)``: member j receives chunk j
      (along ``split_dim``) of every member's tensor, concatenated along
      ``cat_dim`` in member order; autograd-aware.
    - ``all_gather(xs, dim)``: every member receives every member's tensor,
      concatenated along ``dim`` in member order; autograd-aware (each
      member's gradient share is summed back onto its tensor).
    - ``reduce_scatter(xs, dim)``: the sum of every member's tensor, of
      which member j receives chunk j along ``dim``; autograd-aware (the
      backward all-gathers)."""

    size: int
    local: tuple

    def permute(self, items: list, perm: list):
        raise NotImplementedError

    def all_to_all(self, xs: list, split_dim: int, cat_dim: int) -> list:
        raise NotImplementedError

    def all_gather(self, xs: list, dim: int) -> list:
        raise NotImplementedError

    def reduce_scatter(self, xs: list, dim: int) -> list:
        raise NotImplementedError


class LocalExchange(MemberExchange):
    """Every member in this process, on one device: a permutation is a
    list rotation and the all-to-all a reshuffle of chunks. It runs the
    ring or the pipeline over ``size`` virtual members on one card, and
    holds them against the JAX package on one CPU process."""

    def __init__(self, size: int):
        self.size = int(size)
        self.local = tuple(range(self.size))

    def permute(self, items: list, perm: list):
        src_of = {d: s for s, d in perm}
        return _Done([list(items[src_of[m]]) if m in src_of
                      else [torch.zeros_like(t) for t in items[m]]
                      for m in self.local])

    def all_to_all(self, xs: list, split_dim: int, cat_dim: int) -> list:
        return _split_cat(xs, split_dim, cat_dim)

    def all_gather(self, xs: list, dim: int) -> list:
        whole = torch.cat(xs, dim=dim)
        return [whole] * self.size

    def reduce_scatter(self, xs: list, dim: int) -> list:
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return list(torch.chunk(total, self.size, dim=dim))


class _PostedPermute:
    """One permutation of each local member's tensors (``post_permute``):
    the forward's handle, the structure of the items, and the backward's
    inverse permutation once posted."""

    def __init__(self, exchange, perm: list, items: list):
        self.exchange, self.perm = exchange, perm
        self.widths = [len(item) for item in items]
        self.floats = [t.is_floating_point() for item in items for t in item]
        self.handle = self.back = None

    def pack(self, flat) -> list:
        out, i = [], 0
        for w in self.widths:
            out.append(list(flat[i:i + w]))
            i += w
        return out

    def wait(self) -> list:
        return self.pack(_PermuteWait.apply(self, self.token))


class _PermutePost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hop, *flat):
        from .remat import uncached

        ctx.hop = hop
        with uncached():     # runs again in a remat's recompute
            hop.handle = hop.exchange.permute(hop.pack(flat), hop.perm)
        # the token that orders the wait after the post (a float: its
        # gradient is what runs this backward)
        return next(t for t in flat if t.is_floating_point()).new_empty(0)

    @staticmethod
    def backward(ctx, g_token):
        hop = ctx.hop
        got = [t for item in hop.back.wait() for t in item]
        return (None, *[g if f else None for g, f in zip(got, hop.floats)])


class _PermuteWait(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hop, token):
        from .remat import uncached

        ctx.hop, ctx.token = hop, (token.shape, token.dtype, token.device)
        with uncached():
            got = [t.detach() for item in hop.handle.wait() for t in item]
        hop.handle = None
        ctx.like = [(t.shape, t.dtype, t.device) for t in got]
        ctx.mark_non_differentiable(*[t for t, f in zip(got, hop.floats)
                                      if not f])
        return tuple(got)

    @staticmethod
    def backward(ctx, *grads):
        hop = ctx.hop
        grads = [torch.zeros(shape, dtype=dtype, device=device)
                 if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.like)]
        hop.back = hop.exchange.permute(hop.pack(grads),
                                        [(d, s) for s, d in hop.perm])
        shape, dtype, device = ctx.token
        return None, torch.zeros(shape, dtype=dtype, device=device)


def post_permute(exchange: "MemberExchange", items: list,
                 perm: list) -> _PostedPermute:
    """``exchange.permute(items, perm)`` posted now, autograd-aware: its
    ``wait()`` gives the received items, and the gradients of the float
    tensors travel back over the inverse permutation (posted in the
    backward of the wait, waited in the backward of the post, so the
    backward between the two overlaps it). Integer tensors travel without
    a gradient."""
    hop = _PostedPermute(exchange, perm, items)
    hop.token = _PermutePost.apply(hop, *[t for item in items for t in item])
    return hop


class GroupExchange(MemberExchange):
    """One member per process: this rank of ``group``. A permutation is
    neighbour send / receive through ``dist.batch_isend_irecv`` (gloo on
    the CPU, NCCL on the card), posted in the same order on every rank;
    the all-to-all is ``all_to_all_single``, the all-gather ``all_gather``
    above."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.local = (dist.get_rank(group),)
        self.ranks = [dist.get_global_rank(group, i)
                      for i in range(self.size)]

    def permute(self, items: list, perm: list):
        (me,), (item,) = self.local, items
        dst = {s: d for s, d in perm}.get(me)
        src = {d: s for s, d in perm}.get(me)
        if dst == me:                       # stays here
            return _Done([list(item)])
        if any(t.is_meta for t in item):    # shapes only (the preflight)
            return _Done([[torch.empty_like(t) for t in item]])
        ops, out = [], []
        for t in item:
            if dst is not None:
                ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                      self.ranks[dst], self.group))
            buf = (torch.empty_like(t, memory_format=torch.contiguous_format)
                   if src is not None else torch.zeros_like(t))
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, buf, self.ranks[src],
                                      self.group))
            out.append(buf)
        works = dist.batch_isend_irecv(ops) if ops else []
        return _Posted(works, ops, [out])

    def all_to_all(self, xs: list, split_dim: int, cat_dim: int) -> list:
        (x,) = xs
        n = self.size
        stacked = torch.stack(torch.chunk(x, n, dim=split_dim), 0)
        got = _AllToAll.apply(stacked, self.group)
        return [torch.cat(torch.unbind(got, 0), dim=cat_dim)]

    def all_gather(self, xs: list, dim: int) -> list:
        (x,) = xs
        return [all_gather(x, self.group, dim)]

    def reduce_scatter(self, xs: list, dim: int) -> list:
        (x,) = xs
        return [reduce_scatter(x, self.group, dim)]


class AxesExchange(MemberExchange):
    """One member per process over the product of several process groups
    (mesh axes): ``all_gather`` runs over each group in turn, so the
    members' order is not rank order; the MoE routing gathers each
    token's global index beside it. An empty list of groups is one
    member."""

    def __init__(self, groups: list):
        self.groups = list(groups)
        self.size = 1
        for g in self.groups:
            self.size *= dist.get_world_size(g)
        self.local = (0,)

    def all_gather(self, xs: list, dim: int) -> list:
        (x,) = xs
        for g in self.groups:
            x = all_gather(x, g, dim)
        return [x]
