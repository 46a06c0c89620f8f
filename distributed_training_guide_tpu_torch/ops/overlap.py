"""The overlap schedule and the fused hidden->loss.

Counterpart of ``distributed_training_guide_tpu/ops/overlap.py``. The
unscheduled forward gathers a layer's fsdp shards inside the layer, at
use (``parallel/plans.py:LocalLayout.gather_layer``), and autograd keeps
each gathered weight until the layer's backward. ``--overlap-schedule``
swaps that for an explicit schedule (``LayerSchedule``):

- the next layer's fsdp gathers are issued before this layer's compute
  (``torch.distributed._functional_collectives``, whose
  ``AsyncCollectiveTensor`` is waited at use), so the collective runs
  while the layer computes;
- each gather's backward reduce-scatters the cotangent widened to fp32
  and narrows it back (``_GatherRS``), inside the layer's backward;
- every layer runs under ``ops/remat.py:remat``: without a user policy
  under ``save_anything_except("fsdp_gather")``, so autograd saves what
  it always saves but a gathered weight (gathered in the dtype its block
  multiplies in, so the block's cast makes no copy), which the backward
  gathers again when it needs it: the sharded params stay
  the only persistent copy (FSDP semantics); with ``remat`` the user's
  policy decides, and none of the named policies keeps a gather (the
  recompute gathers again).

``make_fused_loss`` is the same idea applied to the loss: the chunked
hidden->loss of ``ops/cross_entropy.py:fused_linear_cross_entropy`` on a
plan's vocab shard, so the ``[B * S, V]`` fp32 logits never exist.

The JAX module's ``RECOMMENDED_XLA_FLAGS`` name XLA's latency-hiding
scheduler flags; eager PyTorch has no such scheduler and the port no
counterpart: the order of issue and wait above is the schedule.

Numerics: the scheduled gather's values are the unscheduled gather's, and
its backward sums the same shards in fp32. With fp32 params the two paths
are bitwise equal; with 16-bit params the scheduled reduce-scatter sums in
fp32 and rounds once, where the unscheduled one
(``ops/collectives.py:_AllGather``) sums in the params' dtype, so the two
differ by the rounding of that sum (at most half an ulp of the param
dtype per summed element under round-to-nearest, against the
unscheduled sum's accumulated roundings).
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

from .collectives import _GATHER, _scatter, _wait
from .remat import (checkpoint_name, remade_by, remat, resolve_remat_policy,
                    save_anything_except, uncached)

GATHER_NAME = "fsdp_gather"


def _issue(local: torch.Tensor, dim: int, group, dtype=None):
    """The all-gather of ``local`` (cast to ``dtype``, None: as it is)
    along ``dim`` over ``group``, posted: a handle for ``_finish``.
    Gathered on dim 0 of the moved view, so the collective stays
    asynchronous for every dim."""
    x = local.detach()
    if dtype is not None:
        x = x.to(dtype)
    if dim:
        x = x.movedim(dim, 0)
    return _GATHER(x.contiguous(), 0, group)


def _finish(handle, dim: int) -> torch.Tensor:
    full = _wait(handle)
    return full.movedim(0, dim).contiguous() if dim else full


def _regather(local: torch.Tensor, dim: int, group, dtype,
              counts) -> torch.Tensor:
    """The backward's gather of a weight the forward dropped."""
    if counts is not None:
        counts["regather"] += 1
    return _finish(_issue(local, dim, group, dtype), dim)


class _GatherRS(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``, in ``dtype`` (None: the
    param's; the schedule passes the dtype the block computes in, so the
    block's own cast is a no-op and the tensor it saves is this one),
    whose backward reduce-scatters the cotangent widened to fp32 and
    narrows it to the param's dtype. ``pending`` (a list holding a posted
    gather of ``local``, or empty): the forward waits for it instead of
    gathering. The collective runs under the name "fsdp_gather" (a
    ``save_anything_except`` scope drops the result and gathers again in
    the backward) and outside a selective checkpoint's cache (the forward
    may wait where the recompute gathers)."""

    @staticmethod
    def forward(ctx, local, dim, group, pending, counts, kind, dtype):
        ctx.dim, ctx.group, ctx.dtype = dim, group, local.dtype
        with checkpoint_name(GATHER_NAME), uncached():
            handle = (pending.pop() if pending
                      else _issue(local, dim, group, dtype))
            full = _finish(handle, dim)
            remade_by(full, functools.partial(_regather, local.detach(), dim,
                                              group, dtype, counts))
        if counts is not None:
            counts[kind] += 1
        return full

    @staticmethod
    def backward(ctx, g):
        return (_scatter(g.float(), ctx.dim, ctx.group).to(ctx.dtype),
                None, None, None, None, None, None)


def gather_with_rs_vjp(local: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``local`` all-gathered along ``dim`` over ``group``; the backward
    reduce-scatters the cotangent in fp32 (``_GatherRS``)."""
    return _GatherRS.apply(local, dim, group, None, None, None, None)


def _layer_items(layer: dict, prefix: str = "") -> list:
    out = []
    for k, v in layer.items():
        if isinstance(v, dict):
            out += _layer_items(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _set(layer: dict, path: str, value) -> dict:
    head, _, rest = path.partition("/")
    if not rest:
        return {**layer, head: value}
    return {**layer, head: _set(layer[head], rest, value)}


class LayerSchedule:
    """The layer loop of a family's forward with the fsdp gathers
    scheduled (built by ``make_layer_schedule``; the families' ``apply(...,
    layer_schedule=...)`` runs it in place of their loop).

    Call as ``schedule(block, carry, layers, wins)``: ``block(carry,
    layer, window)`` is the family's layer on a layer whose scheduled
    leaves are already gathered (``layout_for`` gives the layout that
    passes them through); ``layers`` the stacked ``params["layers"]``;
    ``wins`` the per-layer windows or None. ``counts`` holds the leaves
    gathered in forwards ("gather") and again for the backward
    ("regather"): 2 x layers x ``n_gathered`` a microbatch."""

    def __init__(self, gathers: dict, *, remat: bool, remat_policy: Any):
        # {leaf path under "layers/": (dim of the per-layer leaf, group,
        # the dtype it is gathered in or None)}
        self.gathers = dict(gathers)
        self.paths = frozenset(f"layers/{p}" for p in self.gathers)
        self.n_gathered = len(self.gathers)
        self.counts = {"gather": 0, "regather": 0}
        if remat:
            # the user's policy decides what survives; none of the named
            # policies saves a gather, so the backward gathers again
            self.remat, self.policy = True, resolve_remat_policy(
                remat_policy)
        elif self.gathers:
            # save everything but the gathered weights (FSDP semantics)
            self.remat = True
            self.policy = save_anything_except(GATHER_NAME)
        else:
            # nothing to drop: the layer runs as it would unscheduled
            self.remat, self.policy = False, None

    def layout_for(self, layout):
        """``layout`` for the blocks: the scheduled leaves handed over
        already gathered."""
        return layout.pregathered(self.paths) if self.paths else layout

    def _prefetch(self, layer: dict) -> dict:
        with torch.no_grad():
            return {p: [_issue(t, *self.gathers[p])]
                    for p, t in _layer_items(layer) if p in self.gathers}

    def gather_layer(self, layer: dict, pending: Optional[dict],
                     kind: str) -> dict:
        """``layer`` with its scheduled leaves gathered: waited for where
        ``pending`` holds their posted gathers, else gathered here."""
        for p, t in _layer_items(layer):
            if p in self.gathers:
                dim, group, dtype = self.gathers[p]
                held = [] if pending is None else pending[p]
                layer = _set(layer, p, _GatherRS.apply(
                    t, dim, group, held, self.counts, kind, dtype))
        return layer

    def _cell(self, block, carry, layer, pending, window):
        calls = [0]

        def cell(carry, layer, window):
            first = calls[0] == 0
            calls[0] += 1
            full = self.gather_layer(layer, pending if first else None,
                                     "gather" if first else "regather")
            return block(carry, full, window)

        if not self.remat:
            return cell(carry, layer, window)
        # a recompute runs to the cell's end: a posted exchange (the
        # expert ring's) is always waited for
        with set_checkpoint_early_stop(False):
            return remat(cell, carry, layer, window, policy=self.policy)

    def __call__(self, block, carry, layers: dict, wins=None):
        from ..models.llama import _num_layers, _unbind_layers

        per = _unbind_layers(layers, _num_layers(layers))
        pending = self._prefetch(per[0]) if self.gathers else None
        for i, layer in enumerate(per):
            nxt = (self._prefetch(per[i + 1])
                   if self.gathers and i + 1 < len(per) else None)
            carry = self._cell(block, carry, layer, pending,
                               None if wins is None else wins[i])
            pending = nxt
        return carry


def make_layer_schedule(layout=None, layer_axes: Optional[dict] = None, *,
                        remat: bool, remat_policy: Any, compute_dtype=None,
                        fp32_leaves=frozenset()) -> LayerSchedule:
    """The schedule of a plan's stacked layer params. ``layout``: the
    plan's ``LocalLayout`` (None: one device, nothing gathered);
    ``layer_axes``: each leaf's logical axes by its path ("layers/...";
    needed with a layout).
    Every leaf whose spec names fsdp is gathered by the schedule but
    the expert stacks under an active ep axis, which stay with the
    dispatch (as in the JAX package), and the leaves the layout marks
    ``gathered_by_dispatch``. Plans with no such leaf (ddp, zero1/2, tp,
    ep) get the schedule's layer loop with nothing gathered.

    A gathered weight (a leaf of two dims or more a layer) is handed over
    in ``compute_dtype``, the dtype its block multiplies in, but for the
    paths under "layers/" in ``fp32_leaves`` (the family's
    ``FP32_LAYER_LEAVES``: weights its block reads in fp32); vectors
    (norm scales, biases) keep the param dtype."""
    from ..parallel.plans import entry_axes

    gathers: dict = {}
    if layout is not None:
        plan = layout.plan
        ep_active = plan.sizes["ep"] > 1
        for path, spec in layout.specs.items():
            if not path.startswith("layers/"):
                continue
            if path in layout.gathered_by_dispatch or (
                    ep_active and "experts" in layer_axes[path]):
                continue
            per_layer = spec[1:]           # the stacked [L] dim dropped
            dims = [d for d, e in enumerate(per_layer)
                    if "fsdp" in entry_axes(e)]
            if not dims:
                continue
            (dim,) = dims
            if entry_axes(per_layer[dim]) != ("fsdp",):
                raise NotImplementedError(
                    f"{path}: spec {spec} shards one dim over fsdp and "
                    f"another axis; the schedule gathers fsdp alone")
            # (a spec may leave out trailing unsharded dims; the logical
            # axes name every dim)
            ndim = len(layer_axes[path]) - 1
            cast = (compute_dtype if ndim > 1
                    and path[len("layers/"):] not in fp32_leaves else None)
            gathers[path[len("layers/"):]] = (dim, plan.group("fsdp"), cast)
    return LayerSchedule(gathers, remat=remat, remat_policy=remat_policy)


# ---------------------------------------------------------------------------
# fused hidden -> loss
# ---------------------------------------------------------------------------

def _leaf(params: dict, path: str):
    for k in path.split("/"):
        params = params[k]
    return params


def _head_weights(layout, config, params: dict) -> torch.Tensor:
    """[E, V or V/tp] output projection in compute dtype: the head (or the
    tied table's transpose) with its fsdp shards gathered, the gather's
    backward reduce-scattering in fp32; a tp vocab shard stays."""
    from ..parallel.plans import entry_axes

    path = layout.head_path or layout.table_path
    w = _leaf(params, path)
    for d, e in enumerate(layout.specs[path]):
        if "fsdp" in entry_axes(e):
            w = gather_with_rs_vjp(w, d, layout.plan.group("fsdp"))
    return (w if layout.head_path else w.T).to(config.dtype)


def make_fused_loss(layout=None, *, num_chunks: int = 8, family_mod=None):
    """The fused hidden->loss for a plan: ``loss(config, params, hidden,
    labels) -> scalar``, the global mean next-token NLL without the
    ``[B * S, V]`` logits.

    - vocab on tp: every tp rank runs the vocab-parallel chunk math on
      its shard of the head; the hidden enters through the layout (under
      sequence parallelism its sequence all-gathered first, whose backward
      reduce-scatters dh; without, ``copy_to``, whose backward sums dh
      over tp);
    - vocab (or the head's embed dim) on fsdp: the head gathered with the
      fp32 reduce-scatter backward, each rank on its own rows;
    - unsharded: the local chunked kernel.

    ``(nll, count)`` is summed over the data axes (tp ranks hold the same
    rows) and cp, as ``ops/cross_entropy.py:global_mean_loss``. Under
    context parallelism each rank runs its sequence shard against its
    targets, shifted before the sequence was sharded (``labels`` are
    then those targets). ``layout`` None: one device, the head from
    ``family_mod.output_weights``."""
    from .cross_entropy import fused_linear_cross_entropy, global_mean_loss

    if layout is None:
        def local_loss(config, params, hidden, labels):
            nll, cnt = fused_linear_cross_entropy(
                hidden, family_mod.output_weights(config, params), labels,
                num_chunks=num_chunks)
            return nll / cnt.clamp_min(1)
        return local_loss

    plan = layout.plan
    groups = [plan.group(a) for a in plan.data_axes]
    if layout.cp > 1:
        groups.append(layout.cp_group)
    tp_vocab = layout.vocab_parallel

    def loss(config, params, hidden, labels):
        w = _head_weights(layout, config, params)
        if tp_vocab:
            hidden = layout.enter(hidden)
        nll, cnt = fused_linear_cross_entropy(
            hidden, w, labels, num_chunks=num_chunks,
            vocab_group=layout.tp_group if tp_vocab else None,
            vocab_rank=layout.tp_rank, shifted=layout.cp > 1)
        return global_mean_loss(nll, cnt, groups)

    return loss


def fused_loss_supported(plan, config, family_mod, loss_fn) -> Optional[str]:
    """Why the fused hidden->loss cannot run for this setup (None: it can).
    The Trainer then keeps the standard loss rather than change what is
    computed."""
    from .cross_entropy import causal_lm_loss

    if not hasattr(family_mod, "output_weights"):
        return "family has no output_weights"
    if loss_fn is not causal_lm_loss:
        return "custom loss_fn"
    if getattr(config, "final_logit_softcap", None):
        return ("final_logit_softcap is applied by lm_head_logits, which the "
                "fused hidden->loss kernel bypasses")
    if plan is None:
        return None
    sizes = plan.sizes
    vocab_rule = plan.rules.get("vocab")
    if vocab_rule not in (None, "tp", "fsdp"):
        return f"vocab sharded on unsupported axis {vocab_rule!r}"
    if vocab_rule is not None:
        size = sizes.get(vocab_rule, 1)
        if size > 1 and config.vocab_size % size:
            return (f"vocab_size {config.vocab_size} not divisible by "
                    f"{vocab_rule}={size}")
    return None
