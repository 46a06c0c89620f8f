"""Vocab-parallel embedding and cross-entropy on a tp-sharded table.

Counterpart of ``distributed_training_guide_tpu/ops/vocab_parallel.py``:
each tp rank owns a contiguous vocab shard of the embedding table / output
projection, and the collectives are written out (``ops/collectives.py``).
Full [B, S, V] logits never exist on any rank: the logsumexp is a local
reduce plus a sum over the group, the target logit a masked local gather
plus a sum. With ``group=None`` (tp = 1) each function is its plain
single-device form.
"""
from __future__ import annotations

from typing import Optional

import torch

from .collectives import all_reduce, all_reduce_, reduce_scatter
from .cross_entropy import IGNORE_INDEX


def _shard_local(ids: torch.Tensor, v_local: int, rank: int) -> tuple:
    """Global ids -> (ids clipped into this rank's vocab slice, in-shard
    mask)."""
    local = ids.long() - rank * v_local
    in_shard = (local >= 0) & (local < v_local)
    return local.clamp(0, v_local - 1), in_shard


def vocab_parallel_embed(table_local: torch.Tensor, input_ids: torch.Tensor,
                         group, rank: int, *,
                         scatter_dim: Optional[int] = None) -> torch.Tensor:
    """Embedding lookup from a vocab-sharded table: out-of-shard ids give
    zero rows, and the partial rows are summed over the group (onto this
    rank's chunk of ``scatter_dim`` when given: sequence parallelism).

    table_local: [V/tp, E]; input_ids: [...]; returns [..., E]."""
    safe, in_shard = _shard_local(input_ids, table_local.shape[0], rank)
    rows = table_local[safe] * in_shard[..., None].to(table_local.dtype)
    if scatter_dim is not None:
        return reduce_scatter(rows, group, scatter_dim)
    return all_reduce(rows, group)


def shard_local_targets(targets: torch.Tensor, valid: torch.Tensor,
                        v_local: int, rank: int) -> tuple:
    """Global target ids -> (ids clipped into this rank's vocab slice,
    in-shard mask); an invalid target reads id 0. Shared by
    ``sharded_pick`` and the fused loss's backward (the one-hot against
    the local slice, ``ops/cross_entropy.py``)."""
    return _shard_local(torch.where(valid, targets, 0), v_local, rank)


def sharded_logsumexp(logits: torch.Tensor, group) -> torch.Tensor:
    """logsumexp over a vocab-sharded last dim: the max and the sum of
    exponentials, each reduced over the group. Values only: the gradient
    is ``_ShardedLogZPicked``'s (or the fused loss's own backward).
    logits: [..., V/tp] fp32 -> [...]."""
    m = all_reduce_(logits.amax(-1), group,
                    op=torch.distributed.ReduceOp.MAX)
    m = m.masked_fill(m.abs() == float("inf"), 0)
    sumexp = all_reduce_((logits - m[..., None]).exp().sum(-1), group)
    return sumexp.log().add(m)


def _pick(logits, safe, in_shard, group) -> torch.Tensor:
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    return all_reduce_(torch.where(in_shard, picked, 0.0), group)


def sharded_pick(logits: torch.Tensor, targets: torch.Tensor,
                 valid: torch.Tensor, group, rank: int) -> torch.Tensor:
    """The target's logit out of a vocab-sharded last dim: the masked local
    gather summed over the group (values only, as ``sharded_logsumexp``).
    logits [..., V/tp], targets / valid [...] -> [...]."""
    safe, in_shard = shard_local_targets(targets, valid, logits.shape[-1],
                                         rank)
    return _pick(logits, safe, in_shard, group)


class _ShardedLogZPicked(torch.autograd.Function):
    """(logsumexp, target logit) of each row of vocab-sharded logits, the
    same on every rank of the group. Forward: ``sharded_logsumexp`` and
    the in-shard target logit summed over the group. Backward, per rank
    and with no collective (every rank holds the same two outputs and
    their cotangents): ``g_logz * exp(l - logz)`` plus ``g_picked`` at the
    in-shard target, torch's own ``logsumexp`` and ``gather`` backward, so
    one rank's result is the plain loss's bit for bit."""

    @staticmethod
    def forward(ctx, logits, safe, in_shard, group):
        logz = sharded_logsumexp(logits, group)
        picked = _pick(logits, safe, in_shard, group)
        ctx.save_for_backward(logits, logz, safe, in_shard)
        return logz, picked

    @staticmethod
    def backward(ctx, g_logz, g_picked):
        logits, logz, safe, in_shard = ctx.saved_tensors
        # in place: one [..., V/tp] temporary (x + 0 is x, so adding the
        # target's cotangent in place equals adding gather's zero-filled
        # grad)
        grad = (logits - logz[..., None]).exp_().mul_(g_logz[..., None])
        grad.scatter_add_(-1, safe[..., None],
                          torch.where(in_shard, g_picked, 0.0)[..., None])
        return grad, None, None, None


def vocab_parallel_nll(logits_local: torch.Tensor, targets: torch.Tensor,
                       group, rank: int) -> tuple:
    """(sum of the NLL over valid targets, their count) from vocab-sharded
    logits, the same on every rank of the group.

    logits_local: [..., V/tp] (fp32 taken); targets: [...] global ids,
    ``IGNORE_INDEX`` masked. Each rank's gradient is that of the one loss
    for its own vocab shard (``_ShardedLogZPicked``)."""
    logits = logits_local.float()
    valid = targets != IGNORE_INDEX
    safe, in_shard = shard_local_targets(targets, valid, logits.shape[-1],
                                         rank)
    logz, picked = _ShardedLogZPicked.apply(logits, safe, in_shard, group)
    return ((logz - picked) * valid).sum(), valid.sum()


def vocab_parallel_causal_lm_loss(logits_local: torch.Tensor,
                                  labels: torch.Tensor, group,
                                  rank: int) -> torch.Tensor:
    """Mean next-token cross-entropy over vocab-sharded logits (the shift
    inside, -100 ignored): ``ops/cross_entropy.causal_lm_loss`` on the
    shards. logits_local [B, S, V/tp]; labels [B, S], the same on every
    rank of the group."""
    nll, count = vocab_parallel_nll(logits_local[:, :-1], labels[:, 1:],
                                    group, rank)
    return nll / count.clamp_min(1)
