"""Causal-LM loss.

Counterpart of ``distributed_training_guide_tpu/ops/cross_entropy.py``:
the shift lives in the loss (labels are the input ids), log-softmax is
fp32, and ``label == -100`` masks a position out of the mean (the HF
convention). ``fused_linear_cross_entropy`` is the hidden->loss kernel
(chunked, with its own backward; vocab-parallel under a tp group) that
``ops/overlap.py:make_fused_loss`` runs for ``loss_chunks`` and the
overlap schedule, on one device and under a plan; it stands for the JAX
package's ``chunked_causal_lm_loss`` too, which computes the same loss.

Under a sharding plan the loss is ``global_mean_loss``: the global NLL sum
over the global valid count, the ``(sum, count)`` pair summed over the
ranks that hold different tokens, never a mean of per-rank means (the two
differ whenever ``-100`` labels fall unevenly across ranks).
"""
from __future__ import annotations

import torch

from .matmul import matmul_f32_out

IGNORE_INDEX = -100


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> tuple:
    """(sum of the next-token NLL over valid targets, their count)."""
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - picked) * valid).sum(), valid.sum()


def nll_and_count(logits: torch.Tensor, targets: torch.Tensor) -> tuple:
    """(NLL sum, valid count) of fp32 ``logits`` [..., V] against already
    shifted ``targets`` [...]."""
    return _nll(logits.float(), targets)


def global_mean_loss(nll_sum: torch.Tensor, count: torch.Tensor,
                     groups: list) -> torch.Tensor:
    """``sum over ranks of nll_sum / sum over ranks of count``, summed over
    each process group of ``groups`` in turn. The count is a constant; the
    sum's backward is the identity, so each rank's gradient is its own
    tokens' share of the global mean's."""
    from .collectives import all_reduce, all_reduce_

    count = count.detach().to(torch.float32)
    for g in groups:
        nll_sum = all_reduce(nll_sum, g)
        count = all_reduce_(count, g)
    return nll_sum / count.clamp_min(1)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy. logits [B, S, V]; labels [B, S] (the
    input tokens, shifted here)."""
    nll, count = _nll(logits[:, :-1, :].float(), labels[:, 1:])
    return nll / count.clamp_min(1)


def _chunk_logz_picked(logits, t_c, valid, group, rank) -> tuple:
    """(logz, target logit) of one chunk's fp32 logits; vocab-parallel
    over ``group`` (``ops/vocab_parallel.py``)."""
    from .vocab_parallel import sharded_logsumexp, sharded_pick

    if group is None:
        safe = torch.where(valid, t_c, 0).long()
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, safe[..., None])[..., 0])
    return (sharded_logsumexp(logits, group),
            sharded_pick(logits, t_c, valid, group, rank))


class _FusedNLL(torch.autograd.Function):
    """The NLL sum of rows ``h`` [C * c, E] against targets ``t`` [C * c]
    (``IGNORE_INDEX`` masked) through ``w`` [E, V_local], ``chunks`` rows
    at a time, never holding more than one chunk's fp32 logits.

    Forward: each chunk's logits (the fp32 accumulator of the product),
    logz and the target logit, summed; it saves h, w, t and the [rows]
    fp32 logz only. Backward recomputes one chunk's logits at a time and
    spells the cotangent ``softmax - onehot`` (the softmax from the saved
    global logz), rounds it to the operands' dtype as
    ``ops/matmul.py:matmul_f32_out``'s backward does, and takes both
    products with the fp32 accumulator: dh per chunk, dw summed in fp32
    over the chunks and narrowed once.

    With a tp ``group`` the vocab is sharded: logz and the pick are the
    sharded ones (each rank holds the same loss), the one-hot is the
    in-shard target's, and every rank's dw is the gradient of that one
    loss for its vocab shard. torch seeds each rank's backward with the
    loss's own cotangent (no 1 / tp split as a JAX manual region's
    replicated output has), so no collective touches dw. dh is this
    rank's vocab shard's share: the caller's entry collective (the
    sequence all-gather under sequence parallelism, ``copy_to`` without)
    sums it over tp."""

    @staticmethod
    def forward(ctx, h, w, t, chunks, group, rank):
        c = h.shape[0] // chunks
        acc = torch.zeros((), dtype=torch.float32, device=h.device)
        logzs = torch.empty(h.shape[0], dtype=torch.float32,
                            device=h.device)
        for i in range(chunks):
            rows = slice(i * c, (i + 1) * c)
            t_c = t[rows]
            valid = t_c != IGNORE_INDEX
            logz, picked = _chunk_logz_picked(matmul_f32_out(h[rows], w), t_c,
                                              valid, group, rank)
            acc = acc + ((logz - picked) * valid).sum()
            logzs[rows] = logz
        ctx.save_for_backward(h, w, t, logzs)
        ctx.chunks, ctx.rank = chunks, rank
        ctx.sharded = group is not None
        return acc

    @staticmethod
    def backward(ctx, g):
        from .vocab_parallel import shard_local_targets

        h, w, t, logzs = ctx.saved_tensors
        chunks = ctx.chunks
        c = h.shape[0] // chunks
        v_local = w.shape[-1]
        dh = torch.empty_like(h)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i in range(chunks):
            rows = slice(i * c, (i + 1) * c)
            h_c, t_c = h[rows], t[rows]
            valid = t_c != IGNORE_INDEX
            # the recomputed logits become softmax - onehot in place
            p = matmul_f32_out(h_c, w).sub_(logzs[rows, None]).exp_()
            if ctx.sharded:
                safe, in_shard = shard_local_targets(t_c, valid, v_local,
                                                     ctx.rank)
                hit = valid & in_shard
            else:
                safe, hit = torch.where(valid, t_c, 0).long(), valid
            p.scatter_add_(-1, safe[:, None], -hit.to(p.dtype)[:, None])
            dl = p.mul_((valid * g)[:, None]).to(h.dtype)
            dh[rows] = matmul_f32_out(dl, w.T).to(h.dtype)
            dw += matmul_f32_out(h_c.T, dl)
        return dh, dw.to(w.dtype), None, None, None, None


def fused_linear_cross_entropy(hidden: torch.Tensor, w_out: torch.Tensor,
                               labels: torch.Tensor, *, num_chunks: int = 8,
                               vocab_group=None, vocab_rank: int = 0,
                               shifted: bool = False) -> tuple:
    """The fused hidden->loss on this rank's rows: shift, flatten to rows,
    pad to the chunk grid with ignored rows, run ``_FusedNLL``. Returns
    ``(nll_sum, count)``, fp32 scalars and LOCAL sums: the caller owns the
    mean over ranks (``ops/overlap.py:make_fused_loss``,
    ``global_mean_loss``). hidden [B, S, E]; w_out [E, V_local] (the vocab
    shard of ``vocab_rank`` in ``vocab_group``, or the whole head); labels
    [B, S], global ids, ``-100`` ignored; ``shifted``: ``labels`` are
    already the next-token targets of every row (a context-parallel
    shard's), so nothing is dropped."""
    b, s, e = hidden.shape
    if shifted:
        h, t = hidden.reshape(b * s, e), labels.reshape(b * s)
    else:
        h = hidden[:, :-1, :].reshape(b * (s - 1), e)
        t = labels[:, 1:].reshape(b * (s - 1))
    pad = (-h.shape[0]) % num_chunks
    if pad:
        h = torch.cat([h, h.new_zeros(pad, e)])
        t = torch.cat([t, t.new_full((pad,), IGNORE_INDEX)])
    nll = _FusedNLL.apply(h, w_out, t, num_chunks, vocab_group, vocab_rank)
    count = (t != IGNORE_INDEX).sum().to(torch.float32)
    return nll, count


def validate_chunked_loss_support(family_mod, family: str, loss_fn) -> None:
    """What the chunked and the fused loss need: a family with
    ``output_weights`` and the causal-LM loss itself."""
    if not hasattr(family_mod, "output_weights"):
        raise NotImplementedError(
            f"loss_chunks unsupported for family {family!r}")
    if loss_fn is not causal_lm_loss:
        raise NotImplementedError(
            "loss_chunks hardwires the causal-LM loss; drop the custom "
            "loss_fn or the chunking")
