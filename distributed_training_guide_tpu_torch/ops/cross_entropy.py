"""Causal-LM loss.

Counterpart of ``distributed_training_guide_tpu/ops/cross_entropy.py``:
the shift lives in the loss (labels are the input ids), log-softmax is
fp32, and ``label == -100`` masks a position out of the mean (the HF
convention). ``fused_linear_cross_entropy`` waits with ``ops/overlap.py``
(ROADMAP.md queue 1, 'Context parallel, pipeline parallel and overlap').

Under a sharding plan the loss is ``global_mean_loss``: the global NLL sum
over the global valid count, the ``(sum, count)`` pair summed over the
ranks that hold different tokens, never a mean of per-rank means (the two
differ whenever ``-100`` labels fall unevenly across ranks).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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


def _chunk_nll(h_c, w_out, t_c):
    return _nll(matmul_f32_out(h_c, w_out), t_c)


def chunked_causal_lm_loss(hidden: torch.Tensor, w_out: torch.Tensor,
                           labels: torch.Tensor,
                           num_chunks: int = 8) -> torch.Tensor:
    """Cross-entropy straight from the final hidden states, never holding
    the full [B, S, V] logits: the shifted sequence is cut into
    ``num_chunks`` slices, each slice's fp32 logits are reduced to
    (nll sum, count) and dropped, and ``torch.utils.checkpoint`` makes
    backward recompute them, as ``jax.checkpoint`` on the JAX scan body
    does. hidden [B, S, E]; w_out [E, V]; labels [B, S]."""
    b, s, e = hidden.shape
    h = hidden[:, :-1, :]
    targets = labels[:, 1:]
    n = s - 1
    pad = (-n) % num_chunks
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad),
                                          value=IGNORE_INDEX)
    chunk = (n + pad) // num_chunks
    h = h.reshape(b, num_chunks, chunk, e)
    targets = targets.reshape(b, num_chunks, chunk)
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(num_chunks):
        nll, cnt = checkpoint(_chunk_nll, h[:, i], w_out, targets[:, i],
                              use_reentrant=False)
        nll_sum = nll_sum + nll
        count = count + cnt
    return nll_sum / count.clamp_min(1)
