"""Attention dispatch: the plain einsum path, or the flash kernels.

Counterpart of ``distributed_training_guide_tpu/ops/attention.py``. Shapes
follow the JAX package: q [B, S, Hq, D], k/v [B, S, Hkv, D], grouped-query
attention when Hkv < Hq. On the einsum path ("xla") scores and the softmax
are fp32 whatever the input dtype (the JAX path's
``preferred_element_type=float32``); masked scores take
``finfo(float32).min``. ``impl="flash"`` goes to ``ops/flash_attention.py``
(the CUDA kernels K1-K3 on the card, their plain versions on the CPU).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .remat import checkpoint_name

NO_WINDOW = 2 ** 30   # the band encoding of "no sliding window"


def check_static_window(window) -> None:
    """A window < 1 would mask every score and return all-zero attention
    with no error; refuse it at every entry point."""
    if isinstance(window, int) and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, positions: Optional[torch.Tensor],
                   kv_positions: Optional[torch.Tensor], window=None,
                   scale: Optional[float] = None,
                   logit_softcap: Optional[float] = None) -> torch.Tensor:
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    groups = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    qg = q.reshape(b, sq, hkv, groups, d)
    # products of the input dtype are exact in fp32, so casting first is
    # the JAX einsum with preferred_element_type=float32
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores * scale
    if logit_softcap is not None:   # Gemma-2: tanh cap BEFORE the mask
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if causal:
        if positions is None:
            positions = torch.arange(sq, device=q.device)[None, :]
        if kv_positions is None:
            kv_positions = torch.arange(sk, device=q.device)[None, :]
        qp = positions[:, None, None, :, None]
        kp = kv_positions[:, None, None, None, :]
        mask = qp >= kp
        if window is not None:      # HF sliding_window band: 0 <= i - j < window
            mask &= (qp - kp) < window
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    del scores
    probs, vf = probs.to(v.dtype).float(), v.float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf).reshape(b, sq, hq, d)
    # named so the "attn" remat policies keep the output (ops/remat.py):
    # the one operation that makes the [B, S, H, D] output in q's dtype (a
    # copy even in fp32, where a same-dtype .to would dispatch nothing)
    with checkpoint_name("attn_out"):
        return out.to(q.dtype, copy=True)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        positions: Optional[torch.Tensor] = None,
                        kv_positions: Optional[torch.Tensor] = None,
                        impl: str = "auto", standard_layout: bool = True,
                        window=None, scale: Optional[float] = None,
                        logit_softcap: Optional[float] = None
                        ) -> torch.Tensor:
    """Scaled-dot-product attention with GQA. ``impl``: "xla" (the einsum
    path), "flash" (``ops/flash_attention.flash_attention``), "auto"
    (flash where the JAX package would pick it, with "on a CUDA tensor" for
    "on TPU": causal, tile-aligned, standard layout; the einsum path
    otherwise), or a callable (the ring or Ulysses attention of context
    parallelism): ``impl(q, k, v, standard_layout=..., window=...)`` where
    it declares ``accepts_window``, else without the window; its scale and
    softcap are its own. The flash path takes the standard layout:
    positions are ``arange`` and are not read."""
    if callable(impl):
        if getattr(impl, "accepts_window", False):
            return impl(q, k, v, standard_layout=standard_layout,
                        window=window)
        return impl(q, k, v, standard_layout=standard_layout)
    if window is not None and not causal:
        raise ValueError(
            "window (sliding-window attention) requires causal=True — a "
            "non-causal banded mask is not implemented on either path")
    check_static_window(window)
    if impl == "auto":
        aligned = (q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0
                   and q.shape[-1] % 64 == 0)
        impl = ("flash" if (q.is_cuda and aligned and causal
                            and standard_layout) else "xla")
    if impl == "flash":
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale, logit_softcap=logit_softcap)
    if impl != "xla":
        raise ValueError(f"impl must be 'auto', 'flash' or 'xla', got "
                         f"{impl!r}")
    return _xla_attention(q, k, v, causal, positions, kv_positions, window,
                          scale, logit_softcap)
