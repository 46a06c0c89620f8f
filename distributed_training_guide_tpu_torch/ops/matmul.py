"""The fp32-accumulator product of 16-bit operands, for the logits, and
the bf16 split of an fp32 operand.

The JAX package computes the output head and the chunked loss's logits as
``jnp.dot(h, w, preferred_element_type=float32)``: bf16 operands, the fp32
accumulator as the result. This is that product in PyTorch, with a
backward (``torch.mm(..., out_dtype=...)`` has no autograd formula).
``split_bf16`` is the fp32 operand as the split tensor-core bodies of K5
and K7 take it, for their plain versions.
"""
from __future__ import annotations

import torch

from .._device import runs_plain


class _MatmulF32Out(torch.autograd.Function):
    """[N, E] @ [E, V] of 16-bit operands with the fp32 accumulator as the
    result (``torch.mm(..., out_dtype=float32)``, which has no autograd
    formula). Backward rounds the fp32 cotangent to the operands' dtype
    and takes both products with fp32 accumulation, as a TPU's default
    matmul precision does with an fp32 operand."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(g, b.T, out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.mm(a.T, g, out_dtype=torch.float32).to(b.dtype)
        return da, db


def matmul_f32_out(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h [..., E] @ w [E, V]`` with an fp32 result from the fp32
    accumulator: the JAX ``jnp.dot(..., preferred_element_type=float32)``.
    fp32 operands take the plain product; 16-bit operands take
    ``torch.mm(..., out_dtype=float32)`` on the card and an fp32 product
    of their values on the CPU (products of bf16 values are exact in fp32,
    so that is the same computation). No fp32 copy of ``w`` is kept."""
    if h.dtype == torch.float32 and w.dtype == torch.float32:
        return h @ w
    if runs_plain(h):
        return h.float() @ w.float()
    lead = h.shape[:-1]
    out = _MatmulF32Out.apply(h.reshape(-1, h.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1])


def split_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` as a split tensor-core body takes it: hi = bf16(x) plus
    lo = bf16(x - hi), summed in fp32 (exact: each part keeps 8
    significant bits). It misses x by at most 2**-16 |x|."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()
