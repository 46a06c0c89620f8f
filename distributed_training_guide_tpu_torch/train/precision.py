"""Precision policies and block-wise int8 quantization.

Counterpart of ``distributed_training_guide_tpu/train/precision.py``.
``resolve_policy`` names what dtype each piece of training state is
stored in; this slice ports the default ``fp32`` policy (bf16 compute
from fp32 params, fp32 AdamW moments, fp32 grad accumulation), and
``bf16-master`` / ``adam8bit`` raise until ROADMAP.md queue 1,
'Remat policies, precision and optimizers'.

``quantize_blockwise`` and ``dequantize_blockwise`` (Dettmers absmax, as
the quantized KV pool uses them; the ``sqrt_domain`` variant serves the
8-bit optimizer, not ported here) are the same arithmetic in the same
order as the JAX functions; both frameworks round half to even, so the
int8 payloads agree bit for bit on equal inputs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F


class Quantized(NamedTuple):
    """Block-quantized tensor: int8 payload ``q`` in the source shape and
    one fp32 ``scale`` per block of the trailing axis
    (``q.shape[:-1] + (nblocks,)``)."""

    q: torch.Tensor
    scale: torch.Tensor


def block_geometry(d: int, block_size: int) -> tuple:
    """(nblocks, effective block size) for a trailing axis of length d."""
    nblocks = -(-d // max(block_size, 1))
    bs = -(-d // nblocks)
    return -(-d // bs), bs


def quantize_blockwise(x: torch.Tensor, block_size: int = 128) -> Quantized:
    """Absmax int8 quantization per block of the trailing axis."""
    x = x.to(torch.float32)
    d = x.shape[-1]
    nblocks, bs = block_geometry(d, block_size)
    pad = nblocks * bs - d
    xb = F.pad(x, (0, pad)) if pad else x
    xb = xb.reshape(*x.shape[:-1], nblocks, bs)
    amax = torch.amax(torch.abs(xb), dim=-1)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    q = q.to(torch.int8).reshape(*x.shape[:-1], nblocks * bs)[..., :d]
    return Quantized(q=q, scale=scale)


def dequantize_blockwise(qt: Quantized, dtype=torch.float32) -> torch.Tensor:
    d = qt.q.shape[-1]
    bs = -(-d // qt.scale.shape[-1])
    scale = torch.repeat_interleave(qt.scale, bs, dim=-1)[..., :d]
    return (qt.q.to(torch.float32) * scale).to(dtype)


def cast_floats(tree, dtype):
    """Cast the floating-point leaves of a nested dict to ``dtype``;
    integer leaves pass through untouched."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One storage policy for the whole train state: the fp32 policy
    stores params, moments and the grad-accumulation buffer in fp32."""

    name: str


POLICIES = {"fp32": PrecisionPolicy(name="fp32")}
_UNPORTED_POLICIES = ("bf16-master", "adam8bit")


def resolve_policy(spec) -> PrecisionPolicy:
    """A policy name (or a PrecisionPolicy, or None for fp32)."""
    if isinstance(spec, PrecisionPolicy):
        return spec
    if spec is None:
        return POLICIES["fp32"]
    parts = [p.strip() for p in str(spec).split("+") if p.strip()]
    if parts == ["fp32"]:
        return POLICIES["fp32"]
    if parts and all(p in POLICIES or p in _UNPORTED_POLICIES
                     for p in parts):
        raise NotImplementedError(
            f"precision policy {spec!r} is not ported yet: only 'fp32' "
            f"(ROADMAP.md queue 1, 'Remat policies, precision and "
            f"optimizers')")
    raise ValueError(f"unknown precision policy {spec!r}; use one of "
                     f"{sorted(POLICIES) + list(_UNPORTED_POLICIES)}")
