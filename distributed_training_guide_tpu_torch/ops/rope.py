"""Rotary position embeddings (half-rotation convention, Llama-style), the
six HF ``rope_scaling`` types (default / linear / dynamic NTK / yarn /
longrope / llama3) as pure functions of the config, in PyTorch.

Counterpart of ``distributed_training_guide_tpu/ops/rope.py``: the same
formulas in the same order, computed in float32 and cast back to the
input dtype. Seq-length-dependent types (``dynamic``, ``longrope``) use
``max(positions) + 1``, as HF's ``@dynamic_rope_update`` does.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

ROPE_TYPES = ("default", "linear", "dynamic", "yarn", "longrope", "llama3")
SEQ_DEPENDENT_ROPE_TYPES = ("dynamic", "longrope")


def freeze_rope_scaling(scaling: Optional[dict]) -> Optional[tuple]:
    """HF ``rope_scaling`` dict -> hashable sorted item tuple (list values
    tupled), so it can live on the frozen model configs."""
    if scaling is None or isinstance(scaling, tuple):
        return scaling

    def _freeze(v):
        return tuple(v) if isinstance(v, (list, tuple)) else v

    return tuple(sorted((k, _freeze(v)) for k, v in scaling.items()))


def _scaling_dict(scaling) -> dict:
    return scaling if isinstance(scaling, dict) else dict(scaling)


def rope_type_of(scaling) -> str:
    if not scaling:
        return "default"
    s = _scaling_dict(scaling)
    return s.get("rope_type") or s.get("type") or "default"


def _even_exponent(head_dim: int, device) -> torch.Tensor:
    return (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
            / head_dim)


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32."""
    return 1.0 / (theta ** _even_exponent(head_dim, device))


def _llama3_frequencies(inv_freq: torch.Tensor, s: dict) -> torch.Tensor:
    """Llama-3.1 band-wise rescale (HF ``_compute_llama3_parameters``)."""
    factor = s["factor"]
    low_freq_factor = s.get("low_freq_factor", 1.0)
    high_freq_factor = s.get("high_freq_factor", 4.0)
    old_context = s["original_max_position_embeddings"]

    low_freq_wavelen = old_context / low_freq_factor
    high_freq_wavelen = old_context / high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    scaled = torch.where(wavelen > low_freq_wavelen, inv_freq / factor,
                         inv_freq)
    smooth = ((old_context / wavelen - low_freq_factor)
              / (high_freq_factor - low_freq_factor))
    smoothed = (1 - smooth) * scaled / factor + smooth * scaled
    is_medium = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return torch.where(is_medium, smoothed, scaled)


def _yarn_frequencies(head_dim: int, theta: float, s: dict,
                      max_position: int, device) -> tuple:
    """YaRN ramp between correction dims plus the sqrt-log attention
    temperature (HF ``_compute_yarn_parameters``)."""
    factor = s["factor"]
    original_max = s.get("original_max_position_embeddings") or max_position

    def get_mscale(scale, mscale=1.0):
        if scale <= 1:
            return 1.0
        return 0.1 * mscale * math.log(scale) + 1.0

    attention_factor = s.get("attention_factor")
    if attention_factor is None:
        mscale, mscale_all = s.get("mscale"), s.get("mscale_all_dim")
        if mscale and mscale_all:
            attention_factor = get_mscale(factor, mscale) / get_mscale(
                factor, mscale_all)
        else:
            attention_factor = get_mscale(factor)

    beta_fast = s.get("beta_fast") or 32
    beta_slow = s.get("beta_slow") or 1

    def correction_dim(num_rotations):
        return (head_dim * math.log(original_max / (num_rotations * 2 * math.pi))
                ) / (2 * math.log(theta))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if s.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, head_dim - 1)
    if low == high:
        high += 0.001

    pos_freqs = theta ** _even_exponent(head_dim, device)
    extrapolation = 1.0 / pos_freqs
    interpolation = 1.0 / (factor * pos_freqs)
    ramp = torch.clip(
        (torch.arange(head_dim // 2, dtype=torch.float32, device=device)
         - low) / (high - low), 0, 1)
    extrapolation_factor = 1 - ramp
    inv_freq = (interpolation * (1 - extrapolation_factor)
                + extrapolation * extrapolation_factor)
    return inv_freq, float(attention_factor)


def _longrope_frequencies(head_dim: int, theta: float, s: dict,
                          max_position: int, seq_len, device) -> tuple:
    """Phi-3 longrope: the short factor set within the original context,
    the long set beyond it (HF ``_compute_longrope_parameters``)."""
    short = torch.as_tensor(s["short_factor"], dtype=torch.float32,
                            device=device)
    long = torch.as_tensor(s["long_factor"], dtype=torch.float32,
                           device=device)
    original_max = s.get("original_max_position_embeddings")
    if original_max:
        factor = max_position / original_max
    else:
        original_max = max_position
        factor = s.get("factor") or 1.0

    attention_factor = s.get("attention_factor")
    if attention_factor is None:
        if factor <= 1.0:
            attention_factor = 1.0
        else:
            attention_factor = math.sqrt(
                1 + math.log(factor) / math.log(original_max))

    base = theta ** _even_exponent(head_dim, device)
    ext = torch.where(torch.as_tensor(seq_len, device=device) > original_max,
                      long, short)
    return 1.0 / (ext * base), float(attention_factor)


def scaled_rope_frequencies(head_dim: int, theta: float, scaling: Any = None,
                            max_position: Optional[int] = None, seq_len=None,
                            device=None) -> tuple:
    """(inv_freq [head_dim // 2], attention_factor) for any HF rope type;
    ``seq_len`` is required by the seq-dependent types."""
    rope_type = rope_type_of(scaling)
    if rope_type == "default":
        return rope_frequencies(head_dim, theta, device), 1.0
    s = _scaling_dict(scaling)
    if rope_type == "linear":
        return rope_frequencies(head_dim, theta, device) / s["factor"], 1.0
    if rope_type == "llama3":
        return _llama3_frequencies(rope_frequencies(head_dim, theta, device),
                                   s), 1.0
    if rope_type == "yarn":
        return _yarn_frequencies(head_dim, theta, s, max_position, device)
    if rope_type == "dynamic":
        factor = s["factor"]
        if seq_len is None:
            seq_len = max_position
        seq_len = torch.clamp(torch.as_tensor(seq_len, dtype=torch.float32,
                                              device=device),
                              min=float(max_position))
        base = theta * ((factor * seq_len / max_position) - (factor - 1)) ** (
            head_dim / (head_dim - 2))
        return 1.0 / (base ** _even_exponent(head_dim, device)), 1.0
    if rope_type == "longrope":
        if seq_len is None:
            seq_len = max_position
        return _longrope_frequencies(head_dim, theta, s, max_position,
                                     seq_len, device)
    raise ValueError(
        f"unsupported rope_scaling type {rope_type!r} (supported: {ROPE_TYPES})")


def rope_tables(head_dim: int, positions: torch.Tensor,
                theta: float = 10000.0, scaling: Any = None,
                max_position: Optional[int] = None,
                seq_len: Optional[int] = None) -> tuple:
    """(cos, sin), each [..., seq, 1, head_dim // 2] fp32, for ``positions``
    [..., seq] (int): the angles ``rotate`` turns by. A forward computes
    them once and every layer's q and k reuse them. ``scaling`` /
    ``max_position`` select an HF rope_scaling type (None = plain RoPE).
    ``seq_len``: the sequence length a sequence-dependent type (dynamic
    NTK, longrope) reads, where ``positions`` are one shard of a longer
    sequence (context parallelism); default ``max(positions) + 1``."""
    if scaling is None:
        inv_freq, attn_factor = rope_frequencies(head_dim, theta,
                                                 positions.device), 1.0
    else:
        if rope_type_of(scaling) not in SEQ_DEPENDENT_ROPE_TYPES:
            seq_len = None
        elif seq_len is None:
            seq_len = positions.max() + 1
        inv_freq, attn_factor = scaled_rope_frequencies(
            head_dim, theta, scaling, max_position, seq_len, positions.device)
    angles = positions[..., None].to(torch.float32) * inv_freq
    cos = torch.cos(angles)[..., None, :] * attn_factor
    sin = torch.sin(angles)[..., None, :] * attn_factor
    return cos, sin


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., seq, heads, head_dim] by ``rope_tables``' angles,
    in float32, returned in ``x.dtype``."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, scaling: Any = None,
               max_position: Optional[int] = None) -> torch.Tensor:
    """Rotate ``x`` [..., seq, heads, head_dim] by position-dependent angles;
    ``positions`` is [..., seq] (int). Computed in float32, returned in
    ``x.dtype`` (the JAX package's ``apply_rope``)."""
    return rotate(x, *rope_tables(x.shape[-1], positions, theta, scaling,
                                  max_position))
