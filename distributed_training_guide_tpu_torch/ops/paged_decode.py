"""Paged flash attention over block tables: one kernel for every paged
forward of the serve plane, at query tile T (decode T = 1, chunked
prefill T = chunk, speculative verify T = k + 1).

Counterpart of ``distributed_training_guide_tpu/ops/paged_decode.py``,
whose Pallas ``_attend_kernel`` is rewritten here in CUDA for ``sm_90a``
(``csrc/paged_attend.cu``; design and bound in its header). The kernel
reads k/v THROUGH the block table: per forward it reads the live pages
once and writes only the [S, T, Hq, D] output, where the plain version
(``paged_attend_reference``) gathers each slot's table into a contiguous
[S, M * page, Hkv, D] view first.

``paged_flash_attend`` launches the kernel for CUDA tensors (or raises)
and runs ``paged_attend_reference`` for CPU tensors: that is the one
reason it ever takes the plain version. ``LAUNCHES`` counts kernel
launches, so a run can show that its forwards went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .attention import NO_WINDOW, check_static_window, multihead_attention

LAUNCHES = 0           # kernel launches since the caller last reset it
NEG_INF = -1e30        # the kernel's mask constant (the plain path uses
                       # finfo(float32).min, as the JAX package does)
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_fn = None


def paged_decode_eligible(head_dim: int, page_size: int,
                          quantized: bool = False) -> bool:
    """Shapes the CUDA kernel takes: head_dim 64, 128 or 256 and a page
    of 8 to 64 positions in steps of 8, for float and int8 pools alike."""
    del quantized
    return (head_dim in HEAD_DIMS and 8 <= page_size <= 64
            and page_size % 8 == 0)


def paged_attend_reference(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           window=None, scale: Optional[float] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """The plain version: gather each slot's block table into a
    [S, M * page, Hkv, D] view (dequantizing an int8 pool to q's dtype)
    and attend with ``_xla_attention`` at positions ``lengths + t``. The
    JAX package's gather path, ``serve/kv_pages.py:paged_attend``. Like
    that path, a row with no key in its band (possible only for a row
    past the table's capacity under a window) softmaxes uniformly, where
    the kernel returns 0."""
    squeeze = q.ndim == 3
    if squeeze:
        q = q[:, None]
    s, t = q.shape[0], q.shape[1]
    m = tables.shape[1]
    page = k_pages.shape[1]
    idx = tables.long()
    kg, vg = k_pages[idx], v_pages[idx]              # [S, M, page, Hkv, D]
    if k_scale is not None:
        kg = (kg.float() * k_scale[idx][..., None]).to(q.dtype)
        vg = (vg.float() * v_scale[idx][..., None]).to(q.dtype)
    kg = kg.reshape(s, m * page, *kg.shape[3:])
    vg = vg.reshape(s, m * page, *vg.shape[3:])
    positions = (lengths.long()[:, None]
                 + torch.arange(t, device=q.device)[None, :])
    kv_pos = torch.arange(m * page, device=q.device)[None, :].expand(s, -1)
    out = multihead_attention(q, kg, vg, causal=True, positions=positions,
                              kv_positions=kv_pos, impl="xla",
                              standard_layout=False, window=window,
                              scale=scale, logit_softcap=softcap)
    return out[:, 0] if squeeze else out


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("paged_attend").paged_attend
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * 8 + [i32] * 11
                       + [ctypes.c_float, ctypes.c_float, ptr])
        fn.restype = i32
        _fn = fn
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_flash_attend: {msg}")


def paged_flash_attend(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor, *,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       window=None, scale: Optional[float] = None,
                       softcap: Optional[float] = None) -> torch.Tensor:
    """Flash attention through the block table at query tile T.

    q [S, T, Hq, D] (rank 3 [S, Hq, D] is the T == 1 form), fp32 or bf16;
    k_pages / v_pages [P, page, Hkv, D] of ONE layer, fp32, bf16 or int8
    with ``k_scale`` / ``v_scale`` [P, page, Hkv] fp32; tables [S, M]
    int32 physical page ids (0 = the trash page); lengths [S] int32, the
    position of each slot's first query token. The caller has already
    scattered the T new tokens' k/v into the pages. Returns the attention
    in q's shape and dtype.
    """
    global LAUNCHES
    check_static_window(window)
    quantized = k_scale is not None or v_scale is not None
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("pass both k_scale and v_scale (or neither) — a "
                         "half-quantized pool cannot exist")
    if q.device.type == "cpu":
        return paged_attend_reference(
            q, k_pages, v_pages, tables, lengths, k_scale=k_scale,
            v_scale=v_scale, window=window, scale=scale, softcap=softcap)
    squeeze = q.ndim == 3
    if squeeze:
        q = q[:, None]
    _check(q.is_cuda, f"q lies on {q.device}, not a CUDA device")
    s, t, hq, d = q.shape
    p, page, hkv, d_kv = k_pages.shape
    m = tables.shape[1] if tables.ndim == 2 else -1
    operands = [q, k_pages, v_pages, tables, lengths]
    if quantized:
        operands += [k_scale, v_scale]
    for x in operands:
        _check(x.device == q.device, f"operand on {x.device}, q on "
               f"{q.device}")
        _check(x.is_contiguous(), "operands must be contiguous")
    _check(q.dtype in (torch.float32, torch.bfloat16),
           f"q dtype {q.dtype} (fp32 or bf16)")
    _check(k_pages.dtype == v_pages.dtype, "k and v pools differ in dtype")
    _check(k_pages.dtype in _DTYPE_CODE, f"pool dtype {k_pages.dtype}")
    _check((k_pages.dtype == torch.int8) == quantized,
           "int8 pools need k_scale/v_scale, float pools take none")
    _check(tuple(v_pages.shape) == tuple(k_pages.shape),
           "k and v pools differ in shape")
    _check(d_kv == d and d in HEAD_DIMS, f"head_dim {d} (pool {d_kv}); the "
           f"kernel takes {HEAD_DIMS}")
    _check(paged_decode_eligible(d, page), f"page size {page} (8..64, a "
           f"multiple of 8)")
    _check(hkv >= 1 and hq % hkv == 0, f"query heads ({hq}) must be a "
           f"positive multiple of kv heads ({hkv})")
    _check(tables.dtype == torch.int32 and m >= 1 and tables.shape[0] == s,
           f"tables must be int32 [S={s}, M], got {tables.dtype} "
           f"{tuple(tables.shape)}")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (s,),
           f"lengths must be int32 [S={s}], got {lengths.dtype} "
           f"{tuple(lengths.shape)}")
    if quantized:
        for sc in (k_scale, v_scale):
            _check(sc.dtype == torch.float32
                   and tuple(sc.shape) == (p, page, hkv),
                   f"scales must be fp32 [P, page, Hkv], got {sc.dtype} "
                   f"{tuple(sc.shape)}")
    win = NO_WINDOW if window is None else int(window)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        s, t, hq, hkv, d, p, page, m, _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k_pages.dtype], win, float(scale),
        float(softcap) if softcap else 0.0, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attend kernel launch failed (code {rc}) "
                           f"at q {tuple(q.shape)} {q.dtype}, pools "
                           f"{tuple(k_pages.shape)} {k_pages.dtype}")
    LAUNCHES += 1
    return out[:, 0] if squeeze else out

