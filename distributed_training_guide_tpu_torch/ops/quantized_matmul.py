"""Block-dequant matmul for int8 serve weights.

Counterpart of ``distributed_training_guide_tpu/ops/quantized_matmul.py``.
The serve engine stores its projection weights as ``train/precision.py``
``Quantized`` containers (int8 payload ``q`` plus one fp32 absmax scale
per block of the trailing axis, ``serve/weights.py``), and this module is
where they are dequantized: inside the product, so the whole fp32 weight
never exists.

Two contraction forms:

- **standard** (``x [.., K] @ w [K, N]``, blocks tile N):
  ``out[m, n] = sum_k x[m, k] * (q[k, n] * scale[k, n // bs])`` in fp32.
  The JAX package's Pallas ``_dequant_matmul_kernel`` (K7) is rewritten
  here in CUDA for ``sm_90a`` (``csrc/quantized_matmul.cu``; design and
  bound in its header) as two bodies: a tensor-core body for bf16 x
  (each weight w = q * scale formed in fp32, split into bf16 hi and lo,
  two wgmma products) and an FMA body for fp32 x and operands no tensor
  map reads. ``_qmm_plan`` names the body from the operands' dtypes and
  16-byte alignment alone and is held against the library's own table
  when it loads. ``dequant_matmul`` launches the kernel for CUDA tensors,
  or raises, and runs ``quantized_matmul_reference`` (the JAX
  ``_matmul_xla``) for CPU tensors, which is the one reason it ever takes
  the plain version; ``split_w=True`` is the plain version of the
  tensor-core body's arithmetic. ``LAUNCHES`` counts kernel launches,
  ``BODY_LAUNCHES`` them by body.
- **transpose** (``x [.., E] @ w [V, E].T``, blocks tile E, the tied
  output head): the scale factors out of each block's partial product.
  The JAX package has no kernel for it either; ``quantized_matmul_t``
  (the JAX ``_matmul_t_xla``) carries it on every device.

``impl``: "auto" or the JAX name "pallas" takes the kernel for CUDA
tensors in the standard form; "xla" takes the plain forms on any device.

Dispatch differs from the JAX package's on purpose:
``quantized_matmul_eligible`` answers for the Hopper kernel, which takes
every linear-domain 2-D standard-form container (any block size, a short
last block, any K and M). The JAX function answers for the TPU's int8
tile floor (``bs % 128 == 0``, ``K % 32 == 0``, no short last block), so
on a TPU the engine's own bs = 32 weights never reach the Pallas kernel;
here every standard-form product of the engine runs K7. What is computed
is the same either way.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._device import runs_plain
from . import _build
from .matmul import split_bf16

LAUNCHES = 0            # kernel launches since the caller last reset it
BODY_LAUNCHES = {"fma": 0, "wgmma": 0}   # ... by body
IMPLS = ("auto", "xla", "pallas")
# fp32 elements of one dequantized group of column blocks in the plain
# standard form (64 MiB): bounded, and never the whole weight
GROUP_ELEMS = 1 << 24
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BODIES = ("fma", "wgmma")   # the codes of qmm_body
_fns: dict = {}
_split_cache: dict = {}


def _geometry(q: torch.Tensor, scale: torch.Tensor) -> tuple:
    """(nblocks, block_size) from the container shapes — the recovery
    rule of ``train/precision.py``'s ``block_geometry``."""
    d, nb = q.shape[-1], scale.shape[-1]
    return nb, -(-d // nb)


def _check(w) -> tuple:
    q, scale = w.q, w.scale
    if getattr(w, "sqrt_domain", False):
        raise ValueError("quantized_matmul expects linear-domain weights; "
                         "sqrt_domain containers are an optimizer-moment "
                         "encoding (train/precision.py)")
    if q.ndim != 2:
        raise ValueError(f"quantized_matmul takes a 2-D weight, got "
                         f"q.shape={tuple(q.shape)} (slice the stacked "
                         f"layer axis before calling)")
    return q, scale


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def quantized_matmul_reference(x2d: torch.Tensor, q: torch.Tensor,
                               scale: torch.Tensor,
                               split_w: bool = False) -> torch.Tensor:
    """The plain standard form, the JAX ``_matmul_xla``: [M, K] @
    dequant([K, N]) -> [M, N] fp32. Dequantizes a bounded group of whole
    column blocks at a time (at most half the blocks, and at most
    ``GROUP_ELEMS`` fp32 values) before its fp32 product. ``split_w``: each
    dequantized weight replaced by its bf16 hi + lo split
    (``split_bf16``), the arithmetic of the tensor-core body."""
    k, n = q.shape
    nb, bs = _geometry(q, scale)
    group = max(1, min(-(-nb // 2), GROUP_ELEMS // max(k * bs, 1)))
    xf = x2d.to(torch.float32)
    out = torch.empty(x2d.shape[0], n, dtype=torch.float32, device=x2d.device)
    for b0 in range(0, nb, group):
        b1 = min(b0 + group, nb)
        c0, c1 = b0 * bs, min(b1 * bs, n)
        s = torch.repeat_interleave(scale[:, b0:b1], bs, dim=1)[:, :c1 - c0]
        w = q[:, c0:c1].to(torch.float32) * s
        out[:, c0:c1] = xf @ (split_bf16(w) if split_w else w)
    return out


def quantized_matmul_t(x2d: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """The plain transpose form, the JAX ``_matmul_t_xla``: [M, E] @
    dequant([V, E]).T -> [M, V] fp32, one block of the contracted axis at
    a time with its scale factored out of the block's partial product."""
    v, e = q.shape
    nb, bs = _geometry(q, scale)
    xf = x2d.to(torch.float32)
    acc = torch.zeros(x2d.shape[0], v, dtype=torch.float32, device=x2d.device)
    for b in range(nb):
        c0, c1 = b * bs, min((b + 1) * bs, e)
        acc = acc + (xf[:, c0:c1] @ q[:, c0:c1].to(torch.float32).T
                     ) * scale[:, b][None, :]
    return acc


def quantized_take(w, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup against a quantized table: gather the int8 rows
    and their scale rows, dequantize only the gathered tokens (fp32)."""
    q, scale = _check(w)
    _, bs = _geometry(q, scale)
    ids = ids.long()
    rows = q[ids].to(torch.float32)                            # [.., d]
    srows = torch.repeat_interleave(scale[ids], bs, dim=-1)[..., :q.shape[-1]]
    return rows * srows


def quantized_matmul_eligible(w, *, transpose: bool = False) -> bool:
    """True when the Hopper kernel (K7) takes this container: every
    linear-domain 2-D standard-form container, whatever its block size or
    short last block. False for the transpose form, which has no kernel.
    The JAX function of the same name answers for the TPU's int8 tile
    floor instead (see the module docstring)."""
    try:
        _check(w)
    except ValueError:
        return False
    return not transpose


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _kernel(name: str):
    """The ctypes function ``qmm`` or ``qmm_splits``, built on first use;
    the library's body table is held against ``_qmm_plan`` as it
    loads."""
    fn = _fns.get(name)
    if fn is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib = _build.load("quantized_matmul")
        _check_body_table(lib)
        fn = getattr(lib, name)
        fn.argtypes = ([ptr] * 5 + [i32] * 7 + [ptr] if name == "qmm"
                       else [i32, i32, i32])
        fn.restype = i32
        _fns[name] = fn
    return fn


def _qmm_plan(x2d: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> str:
    """K7's body for these (contiguous) operands, from their dtypes and
    16-byte alignment alone: "wgmma" (the tensor-core body: bf16 x, and
    every base and every row of x, q and scale on 16 bytes, so that tensor
    maps read them) or "fma" (anything else: fp32 x, N % 16 != 0, ...).
    ``_check_body_table`` holds it against the library's ``qmm_body``."""
    on_16 = all(t.data_ptr() % 16 == 0 for t in (x2d, q, scale))
    rows = (x2d.stride(0) * 2 % 16 == 0 and q.stride(0) % 16 == 0
            and scale.stride(0) * 4 % 16 == 0)
    return ("wgmma" if x2d.dtype == torch.bfloat16 and on_16 and rows
            else "fma")


def _plan_cases() -> list:
    """(x, q, scale) triples on the CPU that take every branch of the
    plan: each x dtype, each base on and off 16 bytes, each row length on
    and off 16 bytes."""
    bf, i8, f32 = torch.bfloat16, torch.int8, torch.float32

    def at(n, dtype, off, shape):
        return torch.zeros(n + off, dtype=dtype)[off:].view(*shape)

    x, q, s = at(512, bf, 0, (8, 64)), at(8192, i8, 0, (64, 128)), \
        at(256, f32, 0, (64, 4))
    return [(x, q, s), (x.float(), q, s),
            (at(512, bf, 8, (8, 64)), q, s), (at(512, bf, 1, (8, 64)), q, s),
            (at(800, bf, 0, (8, 100)), at(12800, i8, 0, (100, 128)),
             at(400, f32, 0, (100, 4))),
            (x, at(8192, i8, 16, (64, 128)), s),
            (x, at(8192, i8, 1, (64, 128)), s),
            (x, at(4608, i8, 0, (64, 72)), s),
            (x, q, at(256, f32, 4, (64, 4))), (x, q, at(256, f32, 1, (64, 4))),
            (x, q, at(128, f32, 0, (64, 2)))]


def _check_body_table(lib) -> None:
    """Raises unless the library's ``qmm_body`` picks, for every case of
    ``_plan_cases``, the body that ``_qmm_plan`` names."""
    body = lib.qmm_body
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    body.argtypes = [i32, ptr, i32, ptr, i32, ptr, i32]
    body.restype = i32
    for x, q, scale in _plan_cases():
        got = body(_DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0),
                   q.data_ptr(), q.stride(0), scale.data_ptr(),
                   scale.stride(0))
        got = _BODIES[got] if 0 <= got < len(_BODIES) else got
        if got != _qmm_plan(x, q, scale):
            raise RuntimeError(
                f"quantized_matmul.cu runs body {got} at x {x.dtype} "
                f"{tuple(x.shape)}, q {tuple(q.shape)}, scale "
                f"{tuple(scale.shape)}; _qmm_plan names "
                f"{_qmm_plan(x, q, scale)}")


def kernel_splits(k: int, n: int, body: str) -> int:
    """How many blocks share one output tile's sum over K in the kernel's
    ``body``: a function of (K, N) and the body alone, so no output's order
    of summation depends on M."""
    key = (k, n, body)
    g = _split_cache.get(key)
    if g is None:
        g = _split_cache[key] = int(_kernel("qmm_splits")(
            k, n, _BODIES.index(body)))
    return g


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"dequant_matmul: {msg}")


def _launch(x2d, q, scale, out_dtype) -> torch.Tensor:
    """One launch of K7; the body that ran (``_qmm_plan``) is counted in
    ``BODY_LAUNCHES``."""
    m, k = x2d.shape
    n = q.shape[1]
    nb, bs = _geometry(q, scale)
    plan = _qmm_plan(x2d, q, scale)
    out = torch.empty(m, n, dtype=out_dtype, device=x2d.device)
    g = kernel_splits(k, n, plan)
    ws = (torch.empty(g, m, n, dtype=torch.float32, device=x2d.device)
          if g > 1 and m * n else out)
    rc = _kernel("qmm")(
        x2d.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        ws.data_ptr(), m, k, n, nb, bs, _DTYPE_CODE[x2d.dtype],
        _DTYPE_CODE[out_dtype], torch.cuda.current_stream(x2d.device)
        .cuda_stream)
    if rc != 0:
        why = ": the driver refused a tensor map" if rc == -2 else ""
        raise RuntimeError(f"qmm kernel launch failed (code {rc}{why}) at x "
                           f"{tuple(x2d.shape)} {x2d.dtype}, q "
                           f"{tuple(q.shape)}, {nb} blocks of {bs}, body "
                           f"{plan}")
    BODY_LAUNCHES[plan] += 1
    return out


def dequant_matmul(x2d: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   out_dtype=torch.float32) -> torch.Tensor:
    """K7: ``x2d [M, K] @ dequant(q [K, N], scale [K, nb])`` summed in
    fp32, rounded once to ``out_dtype`` (fp32 or bf16). CPU tensors take
    ``quantized_matmul_reference``; CUDA tensors launch the kernel."""
    global LAUNCHES
    if runs_plain(x2d):
        return quantized_matmul_reference(x2d, q, scale).to(out_dtype)
    _require(x2d.is_cuda, f"x lies on {x2d.device}, not a CUDA device")
    for t in (q, scale):
        _require(t.device == x2d.device, f"operand on {t.device}, x on "
                 f"{x2d.device}")
    _require(x2d.dtype in _DTYPE_CODE, f"x dtype {x2d.dtype} (fp32 or "
             f"bf16)")
    _require(out_dtype in _DTYPE_CODE, f"output dtype {out_dtype} (fp32 "
             f"or bf16)")
    _require(q.dtype == torch.int8 and scale.dtype == torch.float32,
             f"q must be int8 and scale fp32, got {q.dtype} / {scale.dtype}")
    _require(x2d.ndim == 2 and q.ndim == 2 and scale.ndim == 2
             and x2d.shape[1] == q.shape[0] == scale.shape[0],
             f"shapes x {tuple(x2d.shape)}, q {tuple(q.shape)}, scale "
             f"{tuple(scale.shape)}")
    out = _launch(x2d.contiguous(), q.contiguous(), scale.contiguous(),
                  out_dtype)
    LAUNCHES += 1
    return out


def quantized_matmul(x: torch.Tensor, w, *, transpose: bool = False,
                     impl: str = "auto",
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ dequant(w)`` (or ``x @ dequant(w).T`` with ``transpose``),
    dequantizing inside the product; fp32 by default, or rounded once to
    ``out_dtype`` (what the JAX ``_wmat``'s ``.astype(cdt)`` does to the
    fp32 result). ``w`` is any Quantized-like container with ``.q`` and
    ``.scale``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be auto|xla|pallas, got {impl!r}")
    q, scale = _check(w)
    lead, kdim = x.shape[:-1], x.shape[-1]
    contract = q.shape[-1] if transpose else q.shape[0]
    if kdim != contract:
        raise ValueError(f"contraction mismatch: x[.., {kdim}] vs "
                         f"quantized weight {tuple(q.shape)}"
                         f"{'.T' if transpose else ''}")
    out_dtype = out_dtype or torch.float32
    x2d = x.reshape(-1, kdim)
    if transpose:
        if impl == "pallas":
            raise NotImplementedError("pallas quantized_matmul has no "
                                      "transpose (tied lm_head) form; use "
                                      "impl='xla'")
        out = quantized_matmul_t(x2d, q, scale).to(out_dtype)
    elif impl == "xla":
        out = quantized_matmul_reference(x2d, q, scale).to(out_dtype)
    else:
        out = dequant_matmul(x2d, q, scale, out_dtype)
    return out.reshape(*lead, out.shape[-1])
