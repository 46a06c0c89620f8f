"""Grouped (ragged) matmul: the expert-compute primitive of dropless MoE.

Counterpart of ``distributed_training_guide_tpu/ops/grouped_matmul.py``.
``grouped_matmul(lhs [M, K], rhs [G, K, N], group_sizes [G]) -> [M, N]``
multiplies row block ``g`` of ``lhs`` (rows ``offs[g]:offs[g+1]``, where
``offs = cumsum(group_sizes)``) by ``rhs[g]``, summing in fp32. Rows at or
past ``sum(group_sizes)`` come out 0 and get a zero gradient; an empty
group gets a zero ``rhs`` gradient.

The JAX package's two Pallas kernels are rewritten here in CUDA for
``sm_90a`` (``csrc/grouped_matmul.cu``; design and bound in its header):
``_gmm_kernel`` (K5) as ``gmm`` and ``_tgmm_kernel`` (K6) as ``tgmm``. The
TPU's (group, row tile) work list, which exists because its grid runs in
order, has no counterpart: every CUDA block finds its groups itself. Each
wrapper launches its kernel for CUDA tensors, or raises, and runs its plain
version (``gmm_reference``, the JAX ``_gmm_scan``; ``tgmm_reference``) for
CPU tensors, which is the one reason it ever takes it. ``GMM_LAUNCHES`` and
``TGMM_LAUNCHES`` count launches, ``GMM_BODY_LAUNCHES`` and
``TGMM_BODY_LAUNCHES`` the launches by body. ``_gmm_plan`` and
``_tgmm_plan`` name each kernel's body from the operands' dtypes, strides
and alignment alone, and ``tile_schedule`` is the tile grid that K5's
Hopper bodies' blocks compute for themselves. The backward's two fp32-dy
products run split bodies on the tensor cores: dy split into bf16 hi and
lo, two products, each 64-deep chunk's sum added to an fp32 register sum.
K5's d_lhs (fp32 dy against the bf16 ``rhs^T``) has
``gmm_reference(split_lhs=True)`` as the plain version of that
arithmetic; K6's d_rhs (the bf16 lhs against fp32 dy, summed over
64-row chunks counted from each group's first row, so that a group's
result is bitwise the same whatever the other groups hold) has
``tgmm_reference(split_dy=True)``.

``impl``: "auto" (or the JAX name "pallas") is the autograd Function over
the two wrappers, whose backward does what the JAX custom_vjp does, in
fp32: ``d_lhs = gmm(dy, rhs^T)`` and ``d_rhs = tgmm(lhs, dy)``. "scan" and
"einsum" are the JAX package's plain formulations, differentiated by torch
autograd. "ragged" (``jax.lax.ragged_dot``, an XLA op) has no
counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from .._device import runs_plain
from . import _build
from .matmul import matmul_f32_out, split_bf16

GMM_LAUNCHES = 0    # K5 launches since the caller last reset it
GMM_BODY_LAUNCHES = {"fma": 0, "wmma": 0, "wgmma": 0, "split": 0}  # by body
TGMM_LAUNCHES = 0   # K6
TGMM_BODY_LAUNCHES = {"fma": 0, "split": 0}   # K6's launches by body
MAX_GROUPS = 1024   # the kernels' shared-memory offset table
SMALL_M = 256       # the Hopper body takes 64-row tiles up to this M, else 128
IMPLS = ("auto", "pallas", "scan", "einsum")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BODIES = ("fma", "wmma", "wgmma", "split")   # the codes of gmm_body
_TGMM_BODIES = ("fma", "split")                # the codes of tgmm_body
_fns: dict = {}


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result from the fp32 accumulator (the JAX
    ``preferred_element_type=float32``)."""
    if a.dtype == b.dtype:
        return matmul_f32_out(a, b)
    return a.float() @ b.float()


def _row_masks(group_sizes: torch.Tensor, m: int):
    """(rows [M], starts [G], ends [G]) on the device, no host read."""
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    rows = torch.arange(m, device=group_sizes.device)
    return rows, ends - group_sizes.to(torch.int64), ends


def gmm_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                  group_sizes: torch.Tensor, out_dtype,
                  split_lhs: bool = False) -> torch.Tensor:
    """The plain version of K5, the JAX ``_gmm_scan``: for each group, mask
    the rows to its range, one dense product with the fp32 accumulator,
    accumulate. O(G) more operations than the kernel, O(M (K + N))
    memory. ``split_lhs``: fp32 lhs replaced by its bf16 hi + lo split
    (``split_bf16``), the arithmetic of the split body."""
    if split_lhs:
        lhs = split_bf16(lhs.float())
    rows, starts, ends = _row_masks(group_sizes, lhs.shape[0])
    acc = torch.zeros(lhs.shape[0], rhs.shape[2], dtype=torch.float32,
                      device=lhs.device)
    for g in range(rhs.shape[0]):
        mask = (rows >= starts[g]) & (rows < ends[g])
        acc = acc + _mm_f32(torch.where(mask[:, None], lhs, 0), rhs[g])
    return acc.to(out_dtype)


def tgmm_reference(lhs: torch.Tensor, dy: torch.Tensor,
                   group_sizes: torch.Tensor, num_groups: int,
                   out_dtype, split_dy: bool = False) -> torch.Tensor:
    """The plain version of K6: ``d_rhs[g] = lhs_g^T @ dy_g`` per group
    through a row mask on both operands (rows outside the group contribute
    nothing, whatever they hold), fp32 sums -> [G, K, N] in ``out_dtype``.
    ``split_dy``: fp32 dy replaced by its bf16 hi + lo split
    (``split_bf16``), the arithmetic of the split body."""
    if split_dy:
        dy = split_bf16(dy.float())
    rows, starts, ends = _row_masks(group_sizes, lhs.shape[0])
    out = torch.empty(num_groups, lhs.shape[1], dy.shape[1],
                      dtype=out_dtype, device=lhs.device)
    for g in range(num_groups):
        mask = ((rows >= starts[g]) & (rows < ends[g]))[:, None]
        out[g] = _mm_f32(torch.where(mask, lhs, 0).T,
                         torch.where(mask, dy, 0)).to(out_dtype)
    return out


def _segments(group_sizes: torch.Tensor, m: int, g: int) -> torch.Tensor:
    """[M, G] one-hot of each row's group; tail rows get an all-zero row."""
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    seg = torch.searchsorted(ends, torch.arange(m, device=ends.device),
                             right=True)
    return torch.nn.functional.one_hot(seg, g + 1)[:, :g]


def gmm_einsum(lhs, rhs, group_sizes, out_dtype) -> torch.Tensor:
    """The JAX ``_gmm_einsum``: segment one-hot masked einsum, O(G) more
    operations than ideal, in fp32."""
    onehot = _segments(group_sizes, lhs.shape[0], rhs.shape[0]).float()
    return torch.einsum("mk,mg,gkn->mn", lhs.float(), onehot,
                        rhs.float()).to(out_dtype)


def tgmm_einsum(lhs, dy, group_sizes, num_groups, out_dtype) -> torch.Tensor:
    """The JAX ``_tgmm_einsum``: ``d_rhs[g] = lhs_g^T @ dy_g`` ->
    [G, K, N] through the one-hot, in fp32."""
    onehot = _segments(group_sizes, lhs.shape[0], num_groups).float()
    return torch.einsum("mg,mk,mn->gkn", onehot, lhs.float(),
                        dy.float()).to(out_dtype)


def tile_block_rows(m: int) -> int:
    """The Hopper body's rows per tile at ``m`` rows: 64 (decode) or 128."""
    return 64 if m <= SMALL_M else 128


def tile_schedule(group_sizes, m: int, bm: int) -> list:
    """The row tiles of the Hopper body's static grid, in slot order, as
    its blocks compute them from ``group_sizes`` (host ints; negative sizes
    count as 0) alone: (group, first row, rows) for each group's rows
    (clipped to ``m``) in tiles of ``bm`` starting at the group's first
    row, then (-1, first row, rows) for the rows from the total up, which
    the kernel writes as zeros. The grid has ``ceil(m / bm) + G`` row slots
    per column tile; the slots past this list do nothing."""
    offs = [0]
    for size in group_sizes:
        offs.append(offs[-1] + max(int(size), 0))
    tiles = []
    for g in range(len(group_sizes)):
        lo, hi = min(offs[g], m), min(offs[g + 1], m)
        tiles += [(g, r, min(bm, hi - r)) for r in range(lo, hi, bm)]
    total = min(offs[-1], m)
    tiles += [(-1, r, min(bm, m - r)) for r in range(total, m, bm)]
    return tiles


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _kernel(name: str):
    """The ctypes function of ``gmm`` or ``tgmm``, built on first use; the
    library's body tables are held against ``_gmm_plan`` and
    ``_tgmm_plan`` as it loads."""
    fn = _fns.get(name)
    if fn is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib = _build.load("grouped_matmul")
        _check_body_table(lib)
        fn = getattr(lib, name)
        if name == "gmm":
            fn.argtypes = [ptr] * 4 + [i32] * 4 + [i64, ptr] + [i32] * 3 + [ptr]
        else:
            fn.argtypes = [ptr] * 4 + [i32] * 4 + [i64] * 2 + [i32] * 3 + [ptr]
        fn.restype = i32
        _fns[name] = fn
    return fn


def _gmm_plan(lhs: torch.Tensor, rhs: torch.Tensor) -> str:
    """K5's body for these operands, from their dtypes, strides and
    16-byte alignment alone: "wgmma" (the Hopper body: bf16 lhs and rhs
    that tensor maps can read, i.e. rhs N-contiguous and both bases and
    every other stride on 16 bytes), "wmma" (other bf16 lhs and rhs: a
    transposed rhs, rows off 16 bytes), "split" (fp32 lhs against a bf16
    rhs that the split body's tensor maps read: rhs K-contiguous, as the
    backward's rhs^T is, and both bases and every other stride on 16
    bytes) or "fma" (anything else). ``_check_body_table`` holds it
    against the library's ``gmm_body``."""
    bases = lhs.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0
    if lhs.dtype == torch.float32 and rhs.dtype == torch.bfloat16:
        on_16 = bases and lhs.stride(0) * 4 % 16 == 0 and all(
            x * 2 % 16 == 0 for x in (rhs.stride(0), rhs.stride(2)))
        return "split" if on_16 and rhs.stride(1) == 1 else "fma"
    if lhs.dtype != torch.bfloat16 or rhs.dtype != torch.bfloat16:
        return "fma"
    on_16 = bases and all(x * 2 % 16 == 0 for x in (
        lhs.stride(0), rhs.stride(0), rhs.stride(1)))
    return "wgmma" if on_16 and rhs.stride(2) == 1 else "wmma"


def _plan_cases() -> list:
    """(lhs, rhs) pairs on the CPU that take every branch of the plan:
    each dtype pair, bases on and off 16 bytes, row and group strides on
    and off 16 bytes, a transposed rhs, each against bf16 and fp32 lhs."""
    bf, f32 = torch.bfloat16, torch.float32
    lhs, rhs = torch.zeros(16, 64, dtype=bf), torch.zeros(2, 64, 64, dtype=bf)
    rt = rhs.transpose(1, 2)
    return [(lhs, rhs), (lhs.float(), rhs), (lhs, rhs.float()),
            (lhs.float(), rhs.float()),
            (torch.zeros(16 * 64 + 8, dtype=bf)[8:].view(16, 64), rhs),
            (torch.zeros(16 * 64 + 1, dtype=bf)[1:].view(16, 64), rhs),
            (lhs, torch.zeros(2 * 64 * 64 + 1, dtype=bf)[1:].view(2, 64, 64)),
            (torch.zeros(16, 100, dtype=bf), torch.zeros(2, 100, 72, dtype=bf)),
            (lhs, torch.zeros(2, 64, 68, dtype=bf)[..., :64]),
            (lhs, torch.zeros(2, 68, 64, dtype=bf)[:, :64]),
            (lhs, torch.zeros(2 * 64 * 64 + 4, dtype=bf).as_strided(
                (2, 64, 64), (64 * 64 + 4, 64, 1))),
            (lhs, torch.zeros(2, 64, 512, dtype=bf)[..., ::8]),
            (lhs, rt), (lhs.float(), rt),
            (torch.zeros(16 * 64 + 4, dtype=f32)[4:].view(16, 64), rt),
            (torch.zeros(16 * 64 + 1, dtype=f32)[1:].view(16, 64), rt),
            (torch.zeros(16, 66, dtype=f32)[:, :64], rt),
            (lhs.float(), torch.zeros(2 * 64 * 64 + 1, dtype=bf)[1:].view(
                2, 64, 64).transpose(1, 2)),
            (lhs.float(), torch.zeros(2 * 64 * 64 + 4, dtype=bf).as_strided(
                (2, 64, 64), (64 * 64 + 4, 64, 1)).transpose(1, 2)),
            (lhs.float(), torch.zeros(2, 64, 68, dtype=bf)[..., :64]
             .transpose(1, 2)),
            (lhs.float(), torch.zeros(2, 64, 512, dtype=bf)[..., ::8])]


def _tgmm_plan(lhs: torch.Tensor, dy: torch.Tensor, out_dtype) -> str:
    """K6's body for these operands and this output, from their dtypes,
    strides and 16-byte alignment alone: "split" (bf16 lhs against fp32 dy
    that tensor maps can read: unit column strides, both bases and row
    strides on 16 bytes; output rows of N values on 16 bytes, which the
    split body's TMA stores need; the backward's d_rhs) or "fma"
    (anything else: fp32 lhs, operand or output rows off 16 bytes). The
    output is allocated contiguous by ``_launch_tgmm``.
    ``_check_body_table`` holds it against the library's ``tgmm_body``."""
    if lhs.dtype != torch.bfloat16 or dy.dtype != torch.float32:
        return "fma"
    on_16 = (lhs.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
             and lhs.stride(0) * 2 % 16 == 0 and dy.stride(0) * 4 % 16 == 0
             and dy.shape[1] * out_dtype.itemsize % 16 == 0)
    return "split" if on_16 and lhs.stride(1) == dy.stride(1) == 1 else "fma"


def _tgmm_plan_cases() -> list:
    """(lhs, dy, out dtype) on the CPU that take every branch of K6's
    plan: each dtype pair, bases and row strides on and off 16 bytes, a
    non-unit column stride of either operand, output rows on and off 16
    bytes in either output dtype."""
    bf, f32 = torch.bfloat16, torch.float32
    lhs, dy = torch.zeros(16, 64, dtype=bf), torch.zeros(16, 32)
    dy36 = torch.zeros(16, 36)   # output rows of 72 (bf16) or 144 bytes
    return [(lhs, dy, bf), (lhs.float(), dy, bf), (lhs, dy.to(bf), bf),
            (lhs.float(), dy.to(bf), f32),
            (torch.zeros(16 * 64 + 8, dtype=bf)[8:].view(16, 64), dy, bf),
            (torch.zeros(16 * 64 + 1, dtype=bf)[1:].view(16, 64), dy, bf),
            (lhs, torch.zeros(16 * 32 + 4)[4:].view(16, 32), bf),
            (lhs, torch.zeros(16 * 32 + 1)[1:].view(16, 32), bf),
            (torch.zeros(16, 100, dtype=bf), dy, bf),
            (torch.zeros(16, 72, dtype=bf)[:, :64], dy, bf),
            (lhs, torch.zeros(16, 34)[:, :32], bf),
            (lhs, torch.zeros(16, 36)[:, :32], bf),
            (torch.zeros(16, 128, dtype=bf)[:, ::2], dy, bf),
            (lhs, torch.zeros(16, 64)[:, ::2], bf),
            (torch.zeros(16, 64, dtype=f32), torch.zeros(16, 36)[:, :32], f32),
            (lhs, dy36, bf), (lhs, dy36, f32), (lhs, dy, f32)]


def _check_body_table(lib) -> None:
    """Raises unless the library's ``gmm_body`` picks, for every case of
    ``_plan_cases``, the body that ``_gmm_plan`` names, and its
    ``tgmm_body``, for every case of ``_tgmm_plan_cases``, the body that
    ``_tgmm_plan`` names."""
    body = lib.gmm_body
    body.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    body.restype = ctypes.c_int
    for lhs, rhs in _plan_cases():
        strides = (ctypes.c_longlong * 3)(*rhs.stride())
        got = body(_DTYPE_CODE[lhs.dtype], _DTYPE_CODE[rhs.dtype],
                   lhs.data_ptr(), lhs.stride(0), rhs.data_ptr(), strides)
        got = _BODIES[got] if 0 <= got < len(_BODIES) else got
        if got != _gmm_plan(lhs, rhs):
            raise RuntimeError(
                f"grouped_matmul.cu runs body {got} at lhs {lhs.dtype} "
                f"{tuple(lhs.stride())}, rhs {rhs.dtype} "
                f"{tuple(rhs.stride())}; _gmm_plan names "
                f"{_gmm_plan(lhs, rhs)}")
    body = lib.tgmm_body
    body.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    body.restype = ctypes.c_int
    for lhs, dy, out_dtype in _tgmm_plan_cases():
        ls, ds = ((ctypes.c_longlong * 2)(*x.stride()) for x in (lhs, dy))
        got = body(_DTYPE_CODE[lhs.dtype], _DTYPE_CODE[dy.dtype],
                   _DTYPE_CODE[out_dtype], dy.shape[1], lhs.data_ptr(), ls,
                   dy.data_ptr(), ds)
        got = _TGMM_BODIES[got] if 0 <= got < len(_TGMM_BODIES) else got
        plan = _tgmm_plan(lhs, dy, out_dtype)
        if got != plan:
            raise RuntimeError(
                f"grouped_matmul.cu runs K6 body {got} at lhs {lhs.dtype} "
                f"{tuple(lhs.stride())}, dy {dy.dtype} {tuple(dy.stride())},"
                f" out {out_dtype}; _tgmm_plan names {plan}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"grouped_matmul: {msg}")


def _check_operands(a, b, group_sizes, out_dtype) -> None:
    _check(a.is_cuda, f"lhs lies on {a.device}, not a CUDA device")
    for x in (b, group_sizes):
        _check(x.device == a.device, f"operand on {x.device}, lhs on "
               f"{a.device}")
    for x in (a, b):
        _check(x.dtype in _DTYPE_CODE, f"dtype {x.dtype} (fp32 or bf16)")
    _check(out_dtype in _DTYPE_CODE, f"output dtype {out_dtype} (fp32 or "
           f"bf16)")
    _check(group_sizes.dtype == torch.int32 and group_sizes.ndim == 1,
           f"group_sizes must be int32 [G], got {group_sizes.dtype} "
           f"{tuple(group_sizes.shape)}")
    _check(group_sizes.shape[0] <= MAX_GROUPS, f"{group_sizes.shape[0]} "
           f"groups; the kernels take at most {MAX_GROUPS}")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_gmm(fn, lhs, rhs, group_sizes, out_dtype) -> torch.Tensor:
    """One launch of K5 through ``fn``; the body that ran (``_gmm_plan``)
    is counted in ``GMM_BODY_LAUNCHES``."""
    m, k = lhs.shape
    g, _, n = rhs.shape
    plan = _gmm_plan(lhs, rhs)
    out = torch.empty(m, n, dtype=out_dtype, device=lhs.device)
    strides = (ctypes.c_longlong * 3)(*rhs.stride())
    rc = fn(lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), m, k, n, g, lhs.stride(0), strides,
            _DTYPE_CODE[lhs.dtype], _DTYPE_CODE[rhs.dtype],
            _DTYPE_CODE[out_dtype], _stream(lhs))
    if rc != 0:
        why = ": the driver refused a tensor map" if rc == -2 else ""
        raise RuntimeError(f"gmm kernel launch failed (code {rc}{why}) at "
                           f"lhs {tuple(lhs.shape)} {lhs.dtype}, rhs "
                           f"{tuple(rhs.shape)} {rhs.dtype}, body {plan}")
    GMM_BODY_LAUNCHES[plan] += 1
    return out


def _launch_tgmm(fn, lhs, dy, group_sizes, num_groups,
                 out_dtype) -> torch.Tensor:
    """One launch of K6 through ``fn``; the body that ran (``_tgmm_plan``)
    is counted in ``TGMM_BODY_LAUNCHES``."""
    m, k = lhs.shape
    n = dy.shape[1]
    plan = _tgmm_plan(lhs, dy, out_dtype)
    out = torch.empty(num_groups, k, n, dtype=out_dtype, device=lhs.device)
    rc = fn(lhs.data_ptr(), dy.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), m, k, n, num_groups, lhs.stride(0), dy.stride(0),
            _DTYPE_CODE[lhs.dtype], _DTYPE_CODE[dy.dtype],
            _DTYPE_CODE[out_dtype], _stream(lhs))
    if rc != 0:
        why = ": the driver refused a tensor map" if rc == -2 else ""
        raise RuntimeError(f"tgmm kernel launch failed (code {rc}{why}) at "
                           f"lhs {tuple(lhs.shape)} {lhs.dtype}, dy "
                           f"{tuple(dy.shape)} {dy.dtype}, body {plan}")
    TGMM_BODY_LAUNCHES[plan] += 1
    return out


def _unit_columns(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
        out_dtype=None) -> torch.Tensor:
    """K5: ``out [M, N]`` in ``out_dtype`` (default the promoted input
    dtype), rows past ``sum(group_sizes)`` zero. ``rhs`` may be any strided
    view of [G, K, N] (the backward passes ``rhs^T``)."""
    global GMM_LAUNCHES
    out_dtype = out_dtype or torch.promote_types(lhs.dtype, rhs.dtype)
    if runs_plain(lhs):
        return gmm_reference(lhs, rhs, group_sizes, out_dtype)
    group_sizes = group_sizes.to(torch.int32)
    _check_operands(lhs, rhs, group_sizes, out_dtype)
    out = _launch_gmm(_kernel("gmm"), _unit_columns(lhs), rhs,
                      group_sizes.contiguous(), out_dtype)
    GMM_LAUNCHES += 1
    return out


def tgmm(lhs: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
         num_groups: int, out_dtype) -> torch.Tensor:
    """K6: ``d_rhs [G, K, N] = lhs_g^T @ dy_g`` in ``out_dtype``, zeros for
    empty groups, rows past ``sum(group_sizes)`` ignored."""
    global TGMM_LAUNCHES
    if runs_plain(lhs):
        return tgmm_reference(lhs, dy, group_sizes, num_groups, out_dtype)
    group_sizes = group_sizes.to(torch.int32)
    _check_operands(lhs, dy, group_sizes, out_dtype)
    _check(dy.shape[0] == lhs.shape[0], f"dy {tuple(dy.shape)} and lhs "
           f"{tuple(lhs.shape)} differ in rows")
    out = _launch_tgmm(_kernel("tgmm"), _unit_columns(lhs), _unit_columns(dy),
                       group_sizes.contiguous(), num_groups, out_dtype)
    TGMM_LAUNCHES += 1
    return out


class _GroupedMatmul(torch.autograd.Function):
    """Forward K5; backward the JAX ``_pallas_gmm_bwd`` in fp32: d_lhs from
    K5 against ``rhs^T`` (read through strides with no copy: the split
    body for a bf16 rhs, FMA for fp32) in lhs's dtype, d_rhs from K6 (the
    split body for a bf16 lhs, FMA for fp32) in rhs's dtype."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, out_dtype):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dy = dy.float()
        on_cpu = runs_plain(dy)
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            rt = rhs.transpose(1, 2)
            dlhs = gmm(dy, rt.float() if on_cpu else rt, group_sizes,
                       lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs.float() if on_cpu else lhs, dy, group_sizes,
                        rhs.shape[0], rhs.dtype)
        return dlhs, drhs, None, None


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor, *, impl: str = "auto",
                   preferred_element_type=None) -> torch.Tensor:
    """Ragged grouped GEMM over a group-sorted row buffer -> [M, N].

    ``impl``: "auto" / "pallas" (K5 and K6 through the autograd Function:
    the kernels for CUDA tensors, their plain versions for CPU tensors),
    "scan" (masked group loop) or "einsum" (masked one-hot).
    Rows at index >= ``sum(group_sizes)`` yield zeros and propagate zero
    gradient."""
    if lhs.ndim != 2 or rhs.ndim != 3 or group_sizes.ndim != 1:
        raise ValueError(f"grouped_matmul expects lhs [M,K], rhs [G,K,N], "
                         f"group_sizes [G]; got {tuple(lhs.shape)}, "
                         f"{tuple(rhs.shape)}, {tuple(group_sizes.shape)}")
    if lhs.shape[1] != rhs.shape[1] or rhs.shape[0] != group_sizes.shape[0]:
        raise ValueError(f"grouped_matmul shape mismatch: lhs "
                         f"{tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}")
    if impl == "ragged":
        raise ValueError("impl='ragged' is jax.lax.ragged_dot, an XLA op "
                         "with no counterpart in the PyTorch package; use "
                         "'auto' (the CUDA kernels) or 'scan'")
    if impl not in IMPLS:
        raise ValueError(f"unknown grouped_matmul impl {impl!r}; use one of "
                         f"{IMPLS}")
    out_dtype = preferred_element_type or torch.promote_types(lhs.dtype,
                                                              rhs.dtype)
    group_sizes = group_sizes.to(torch.int32)
    if impl == "scan":
        return gmm_reference(lhs, rhs, group_sizes, out_dtype)
    if impl == "einsum":
        return gmm_einsum(lhs, rhs, group_sizes, out_dtype)
    return _GroupedMatmul.apply(lhs, rhs, group_sizes, out_dtype)
