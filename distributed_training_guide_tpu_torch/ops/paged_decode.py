"""Paged flash attention over block tables: one kernel family for every
paged forward of the serve plane, at query tile T (decode T = 1, chunked
prefill T = chunk, speculative verify T = k + 1).

Counterpart of ``distributed_training_guide_tpu/ops/paged_decode.py``,
whose Pallas ``_attend_kernel`` is rewritten here in CUDA for ``sm_90a``
(``csrc/paged_attend.cu``; design and bound in its header). The kernels
read k/v THROUGH the block table: per forward they read the live pages
once and write only the [S, T, Hq, D] output and the fp32 partials of
the context's splits, which a combine pass merges into it), where the
plain version (``paged_attend_reference``) gathers each slot's table into
a contiguous [S, M * page, Hkv, D] view first.

``_plan`` picks the body (``split``: CUDA cores, for decode, short
verify tiles and fp32; ``mma``: tensor cores, for bf16 tiles of 64 or
more folded rows), its rows per block and the pages per split, from the
shapes alone: never from the batch or the lengths, so every output row
is bitwise the same whatever it is batched with.
``split_partials_reference`` and ``combine_partials_reference`` are the
plain versions of a body's partials and of the combine; composed, they
equal ``paged_attend_reference`` up to the order of the sums.

``paged_flash_attend`` launches the kernels for CUDA tensors (or raises)
and runs ``paged_attend_reference`` for CPU tensors: that is the one
reason it ever takes the plain version. ``LAUNCHES`` counts its calls on
CUDA tensors (one per forward of a layer, whatever it launches);
``SPLIT_LAUNCHES``, ``MMA_LAUNCHES`` and ``COMBINE_LAUNCHES`` count each
kernel's launches, so a run can show which kernels its forwards went
through.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from .._device import runs_plain
from . import _build
from .attention import NO_WINDOW, check_static_window, multihead_attention

LAUNCHES = 0           # paged_flash_attend calls on CUDA tensors
SPLIT_LAUNCHES = 0     # launches of the split-context body
MMA_LAUNCHES = 0       # launches of the tensor-core body
COMBINE_LAUNCHES = 0   # launches of the combine pass
NEG_INF = -1e30        # the kernel's mask constant (the plain path uses
                       # finfo(float32).min, as the JAX package does)
HEAD_DIMS = (64, 96, 128, 256)
MAX_PAGE = 256        # positions per page, at most
SPLIT_PAGES = 16       # pages per split of the split-context body
MMA_SPLIT_PAGES = 32   # pages per split of the tensor-core body
MMA_ROWS = 64          # folded query rows per tensor-core block
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_BODY_CODE = {"split": 0, "mma": 1}
_fns: dict = {}


class Plan(NamedTuple):
    body: str              # "split" (CUDA cores) or "mma" (tensor cores)
    rows: int              # folded query rows per block
    pages_per_split: int   # split edges sit at multiples of this
    splits: int            # ceil(M / pages_per_split)


def _plan(t: int, groups: int, d: int, q_dtype: torch.dtype,
          kv_dtype: torch.dtype, m: int) -> Plan:
    """The body, rows per block, pages per split and number of splits for
    T query tokens of ``groups`` heads per kv-head, head_dim ``d`` and a
    table of ``m`` pages. It reads neither the batch nor the lengths: the
    grid's split extent is fixed by the table width, and a split past a
    slot's live band exits at once."""
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_flash_attend: head_dim {d}; the kernels "
                         f"take {HEAD_DIMS}")
    rows = t * groups
    if (q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8)
            and rows >= MMA_ROWS):
        return Plan("mma", MMA_ROWS, MMA_SPLIT_PAGES, -(-m // MMA_SPLIT_PAGES))
    return Plan("split", 4 if rows <= 4 else 8, SPLIT_PAGES,
                -(-m // SPLIT_PAGES))


def paged_decode_eligible(head_dim: int, page_size: int,
                          quantized: bool = False) -> bool:
    """Shapes the CUDA kernels take: head_dim 64, 96, 128 or 256 and a
    page of 1 to ``MAX_PAGE`` positions, for float and int8 pools alike."""
    del quantized
    return head_dim in HEAD_DIMS and 1 <= page_size <= MAX_PAGE


def _gathered(q, k_pages, v_pages, tables, k_scale, v_scale):
    """Each slot's block table as a contiguous [S, M * page, Hkv, D] view,
    an int8 pool dequantized to q's dtype."""
    s, m = tables.shape
    page = k_pages.shape[1]
    idx = tables.long()
    kg, vg = k_pages[idx], v_pages[idx]              # [S, M, page, Hkv, D]
    if k_scale is not None:
        kg = (kg.float() * k_scale[idx][..., None]).to(q.dtype)
        vg = (vg.float() * v_scale[idx][..., None]).to(q.dtype)
    return (kg.reshape(s, m * page, *kg.shape[3:]),
            vg.reshape(s, m * page, *vg.shape[3:]))


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
    kg, vg = _gathered(q, k_pages, v_pages, tables, k_scale, v_scale)
    positions = (lengths.long()[:, None]
                 + torch.arange(t, device=q.device)[None, :])
    kv_pos = torch.arange(kg.shape[1], device=q.device)[None, :].expand(s, -1)
    out = multihead_attention(q, kg, vg, causal=True, positions=positions,
                              kv_positions=kv_pos, impl="xla",
                              standard_layout=False, window=window,
                              scale=scale, logit_softcap=softcap)
    return out[:, 0] if squeeze else out


def split_partials_reference(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, tables: torch.Tensor,
                             lengths: torch.Tensor, *, pages_per_split: int,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None,
                             window=None, scale: Optional[float] = None,
                             softcap: Optional[float] = None):
    """The plain version of a body's output before the combine: for each
    split of ``pages_per_split`` pages, each query row's online-softmax
    state over the split's keys in its (causal, ``< window``) band, in
    fp32. Returns (m [splits, S, T, Hq], l [splits, S, T, Hq],
    acc [splits, S, T, Hq, D]); acc is not normalised. A split with no
    live key for a row leaves the neutral state m = NEG_INF, l = 0,
    acc = 0."""
    if q.ndim == 3:
        q = q[:, None]
    s, t, hq, d = q.shape
    m_pages, page = tables.shape[1], k_pages.shape[1]
    hkv = k_pages.shape[2]
    groups = hq // hkv
    kg, vg = _gathered(q, k_pages, v_pages, tables, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    win = NO_WINDOW if window is None else int(window)
    qg = q.float().reshape(s, t, hkv, groups, d)
    x = torch.einsum("sthgd,skhd->sthgk", qg, kg.float()) * scale
    if softcap:
        x = torch.tanh(x / softcap) * softcap
    qpos = lengths.long()[:, None] + torch.arange(t, device=q.device)
    kpos = torch.arange(m_pages * page, device=q.device)
    diff = qpos[:, :, None] - kpos                      # [S, T, K]
    live = ((diff >= 0) & (diff < win))[:, :, None, None, :]
    x = torch.where(live, x, torch.full_like(x, NEG_INF))
    splits = -(-m_pages // pages_per_split)
    keys = pages_per_split * page
    ms, ls, accs = [], [], []
    for sp in range(splits):
        cut = slice(sp * keys, min((sp + 1) * keys, m_pages * page))
        xs, lv = x[..., cut], live[..., cut]
        mx = xs.amax(-1)                                # [S, T, Hkv, G]
        p = torch.where(lv, torch.exp(xs - mx[..., None]),
                        torch.zeros_like(xs))
        ms.append(mx.reshape(s, t, hq))
        ls.append(p.sum(-1).reshape(s, t, hq))
        accs.append(torch.einsum("sthgk,skhd->sthgd", p, vg[:, cut].float())
                    .reshape(s, t, hq, d))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_partials_reference(m: torch.Tensor, l: torch.Tensor,
                               acc: torch.Tensor) -> torch.Tensor:
    """The plain combine: each row's partials merged in split order
    (rescaled by exp(m_i - max), l and acc summed one split after the
    other), then acc / safe_l with safe_l = 1 where l == 0, in fp32. A
    neutral split adds exact zeros."""
    mx = m.amax(0)
    l_tot = torch.zeros_like(l[0])
    o = torch.zeros_like(acc[0])
    for sp in range(m.shape[0]):
        w = torch.exp(m[sp] - mx)
        l_tot = l_tot + l[sp] * w
        o = o + acc[sp] * w[..., None]
    safe_l = torch.where(l_tot == 0, torch.ones_like(l_tot), l_tot)
    return o / safe_l[..., None]


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("paged_attend"), name)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ptr] * 11 + [i32] * 16 + [f32, f32, ptr]
                       if name == "paged_attend"
                       else [ptr] * 5 + [i32] * 9 + [ptr])
        fn.restype = i32
        _fns[name] = fn
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_flash_attend: {msg}")


def _validate(q, k_pages, v_pages, tables, lengths, k_scale, v_scale):
    """The checks every CUDA launch shares; q is rank 4 here."""
    _check(q.is_cuda, f"q lies on {q.device}, not a CUDA device")
    s, _, hq, d = q.shape
    p, page, hkv, d_kv = k_pages.shape
    m = tables.shape[1] if tables.ndim == 2 else -1
    quantized = k_scale is not None
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
           f"kernels take {HEAD_DIMS}")
    _check(paged_decode_eligible(d, page), f"page size {page} (1.."
           f"{MAX_PAGE})")
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
    return _plan(q.shape[1], hq // hkv, d, q.dtype, k_pages.dtype, m)


def _launch(q, k_pages, v_pages, tables, lengths, k_scale, v_scale, window,
            scale, softcap, plan, out, parts, combine):
    """One body launch writing ``parts`` = (m, l, acc) fp32 scratch, and
    the combine into ``out`` after it when ``combine``; q is rank 4."""
    global SPLIT_LAUNCHES, MMA_LAUNCHES, COMBINE_LAUNCHES
    s, t, hq, d = q.shape
    p, page, hkv, _ = k_pages.shape
    quantized = k_scale is not None
    win = NO_WINDOW if window is None else int(window)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rc = _kernel("paged_attend")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), lengths.data_ptr(),
        None if out is None else out.data_ptr(),
        *(x.data_ptr() for x in parts),
        s, t, hq, hkv, d, p, page, tables.shape[1], _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k_pages.dtype], win, _BODY_CODE[plan.body], plan.rows,
        plan.pages_per_split, plan.splits, int(combine), float(scale), float(softcap) if softcap else 0.0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attend kernel launch failed (code {rc}) "
                           f"at q {tuple(q.shape)} {q.dtype}, pools "
                           f"{tuple(k_pages.shape)} {k_pages.dtype}, plan "
                           f"{plan}")
    if plan.body == "mma":
        MMA_LAUNCHES += 1
    else:
        SPLIT_LAUNCHES += 1
    COMBINE_LAUNCHES += int(combine)


def _empty_parts(plan, q, neutral=False):
    """(m, l, acc) fp32 scratch for ``plan.splits`` partials of q's rows,
    carved from one allocation (acc first, so its rows stay aligned);
    ``neutral`` starts it at m = NEG_INF, l = 0, acc = 0."""
    s, t, hq, d = q.shape
    shape = (plan.splits, s, t, hq)
    n = math.prod(shape)
    buf = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
    acc = buf[:n * d].view(*shape, d)
    m, l = buf[n * d:n * (d + 1)].view(shape), buf[n * (d + 1):].view(shape)
    if neutral:
        acc.zero_()
        l.zero_()
        m.fill_(NEG_INF)
    return m, l, acc


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
    if runs_plain(q):
        return paged_attend_reference(
            q, k_pages, v_pages, tables, lengths, k_scale=k_scale,
            v_scale=v_scale, window=window, scale=scale, softcap=softcap)
    squeeze = q.ndim == 3
    if squeeze:
        q = q[:, None]
    plan = _validate(q, k_pages, v_pages, tables, lengths, k_scale, v_scale)
    out = torch.empty_like(q)
    _launch(q, k_pages, v_pages, tables, lengths, k_scale, v_scale, window,
            scale, softcap, plan, out, _empty_parts(plan, q), combine=True)
    LAUNCHES += 1
    return out[:, 0] if squeeze else out


def split_partials(q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, tables: torch.Tensor,
                   lengths: torch.Tensor, *,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None, window=None,
                   scale: Optional[float] = None,
                   softcap: Optional[float] = None):
    """A body's partials alone, (m, l, acc) as ``split_partials_reference``
    gives them, over the splits ``_plan`` chooses: the body's launch on
    CUDA tensors, the plain version on CPU tensors. The body writes only
    the splits inside each row block's band; the scratch starts at the
    neutral state so the rest compare too."""
    if q.ndim == 3:
        q = q[:, None]
    if runs_plain(q):
        plan = _plan(q.shape[1], q.shape[2] // k_pages.shape[2], q.shape[3],
                     q.dtype, k_pages.dtype, tables.shape[1])
        return split_partials_reference(
            q, k_pages, v_pages, tables, lengths,
            pages_per_split=plan.pages_per_split, k_scale=k_scale,
            v_scale=v_scale, window=window, scale=scale, softcap=softcap)
    check_static_window(window)
    plan = _validate(q, k_pages, v_pages, tables, lengths, k_scale, v_scale)
    parts = _empty_parts(plan, q, neutral=True)
    _launch(q, k_pages, v_pages, tables, lengths, k_scale, v_scale, window,
            scale, softcap, plan, None, parts, combine=False)
    return parts


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     lengths: torch.Tensor, *, page: int, table_pages: int,
                     pages_per_split: int, window=None) -> torch.Tensor:
    """The combine alone over partials [splits, S, T, Hq(, D)], in fp32:
    its launch on CUDA tensors, ``combine_partials_reference`` on CPU
    tensors. The kernel reads, per row, only the splits that hold a key of
    its band (``lengths``, ``page``, ``table_pages`` = M, ``window``)."""
    global COMBINE_LAUNCHES
    if runs_plain(m):
        return combine_partials_reference(m, l, acc)
    check_static_window(window)
    splits, s, t, hq, d = acc.shape
    for x in (m, l, acc, lengths):
        _check(x.is_cuda and x.is_contiguous(), "partials and lengths must "
               "be contiguous CUDA tensors")
    _check(m.dtype == l.dtype == acc.dtype == torch.float32,
           "partials must be fp32")
    _check(tuple(m.shape) == tuple(l.shape) == (splits, s, t, hq),
           "m and l must be [splits, S, T, Hq]")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (s,),
           "lengths must be int32 [S]")
    _check(splits == -(-table_pages // pages_per_split),
           f"{splits} splits for {table_pages} pages of {pages_per_split}")
    out = torch.empty(s, t, hq, d, dtype=torch.float32, device=m.device)
    win = NO_WINDOW if window is None else int(window)
    rc = _kernel("paged_attend_combine")(
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), s, t, hq, d, page, table_pages, win, pages_per_split,
        splits, torch.cuda.current_stream(m.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attend_combine launch failed (code {rc}) "
                           f"at partials {tuple(acc.shape)}")
    COMBINE_LAUNCHES += 1
    return out
