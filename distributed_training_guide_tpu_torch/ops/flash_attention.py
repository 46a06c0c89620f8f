"""Flash attention: the forward kernel and its two backward kernels, joined
as one ``torch.library`` custom op with its autograd formula.

Counterpart of ``distributed_training_guide_tpu/ops/flash_attention.py``,
whose Pallas kernels are rewritten here in CUDA for ``sm_90a``:
``_fwd_kernel`` (K1) as ``csrc/flash_fwd.cu``, ``_dq_kernel`` (K2) and
``_dkv_kernel`` (K3) as ``csrc/flash_bwd.cu`` (design and bound in their
headers; ``_fwd_plan`` and ``_bwd_plan`` name the body of each dtype and
D).
Shapes follow the JAX package's public function: q [B, Sq, Hq, D],
k / v [B, Sk, Hkv, D], grouped-query heads when Hkv < Hq; the kernels read
that layout through strides, so nothing is transposed.

The band contract is the JAX package's: query row i sits at position
``i + q_off``, key row j at ``j + k_off``, and under ``causal`` a pair is
live when ``0 <= qpos - kpos < window``. ``band`` is the packed
``[window, q_off, k_off]`` int32 triple (``pack_band``; ``2**30`` means no
window); without it the offsets are 0. ``scale`` defaults to
``head_dim**-0.5``; ``softcap`` is the tanh cap applied before the mask,
with its ``(1 - tanh^2)`` factor in backward. A row with no live key gives
o = 0 and lse = -1e30, and a gradient of 0 (the TPU kernels' backward
would give exp(0) = 1 on its masked lanes there).

Each wrapper runs the plain PyTorch version (``flash_attention_reference``,
``flash_bwd_reference``) for CPU tensors, which is the one reason it ever
takes it, and launches its kernel for CUDA tensors, or raises.
``FWD_LAUNCHES``, ``DQ_LAUNCHES`` and ``DKV_LAUNCHES`` count launches,
``FWD_BODY_LAUNCHES`` K1's launches by body; ``ALIGN_COPIES`` counts
operands that the Hopper bodies' tensor maps could not read in place (a
base or stride off 16 bytes) and that were copied before the launch.
"""
from __future__ import annotations

import ctypes
import logging
import math
from typing import Optional

import torch

from .._device import runs_plain
from . import _build
from .attention import NO_WINDOW, check_static_window
from .remat import checkpoint_name

FWD_LAUNCHES = 0    # K1 launches since the caller last reset it
FWD_BODY_LAUNCHES = {"fma": 0, "wmma": 0, "wgmma": 0}   # ... by body
DQ_LAUNCHES = 0     # K2
DKV_LAUNCHES = 0    # K3
ALIGN_COPIES = 0    # operands copied for the TMA bodies' 16-byte rule
NEG_INF = -1e30     # the kernels' mask constant
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BODIES = ("fma", "wmma", "wgmma")   # the codes of flash_{fwd,bwd}_body
FWD_BLOCK_K = 64    # the keys of one kv tile of the Hopper forward body
_fns: dict = {}
_log = logging.getLogger(__name__)


def pack_band(window=None, q_off: int = 0, k_off: int = 0) -> torch.Tensor:
    """The ``[window, q_off, k_off]`` int32 band operand (CPU), with
    ``2**30`` for no window: the JAX package's ``_pack_band``."""
    return torch.tensor([NO_WINDOW if window is None else int(window),
                         int(q_off), int(k_off)], dtype=torch.int32)


def _band_ints(window, band) -> tuple:
    """(window, q_off, k_off) as host ints. A band on the card costs one
    host read here."""
    if band is None:
        check_static_window(window)
        return (NO_WINDOW if window is None else int(window)), 0, 0
    w, q_off, k_off = (int(x) for x in (band.tolist()
                                        if torch.is_tensor(band) else band))
    check_static_window(w)
    return w, q_off, k_off


def _live(sq: int, sk: int, causal: bool, band: tuple, device):
    """[Sq, Sk] bool mask of live pairs, None when every pair is live."""
    if not causal:
        return None
    window, q_off, k_off = band
    qpos = torch.arange(sq, device=device)[:, None] + q_off
    kpos = torch.arange(sk, device=device)[None, :] + k_off
    return (qpos >= kpos) & (qpos - kpos < window)


def _scores(q, k, scale, softcap):
    """fp32 scores [B, Hkv, G, Sq, Sk] and the tanh of the cap (or None)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    return s, t


def flash_attention_reference(q, k, v, *, causal: bool = True, window=None,
                              scale: Optional[float] = None,
                              softcap: Optional[float] = None, band=None,
                              round_p: bool = False):
    """The plain version of K1, in fp32 inside and masked as the kernel
    is: (o [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq] fp32). With
    ``round_p`` it follows the bf16 kernel bodies' arithmetic: it walks the
    kv tiles of ``FWD_BLOCK_K`` keys with a running max, rescales l and the
    fp32 accumulator as the max moves, and rounds each tile's p to q's
    dtype before P V (l sums p unrounded); a no-op rounding for fp32."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s, _ = _scores(q, k, scale, softcap)
    live = _live(sq, sk, causal, _band_ints(window, band), q.device)
    if live is not None:
        s = torch.where(live, s, NEG_INF)
    if round_p:
        o, m, l = _tiled_softmax_pv(s, live, v, q.dtype)
    else:
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        if live is not None:
            p = torch.where(live, p, 0.0)
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    safe_l = torch.where(l == 0, 1.0, l)
    o = o / safe_l
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    lse = (m + torch.log(safe_l)).reshape(b, hq, sq)
    return o, lse


def _tiled_softmax_pv(s, live, v, p_dtype):
    """(P V unnormalized, m, l) over kv tiles of ``FWD_BLOCK_K`` keys with a
    running max, each tile's p rounded to ``p_dtype`` for P V: the online
    softmax of the bf16 kernel bodies. ``s`` [B, Hkv, G, Sq, Sk] holds
    -1e30 at masked pairs; ``live`` [Sq, Sk] or None."""
    m = torch.full(s.shape[:-1] + (1,), NEG_INF, device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (v.shape[-1],), device=s.device)
    for k0 in range(0, s.shape[-1], FWD_BLOCK_K):
        st = s[..., k0:k0 + FWD_BLOCK_K]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        if live is not None:
            p = torch.where(live[:, k0:k0 + FWD_BLOCK_K], p, 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(p_dtype).float(),
            v[:, k0:k0 + FWD_BLOCK_K].float())
        m = m_new
    return acc, m, l


def _bwd_terms(q, k, v, do, lse, delta, causal, window, scale, softcap,
               band, round_p_ds=False):
    """The probabilities and score grads of K2 / K3 ([B, Hkv, G, Sq, Sk]
    fp32), rebuilt from ``lse`` / ``delta`` [B, Hq, Sq]; with
    ``round_p_ds`` each rounded to q's dtype, as the kernels round them
    before the products that follow (ds from the unrounded p)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s, t = _scores(q, k, scale, softcap)
    p = torch.exp(s - lse.float().reshape(b, hkv, g, sq, 1))
    live = _live(sq, sk, causal, _band_ints(window, band), q.device)
    if live is not None:
        p = torch.where(live, p, 0.0)
    dog = do.float().reshape(b, sq, hkv, g, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta.float().reshape(b, hkv, g, sq, 1))
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    if round_p_ds:
        p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    return p, ds, dog


def flash_dq_reference(q, k, v, do, lse, delta, *, causal: bool = True,
                       window=None, scale: Optional[float] = None,
                       softcap: Optional[float] = None, band=None,
                       round_p_ds: bool = False):
    """The plain version of K2: dq in q's dtype. ``round_p_ds`` rounds ds
    to q's dtype before the product, as the bf16 bodies do (a no-op for
    fp32)."""
    _, ds, _ = _bwd_terms(q, k, v, do, lse, delta, causal, window, scale,
                          softcap, band, round_p_ds)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, *, causal: bool = True,
                        window=None, scale: Optional[float] = None,
                        softcap: Optional[float] = None, band=None,
                        round_p_ds: bool = False):
    """The plain version of K3: (dk, dv) in k's dtype, summed over each kv
    head's group. ``round_p_ds`` rounds p and ds to q's dtype before the
    products, as the bf16 bodies do (a no-op for fp32)."""
    p, ds, dog = _bwd_terms(q, k, v, do, lse, delta, causal, window, scale,
                            softcap, band, round_p_ds)
    qg = q.float().reshape(dog.shape)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(q, k, v, do, lse, delta, **kw):
    """The plain versions of K2 and K3: (dq, dk, dv)."""
    return (flash_dq_reference(q, k, v, do, lse, delta, **kw),
            *flash_dkv_reference(q, k, v, do, lse, delta, **kw))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _kernel(name: str):
    """The ctypes function of a kernel, its library built on first use and
    its body table held against the plan."""
    fn = _fns.get(name)
    if fn is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        source = "flash_fwd" if name == "flash_fwd" else "flash_bwd"
        lib = _build.load(source)
        _check_body_table(lib, source)
        fn = getattr(lib, name)
        n_ptr = {"flash_fwd": 5, "flash_bwd_dq": 7, "flash_bwd_dkv": 8}[name]
        fn.argtypes = ([ptr] * n_ptr + [i32] * 6 + [ptr] + [i32] * 5
                       + [f32, f32, ptr])
        fn.restype = i32
        _fns[name] = fn
    return fn


def _check_body_table(lib, source: str = "flash_bwd") -> None:
    """Raises unless the library's ``<source>_body`` picks, for every
    dtype and head_dim, the body that its plan (``_fwd_plan`` for
    flash_fwd, ``_bwd_plan`` for flash_bwd) names."""
    plan, plan_name = ((_fwd_plan, "_fwd_plan") if source == "flash_fwd"
                       else (_bwd_plan, "_bwd_plan"))
    body = getattr(lib, f"{source}_body")
    body.argtypes = [ctypes.c_int, ctypes.c_int]
    body.restype = ctypes.c_int
    for dtype, code in _DTYPE_CODE.items():
        for d in HEAD_DIMS:
            got = body(code, d)
            got = _BODIES[got] if 0 <= got < len(_BODIES) else got
            if got != plan(d, dtype):
                raise RuntimeError(
                    f"{source}.cu runs body {got} at {dtype}, D {d}; "
                    f"{plan_name} names {plan(d, dtype)}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _check_operands(q, k, v, *extra) -> None:
    _check(q.is_cuda, f"q lies on {q.device}, not a CUDA device")
    for x in (k, v, *extra):
        _check(x.device == q.device, f"operand on {x.device}, q on "
               f"{q.device}")
    _check(q.dtype in _DTYPE_CODE, f"dtype {q.dtype} (fp32 or bf16)")
    for x in (k, v, *extra):
        _check(x.dtype == q.dtype, f"operands differ in dtype ({x.dtype}, "
               f"q {q.dtype})")
    _check(q.ndim == 4 and k.ndim == 4 and k.shape == v.shape,
           f"q [B, Sq, Hq, D] and k / v [B, Sk, Hkv, D], got "
           f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, _, hq, d = q.shape
    _check(k.shape[0] == b and k.shape[3] == d, f"k {tuple(k.shape)} does "
           f"not match q {tuple(q.shape)}")
    _check(d in HEAD_DIMS, f"head_dim {d}; the kernels take {HEAD_DIMS}")
    hkv = k.shape[2]
    _check(hkv >= 1 and hq % hkv == 0, f"query heads ({hq}) must be a "
           f"positive multiple of kv heads ({hkv})")
    for x in (q, k, v, *extra):
        _check(x.stride(-1) == 1, "head_dim must be contiguous (stride 1)")


def _fwd_plan(d: int, dtype) -> str:
    """The forward body that ``flash_fwd.cu`` runs for head_dim ``d`` and
    ``dtype``, from those two alone: "wgmma" (bf16, D 64 / 128: Q resident,
    K / V through a TMA ring, wgmma, scores and O in registers), "wmma"
    (bf16, D 256) or "fma" (fp32). ``_check_body_table`` holds it against
    the library's own table when the library loads."""
    if dtype == torch.bfloat16:
        return "wgmma" if d in (64, 128) else "wmma"
    return "fma"


def _bwd_plan(d: int, dtype) -> str:
    """The backward body that ``flash_bwd.cu`` runs for head_dim ``d`` and
    ``dtype``, from those two alone: "wgmma" (bf16, D 64 / 128: TMA ring,
    wgmma, scores in registers), "wmma" (bf16, D 256) or "fma" (fp32).
    ``_check_body_table`` holds it against the library's own table when
    the library loads."""
    if dtype == torch.bfloat16:
        return "wgmma" if d in (64, 128) else "wmma"
    return "fma"


def _tma_ready(x) -> bool:
    """A base and (b, s, h) strides on 16 bytes, as a tensor map needs."""
    return (x.data_ptr() % 16 == 0
            and all(x.stride(i) * x.element_size() % 16 == 0
                    for i in range(x.ndim - 1)))


def _tma_operands(*xs) -> list:
    """Each [B, S, H, D] operand as the TMA bodies can read it: itself, or
    a contiguous copy (counted in ``ALIGN_COPIES``) when its base or
    strides are off 16 bytes."""
    global ALIGN_COPIES
    out = []
    for x in xs:
        if not _tma_ready(x):
            x = x.clone(memory_format=torch.contiguous_format)
            ALIGN_COPIES += 1
        out.append(x)
    return out


def _strides(*xs):
    vals = [x.stride(i) for x in xs for i in range(3)]
    return (ctypes.c_longlong * len(vals))(*vals)


_HOPPER_ERRORS = {-2: "the driver refused a tensor map",
                  -3: "too few registers at launch for setmaxnreg"}


def _launch_fwd(fn, q, k, v, causal, band, scale, softcap):
    """(o, lse) from one launch of K1 through ``fn``; the body that ran is
    counted in ``FWD_BODY_LAUNCHES``."""
    b, sq, hq, d = q.shape
    plan = _fwd_plan(d, q.dtype)
    if plan == "wgmma" and q.is_cuda:
        q, k, v = _tma_operands(q, k, v)
    sk, hkv = k.shape[1], k.shape[2]
    window, q_off, k_off = band
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    stream = (torch.cuda.current_stream(q.device).cuda_stream
              if q.is_cuda else None)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, sq, sk, hq, hkv, d, _strides(q, k, v),
            _DTYPE_CODE[q.dtype], int(causal), window, q_off, k_off,
            float(scale), float(softcap or 0.0), stream)
    if rc != 0:
        why = f": {_HOPPER_ERRORS[rc]}" if rc in _HOPPER_ERRORS else ""
        raise RuntimeError(f"flash_fwd kernel launch failed (code {rc}{why}) "
                           f"at q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"{q.dtype}, body {plan}")
    FWD_BODY_LAUNCHES[plan] += 1
    return o, lse


def _launch_bwd(fn, dkv: bool, q, k, v, do, lse, delta, causal, band,
                scale, softcap):
    """dq (K2) or (dk, dv) (K3) from one launch through ``fn``."""
    b, sq, hq, d = q.shape
    plan = _bwd_plan(d, q.dtype)
    _log.debug("flash_bwd_%s: body %s", "dkv" if dkv else "dq", plan)
    if plan == "wgmma" and q.is_cuda:
        q, k, v, do = _tma_operands(q, k, v, do)
    sk, hkv = k.shape[1], k.shape[2]
    window, q_off, k_off = band
    outs = ([torch.empty(k.shape, dtype=k.dtype, device=k.device)
             for _ in range(2)] if dkv
            else [torch.empty(q.shape, dtype=q.dtype, device=q.device)])
    stream = (torch.cuda.current_stream(q.device).cuda_stream
              if q.is_cuda else None)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
            b, sq, sk, hq, hkv, d, _strides(q, k, v, do),
            _DTYPE_CODE[q.dtype], int(causal), window, q_off, k_off,
            float(scale), float(softcap or 0.0), stream)
    if rc != 0:
        why = f": {_HOPPER_ERRORS[rc]}" if rc in _HOPPER_ERRORS else ""
        raise RuntimeError(f"{'flash_bwd_dkv' if dkv else 'flash_bwd_dq'} "
                           f"kernel launch failed (code {rc}{why}) at q "
                           f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype}, "
                           f"body {plan}")
    return tuple(outs) if dkv else outs[0]


def flash_fwd(q, k, v, *, causal: bool = True, window=None,
              scale: Optional[float] = None, softcap: Optional[float] = None,
              band=None):
    """K1: (o [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq] fp32)."""
    global FWD_LAUNCHES
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")
    if runs_plain(q):
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window, scale=scale,
                                         softcap=softcap, band=band)
    _check_operands(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    out = _launch_fwd(_kernel("flash_fwd"), q, k, v, causal,
                      _band_ints(window, band), scale, softcap)
    FWD_LAUNCHES += 1
    return out


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check_operands(q, k, v, do)
    _check(do.shape == q.shape, f"do {tuple(do.shape)} must match q "
           f"{tuple(q.shape)}")
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, x in (("lse", lse), ("delta", delta)):
        _check(x.device == q.device and x.dtype == torch.float32
               and tuple(x.shape) == want and x.is_contiguous(),
               f"{name} must be contiguous fp32 {list(want)} on "
               f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 window=None, scale: Optional[float] = None,
                 softcap: Optional[float] = None, band=None):
    """K2: dq [B, Sq, Hq, D] in q's dtype from the forward's ``lse`` and
    ``delta = rowsum(do * o)`` ([B, Hq, Sq] fp32)."""
    global DQ_LAUNCHES
    if runs_plain(q):
        return flash_dq_reference(q, k, v, do, lse, delta, causal=causal,
                                  window=window, scale=scale,
                                  softcap=softcap, band=band)
    _check_bwd(q, k, v, do, lse, delta)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    dq = _launch_bwd(_kernel("flash_bwd_dq"), False, q, k, v, do, lse, delta,
                     causal, _band_ints(window, band), scale, softcap)
    DQ_LAUNCHES += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  window=None, scale: Optional[float] = None,
                  softcap: Optional[float] = None, band=None):
    """K3: (dk, dv) [B, Sk, Hkv, D] in k's dtype, summed over each kv
    head's group, from ``lse`` / ``delta`` as K2 takes them."""
    global DKV_LAUNCHES
    if runs_plain(q):
        return flash_dkv_reference(q, k, v, do, lse, delta, causal=causal,
                                   window=window, scale=scale,
                                   softcap=softcap, band=band)
    _check_bwd(q, k, v, do, lse, delta)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    grads = _launch_bwd(_kernel("flash_bwd_dkv"), True, q, k, v, do, lse,
                        delta, causal, _band_ints(window, band), scale,
                        softcap)
    DKV_LAUNCHES += 1
    return grads


def flash_bwd_with_stats(q, k, v, do, lse, delta, **kw):
    """K2 and K3 from caller-supplied softmax stats -> (dq, dk, dv).

    ``lse`` / ``delta`` ([B, Hq, Sq] fp32) are normally the forward's
    logsumexp and ``rowsum(do * o)``; ring attention passes the global
    (cross-chunk) stats to get each chunk pair's exact contribution.
    Keywords: ``causal``, ``window``, ``scale``, ``softcap``, ``band``."""
    return (flash_bwd_dq(q, k, v, do, lse, delta, **kw),
            *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))


@torch.library.custom_op("dtg_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, window: int, q_off: int, k_off: int,
                 scale: Optional[float],
                 softcap: Optional[float]) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 as one dispatcher operation, (o, lse): what a selective
    checkpoint policy sees and can keep (``ops/remat.py``), where a ctypes
    launch inside a Python function would be invisible to it. The band is
    the ``(window, q_off, k_off)`` triple of host ints."""
    return flash_fwd(q, k, v, causal=causal, band=(window, q_off, k_off),
                     scale=scale, softcap=softcap)


@flash_fwd_op.register_fake
def _(q, k, v, causal, window, q_off, k_off, scale, softcap):
    b, sq, hq, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, hq, sq), dtype=torch.float32))


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, window, q_off, k_off, scale, softcap = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.args = (causal, (window, q_off, k_off), scale, softcap)


def _flash_backward(ctx, do, dlse):
    """``delta = rowsum(do * o)`` in torch, then K2 and K3; the band, the
    flags and lse get no gradient."""
    q, k, v, o, lse = ctx.saved_tensors
    causal, band, scale, softcap = ctx.args
    if do.stride(-1) != 1:
        do = do.contiguous()
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float())
    dq, dk, dv = flash_bwd_with_stats(
        q, k, v, do, lse, delta.contiguous(), causal=causal, band=band,
        scale=scale, softcap=softcap)
    return dq, dk, dv, None, None, None, None, None, None


flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    scale: Optional[float] = None,
                    logit_softcap: Optional[float] = None) -> torch.Tensor:
    """Blockwise fused attention with the kernels' backward; returns
    [B, Sq, Hq, D] in q's dtype. ``window``: sliding-window attention
    (query i attends keys j with 0 <= i - j < window)."""
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")
    band = _band_ints(window, None)
    with checkpoint_name("flash_out", "flash_lse"):
        o, _ = flash_fwd_op(q, k, v, causal, *band, scale, logit_softcap)
    return o
