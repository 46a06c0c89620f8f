"""The flash backward's plain versions at the kernels' own arithmetic, and
the choice of backward body, on the CPU.

The bf16 backward bodies round p and ds to bf16 before the products that
follow (dq = ds k, dv = p^T dO, dk = ds^T q) and accumulate in fp32.
``flash_dq_reference`` / ``flash_dkv_reference`` take ``round_p_ds=True``
to do the same, so that the card's tests can hold the kernels to a tight
bound. Here that version is held

- bitwise equal to the fp32 plain version for fp32 inputs (rounding to
  fp32 is no rounding);
- against the JAX Pallas kernels in interpret mode for bf16 inputs (the
  Pallas kernels keep p and ds in fp32 and round only the outputs) within
  the bf16 bound of the card's tests, relative L2 1e-2: rounding p and ds
  moves each by at most 2**-9 relative, about 3e-3 in L2 over a sum (in
  ``tests/test_torch_flash_bwd_arith.py``);

over the band / softcap / GQA cases of ``tests/test_torch_flash.py`` and
ragged, unequal lengths, at llama-debug's head_dim (16). Inputs come from
``numpy.random.default_rng``, rounded to bf16 once and given to both
packages. ``_bwd_plan`` is pinned for every (head_dim, dtype) the kernels
take, and so are its check against the library's own table and the
wrapper's 16-byte rule for the tensor maps."""
import types

import numpy as np
import pytest
import torch

from distributed_training_guide_tpu_torch.ops import flash_attention as tfa
import torch_threads  # noqa: F401  (one torch thread a test process)

BF16_REL_L2 = 1e-2
B, D, BLOCK = 2, 16, 16

# name: (sq, sk, hq, hkv, causal, window, softcap, scale, (q_off, k_off))
CASES = {
    "gqa": (64, 64, 4, 2, True, None, None, None, None),
    "mha": (64, 64, 4, 4, True, None, None, None, None),
    "group4": (64, 64, 8, 2, True, None, None, None, None),
    "noncausal": (64, 64, 4, 2, False, None, None, None, None),
    "window16": (64, 64, 4, 2, True, 16, None, None, None),
    "softcap_scale": (64, 64, 4, 2, True, None, 50.0, 0.3, None),
    "band_offsets": (64, 64, 4, 2, True, 24, None, None, (16, 8)),
    "ragged_cross": (48, 80, 4, 2, False, None, None, None, None),
    "ragged_band": (48, 80, 8, 2, True, None, None, None, (32, 0)),
}


def _inputs(sq, sk, hq, hkv, seed):
    """q, k, v, dO as bf16-exact fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    shapes = ((B, sq, hq, D), (B, sk, hkv, D), (B, sk, hkv, D),
              (B, sq, hq, D))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .bfloat16().float().numpy() for s in shapes]


def _torch_kw(case):
    _, _, _, _, causal, window, softcap, scale, offs = case
    band = None if offs is None else tfa.pack_band(window, *offs)
    return dict(causal=causal, window=None if band is not None else window,
                scale=scale, softcap=softcap, band=band)


def _stats(q, k, v, do, kw):
    """lse and delta from the fp32 plain forward (numpy)."""
    o, lse = tfa.flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), **kw)
    delta = torch.einsum("bshd,bshd->bhs", torch.from_numpy(do), o)
    return lse.numpy(), delta.numpy()


def _plain(q, k, v, do, lse, delta, dtype, kw, round_p_ds):
    args = [torch.from_numpy(x).to(dtype) for x in (q, k, v, do)]
    args += [torch.from_numpy(lse), torch.from_numpy(delta)]
    return (tfa.flash_dq_reference(*args, **kw, round_p_ds=round_p_ds),
            *tfa.flash_dkv_reference(*args, **kw, round_p_ds=round_p_ds))


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_arithmetic_is_the_fp32_version_for_fp32_inputs(name):
    case = CASES[name]
    q, k, v, do = _inputs(*case[:4], seed=2)
    kw = _torch_kw(case)
    lse, delta = _stats(q, k, v, do, kw)
    got = _plain(q, k, v, do, lse, delta, torch.float32, kw, True)
    want = _plain(q, k, v, do, lse, delta, torch.float32, kw, False)
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w), label


@pytest.mark.parametrize("d,dtype,body", [
    (64, torch.bfloat16, "wgmma"), (128, torch.bfloat16, "wgmma"),
    (256, torch.bfloat16, "wmma"), (64, torch.float32, "fma"),
    (128, torch.float32, "fma"), (256, torch.float32, "fma")])
def test_bwd_plan_is_the_launch_table(d, dtype, body):
    assert tfa._bwd_plan(d, dtype) == body


def test_tma_operands_copy_only_what_a_tensor_map_cannot_read():
    """A [B, S, H, D] operand needs its base and its (b, s, h) strides on
    16 bytes. An operand that fails is copied to a contiguous tensor
    (counted), one that passes is the operand itself."""
    q = torch.zeros(2, 50, 4, 64, dtype=torch.bfloat16)
    head_slice = torch.zeros(2, 50, 5, 64, dtype=torch.bfloat16)[:, :, 1:]
    offset = torch.zeros(2 * 50 * 4 * 64 + 4,
                         dtype=torch.bfloat16)[4:].view(2, 50, 4, 64)
    odd_heads = torch.zeros(2, 50, 4, 68, dtype=torch.bfloat16)[..., :64]
    assert tfa._tma_ready(q)
    assert tfa._tma_ready(head_slice)       # base + 128 bytes
    assert not tfa._tma_ready(offset)       # base + 8 bytes
    assert not tfa._tma_ready(odd_heads)    # head stride 136 bytes
    before = tfa.ALIGN_COPIES
    out = tfa._tma_operands(q, head_slice, offset, odd_heads)
    assert tfa.ALIGN_COPIES - before == 2
    assert out[0] is q and out[1] is head_slice
    for x, orig in zip(out[2:], (offset, odd_heads)):
        assert x is not orig and x.is_contiguous() and torch.equal(x, orig)
        assert tfa._tma_ready(x)


def _fake_library(codes):
    """A stand-in for the built library whose ``flash_bwd_body`` answers
    from ``codes`` ((dtype code, D) -> body code)."""
    def flash_bwd_body(dtype, d):
        return codes[(dtype, d)]
    return types.SimpleNamespace(flash_bwd_body=flash_bwd_body)


_TABLE = {(code, d): tfa._BODIES.index(tfa._bwd_plan(d, dtype))
          for dtype, code in tfa._DTYPE_CODE.items() for d in tfa.HEAD_DIMS}


@pytest.mark.parametrize("change", [None, ((1, 128), 1), ((0, 64), 2),
                                    ((1, 256), -1)])
def test_body_table_check_refuses_a_library_that_disagrees(change):
    """The wrapper loads the backward library only if its table picks the
    body that ``_bwd_plan`` names at every (dtype, D): a library whose
    table differs anywhere is refused before any launch."""
    codes = dict(_TABLE)
    if change is None:
        tfa._check_body_table(_fake_library(codes))
        return
    key, body = change
    codes[key] = body
    with pytest.raises(RuntimeError, match="_bwd_plan names"):
        tfa._check_body_table(_fake_library(codes))
