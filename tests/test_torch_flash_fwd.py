"""The flash forward's plain version at the kernel's own arithmetic, and the
choice of forward body, on the CPU.

The bf16 forward bodies walk the kv tiles with a running max, rescale l
and the fp32 accumulator as the max moves, and round each tile's p to
bf16 before P V. ``flash_attention_reference(round_p=True)`` does the same
at the Hopper body's tile of ``FWD_BLOCK_K`` keys, so that the card's
tests can hold the kernel to a tight bound. Here that version is held

- against the fp32 plain version for fp32 inputs within 1e-5 max abs (the
  ROADMAP's fp32 bound for attention: the running max only reorders fp32
  sums, and rounding to fp32 is no rounding);
- against the JAX Pallas forward in interpret mode for bf16 inputs within
  the bf16 bound of the card's tests, relative L2 1e-2 (rounding p moves
  each probability by at most 2**-9 relative, and the Pallas kernel rounds
  elsewhere);

over band / softcap / GQA cases, ragged lengths and a row with no live
key, with more keys than one kv tile so that the running max moves, at a
small head_dim (16). Inputs come from ``numpy.random.default_rng``,
rounded to bf16 once and given to both packages. ``_fwd_plan`` is pinned
for every (head_dim, dtype) the kernel takes, and so is its check against
the library's own table."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.ops import flash_attention as jfa
from distributed_training_guide_tpu_torch.ops import flash_attention as tfa
import torch_threads  # noqa: F401  (one torch thread a test process)

FP32_MAX_ABS = 1e-5
BF16_REL_L2 = 1e-2
B, D, BLOCK = 1, 16, 32

# name: (sq, sk, hq, hkv, causal, window, softcap, scale, (q_off, k_off))
CASES = {
    "gqa": (160, 160, 4, 2, True, None, None, None, None),
    "mha": (96, 96, 2, 2, True, None, None, None, None),
    "group4": (128, 128, 8, 2, True, None, None, None, None),
    "noncausal": (96, 160, 4, 2, False, None, None, None, None),
    "window40": (192, 192, 4, 2, True, 40, None, None, None),
    "softcap_scale": (128, 128, 4, 2, True, None, 50.0, 0.3, None),
    "band_offsets": (160, 160, 4, 2, True, 72, None, None, (16, 8)),
    "ragged_cross": (96, 224, 4, 2, False, None, None, None, None),
    "ragged_band": (96, 224, 4, 2, True, None, None, None, (128, 0)),
    "masked_rows": (128, 128, 4, 2, True, None, None, None, (0, 70)),
}


def _inputs(sq, sk, hq, hkv, seed):
    """q, k, v as bf16-exact fp32 numpy arrays; k scaled so that scores
    spread and the running max moves between kv tiles."""
    rng = np.random.default_rng(seed)
    shapes = ((B, sq, hq, D), (B, sk, hkv, D), (B, sk, hkv, D))
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    k = k * np.linspace(0.5, 2.0, sk, dtype=np.float32)[None, :, None, None]
    return [torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v)]


def _torch_kw(case):
    _, _, _, _, causal, window, softcap, scale, offs = case
    band = None if offs is None else tfa.pack_band(window, *offs)
    return dict(causal=causal, window=None if band is not None else window,
                scale=scale, softcap=softcap, band=band)


def _plain(q, k, v, dtype, kw, round_p):
    args = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return tfa.flash_attention_reference(*args, **kw, round_p=round_p)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_arithmetic_is_the_fp32_version_for_fp32_inputs(name):
    case = CASES[name]
    q, k, v = _inputs(*case[:4], seed=2)
    kw = _torch_kw(case)
    got = _plain(q, k, v, torch.float32, kw, True)
    want = _plain(q, k, v, torch.float32, kw, False)
    for label, g, w in zip(("o", "lse"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, label
        assert (g - w).abs().max().item() <= FP32_MAX_ABS, label


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_arithmetic_matches_jax_interpret_in_bf16(name):
    case = CASES[name]
    sq, sk, hq, hkv, causal, window, softcap, scale, offs = case
    q, k, v = _inputs(sq, sk, hq, hkv, seed=3)
    band = None if offs is None else jfa._pack_band(window, *offs)

    def bhsd(x):
        return jnp.asarray(x, dtype=jnp.bfloat16).transpose(0, 2, 1, 3)

    jo, jlse = jfa._flash_fwd(bhsd(q), bhsd(k), bhsd(v), causal,
                              None if band is not None else window, BLOCK,
                              BLOCK, True, scale=scale, softcap=softcap,
                              band=band)
    to, tlse = _plain(q, k, v, torch.bfloat16, _torch_kw(case), True)
    assert to.dtype == torch.bfloat16 and tlse.dtype == torch.float32
    for label, jx, tx in (
            ("o", jo.transpose(0, 2, 1, 3).astype(jnp.float32), to.float()),
            ("lse", jlse, tlse)):
        want, got = np.asarray(jx), tx.numpy()
        assert np.isfinite(got).all(), label
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_REL_L2, (label, err)


def test_kernel_arithmetic_walks_the_kv_tiles():
    """With bf16 inputs the tiled version differs from rounding p against
    the global max (its p are rounded at the running max of each tile),
    and a row whose max arrives in a later tile still sums to one."""
    q, k, v = _inputs(64, 192, 2, 2, seed=5)
    kw = dict(causal=False)
    ones = np.ones_like(v)
    o, _ = _plain(q, k, ones, torch.float32, kw, True)
    assert (o - 1).abs().max().item() <= FP32_MAX_ABS
    tiled, _ = _plain(q, k, v, torch.bfloat16, kw, True)
    once, _ = _plain(q, k, v, torch.bfloat16, kw, False)
    assert not torch.equal(tiled, once)


@pytest.mark.parametrize("d,dtype,body", [
    (64, torch.bfloat16, "wgmma"), (128, torch.bfloat16, "wgmma"),
    (256, torch.bfloat16, "wmma"), (64, torch.float32, "fma"),
    (128, torch.float32, "fma"), (256, torch.float32, "fma")])
def test_fwd_plan_is_the_launch_table(d, dtype, body):
    assert tfa._fwd_plan(d, dtype) == body


def _fake_library(codes):
    """A stand-in for the built forward library whose ``flash_fwd_body``
    answers from ``codes`` ((dtype code, D) -> body code)."""
    def flash_fwd_body(dtype, d):
        return codes[(dtype, d)]
    return types.SimpleNamespace(flash_fwd_body=flash_fwd_body)


_TABLE = {(code, d): tfa._BODIES.index(tfa._fwd_plan(d, dtype))
          for dtype, code in tfa._DTYPE_CODE.items() for d in tfa.HEAD_DIMS}


@pytest.mark.parametrize("change", [None, ((1, 64), 1), ((1, 256), 2),
                                    ((0, 128), 2), ((1, 128), -1)])
def test_fwd_body_table_check_refuses_a_library_that_disagrees(change):
    """The wrapper loads the forward library only if its table picks the
    body that ``_fwd_plan`` names at every (dtype, D)."""
    codes = dict(_TABLE)
    if change is None:
        tfa._check_body_table(_fake_library(codes), "flash_fwd")
        return
    key, body = change
    codes[key] = body
    with pytest.raises(RuntimeError, match="_fwd_plan names"):
        tfa._check_body_table(_fake_library(codes), "flash_fwd")
