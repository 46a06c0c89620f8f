"""The port's ops against the JAX package's, on the CPU, at small sizes:
RoPE (all six rope_scaling types), the einsum attention, int8 KV
quantization, and the paged attend — the port's plain version of the CUDA
kernel against the JAX Pallas kernel (interpret mode) and the JAX gather
path, scatter included, over shuffled page tables, trash-page tails and
``n_valid`` pad tails. Inputs come from numpy seeds and go through both."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.ops import attention as jattn
from distributed_training_guide_tpu.ops import rope as jrope
from distributed_training_guide_tpu.serve import kv_pages as jkv
from distributed_training_guide_tpu.train.precision import Quantized as JQ
from distributed_training_guide_tpu_torch.ops import attention as tattn
from distributed_training_guide_tpu_torch.ops import paged_decode as tpd
from distributed_training_guide_tpu_torch.ops import rope as trope
from distributed_training_guide_tpu_torch.serve import kv_pages as tkv
from distributed_training_guide_tpu_torch.train.precision import Quantized
import torch_threads  # noqa: F401  (one torch thread a test process)

ROPE_CASES = {
    "default": None,
    "linear": {"rope_type": "linear", "factor": 2.0},
    "dynamic": {"rope_type": "dynamic", "factor": 2.0},
    "yarn": {"rope_type": "yarn", "factor": 4.0,
             "original_max_position_embeddings": 32},
    "longrope": {"rope_type": "longrope",
                 "short_factor": [1.0 + 0.1 * i for i in range(8)],
                 "long_factor": [2.0 + 0.2 * i for i in range(8)],
                 "original_max_position_embeddings": 32},
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 32},
}


@pytest.mark.parametrize("name", sorted(ROPE_CASES))
def test_rope_matches_jax(name):
    """Bound 1e-6: both compute the same fp32 formulas; the gap is the
    last-ulp difference of pow/cos/sin between the two libraries, at
    positions up to 80 (past every type's original context here)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(40), np.arange(40, 80)]).astype(np.int32)
    scaling = trope.freeze_rope_scaling(ROPE_CASES[name])
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           10000.0, scaling, 64)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                            jrope.freeze_rope_scaling(ROPE_CASES[name]), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(window=5), dict(scale=0.3),
                                dict(logit_softcap=4.0),
                                dict(window=3, scale=0.2, logit_softcap=20.0)],
                         ids=lambda kw: "-".join(kw) or "causal")
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (6, 1)])
def test_xla_attention_matches_jax(kw, hq, hkv):
    """GQA / window / scale / softcap, fp32: bound 1e-5 (reduction order)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 9, hq, 8)).astype(np.float32)
    k = rng.standard_normal((2, 9, hkv, 8)).astype(np.float32)
    v = rng.standard_normal((2, 9, hkv, 8)).astype(np.float32)
    got = tattn.multihead_attention(*map(torch.from_numpy, (q, k, v)),
                                    impl="xla", **kw)
    want = jattn.multihead_attention(*map(jnp.asarray, (q, k, v)),
                                     impl="xla", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_flash_impl_is_not_ported():
    """Named when K1 was still to port; it is ported now. ``impl="flash"``
    on a CPU tensor runs the kernels' plain version and launches nothing;
    ``auto`` still takes the einsum path there."""
    from distributed_training_guide_tpu_torch.ops import flash_attention

    x = torch.randn(1, 128, 2, 64, generator=torch.Generator().manual_seed(0))
    before = flash_attention.FWD_LAUNCHES
    out = tattn.multihead_attention(x, x, x, impl="flash")
    ref, _ = flash_attention.flash_attention_reference(x, x, x)
    assert torch.equal(out, ref)
    assert flash_attention.FWD_LAUNCHES == before
    assert torch.equal(tattn.multihead_attention(x, x, x),
                       tattn._xla_attention(x, x, x, True, None, None))


def test_quantize_kv_bitwise():
    """Payload and scales bit for bit: same fp32 ops, both round half to
    even (exact .5 ties included)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = np.linspace(-127, 127, 16) / 2.0      # exact .5 ties
    x[1, 1, 1] = 0.0                                   # all-zero vector
    got = tkv.quantize_kv(torch.from_numpy(x))
    want = jkv.quantize_kv(jnp.asarray(x))
    assert np.array_equal(got.q.numpy(), np.asarray(want.q))
    assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))
    back = tkv.dequantize_kv(got)
    assert np.array_equal(back.numpy(),
                          np.asarray(jkv.dequantize_kv(want)))


def _paged_case(rng, *, t, groups, quantized):
    """Shuffled physical pages, 0-filled (trash) table tails, lengths at a
    page start, zero, mid-page and near the end, and n_valid pad tails."""
    s, m, page, hkv, d, n_pages = 4, 4, 4, 2, 8, 20
    phys = rng.permutation(np.arange(1, n_pages))
    lengths = np.array([4, 0, 6, 16 - t], np.int32)
    tables = np.zeros((s, m), np.int32)
    for i in range(s):
        own = min(m, (lengths[i] + t - 1) // page + 1)
        tables[i, :own] = phys[i * m:i * m + own]
    n_valid = np.array([t, max(1, t - 2), t, max(1, t - 1)], np.int32)
    kp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    q = rng.standard_normal((s, t, hkv * groups, d)).astype(np.float32)
    kn = rng.standard_normal((s, t, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((s, t, hkv, d)).astype(np.float32)
    if quantized:
        kq, vq = jkv.quantize_kv(jnp.asarray(kp)), jkv.quantize_kv(
            jnp.asarray(vp))
        jpools = (kq, vq)
        tpools = tuple(Quantized(q=torch.from_numpy(np.array(p.q)),
                                 scale=torch.from_numpy(np.array(p.scale)))
                       for p in jpools)
    else:
        jpools = (jnp.asarray(kp), jnp.asarray(vp))
        tpools = (torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()))
    return dict(q=q, kn=kn, vn=vn, tables=tables, lengths=lengths,
                n_valid=n_valid, jpools=jpools, tpools=tpools)


def _leaves(pool):
    return list(pool) if isinstance(pool, (Quantized, JQ)) else [pool]


def paged_grid(groups: int) -> list:
    """(t, groups, window, softcap, quantized) of the paged-attend grid at
    ``groups`` q heads a kv head (1: ``tests/test_torch_ops_paged.py``)."""
    return list(itertools.product([1, 3, 8], [groups], [None, 6],
                                  [None, 5.0], [False, True]))


def paged_ids(grid: list) -> list:
    return [f"T{t}-g{g}-w{w}-c{c}-{'int8' if qz else 'fp32'}"
            for t, g, w, c, qz in grid]


def check_paged_attend(t, groups, window, softcap, quantized):
    """The port's paged_attend on CPU tensors (scatter, then the plain
    version of the CUDA kernel) against the JAX Pallas kernel in
    interpret mode and the JAX gather path. Bound 1e-5 for fp32 AND int8
    pools: every path dequantizes the same int8 x fp32-scale values in
    fp32, so only the reduction order differs. The updated pools must be
    bitwise equal outside the trash page (the scatter is a copy; int8
    quantization is bitwise)."""
    rng = np.random.default_rng(100 * t + 10 * groups + int(quantized))
    c = _paged_case(rng, t=t, groups=groups, quantized=quantized)
    kw = dict(window=window, softcap=softcap)
    attn, (tk, tv) = tkv.paged_attend(
        torch.from_numpy(c["q"]), torch.from_numpy(c["kn"]),
        torch.from_numpy(c["vn"]), *c["tpools"],
        torch.from_numpy(c["tables"]), torch.from_numpy(c["lengths"]),
        n_valid=torch.from_numpy(c["n_valid"]), **kw)
    for impl in ("flash", "xla"):
        jattn_out, (jk, jv) = jkv.paged_attend(
            jnp.asarray(c["q"]), jnp.asarray(c["kn"]), jnp.asarray(c["vn"]),
            *c["jpools"], jnp.asarray(c["tables"]),
            jnp.asarray(c["lengths"]), impl=impl,
            n_valid=jnp.asarray(c["n_valid"]), **kw)
        np.testing.assert_allclose(attn.numpy(), np.asarray(jattn_out),
                                   rtol=0, atol=1e-5, err_msg=impl)
        # page 0 (trash) takes the pad tails' writes in an unspecified
        # order; every other page must match bit for bit
        for got, want in zip(_leaves(tk) + _leaves(tv),
                             _leaves(jk) + _leaves(jv)):
            assert np.array_equal(got.numpy()[1:], np.asarray(want)[1:]), impl




PAGED_GRID = paged_grid(2)


@pytest.mark.parametrize("t,groups,window,softcap,quantized", PAGED_GRID,
                         ids=paged_ids(PAGED_GRID))
def test_paged_attend_matches_jax_kernel_and_gather(t, groups, window,
                                                    softcap, quantized):
    check_paged_attend(t, groups, window, softcap, quantized)


def test_reference_fully_masked_rows_are_zero_and_wrapper_validates():
    """A row whose window holds no key attends nothing: the kernel's
    safe_l gives 0, and so must its plain version. The wrapper refuses a
    half-quantized pool and a zero window before anything runs."""
    q = torch.ones(1, 1, 2, 8)
    kp = torch.ones(3, 8, 1, 8)
    tables = torch.tensor([[1]], dtype=torch.int32)
    lengths = torch.tensor([0], dtype=torch.int32)
    out = tpd.paged_attend_reference(q, kp, kp, tables, lengths)
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="both k_scale"):
        tpd.paged_flash_attend(q, kp, kp, tables, lengths,
                               k_scale=torch.ones(3, 8, 1))
    with pytest.raises(ValueError, match="window"):
        tpd.paged_flash_attend(q, kp, kp, tables, lengths, window=0)
    assert tpd.paged_decode_eligible(128, 16)
    assert not tpd.paged_decode_eligible(16, 16)     # head_dim
    assert tpd.paged_decode_eligible(128, 4)         # any page to 256
    assert not tpd.paged_decode_eligible(128, 512)   # page


def test_xla_impl_refused_for_cuda_tensors_is_a_device_rule():
    """The gather path is a CPU path: asking paged_attend for it with a
    CUDA tensor raises (checked through the device predicate, since this
    machine has no card)."""
    assert not torch.zeros(1).is_cuda
    with pytest.raises(ValueError, match="impl"):
        tkv.paged_attend(torch.zeros(1, 1, 2, 8), torch.zeros(1, 1, 1, 8),
                         torch.zeros(1, 1, 1, 8), torch.zeros(2, 8, 1, 8),
                         torch.zeros(2, 8, 1, 8),
                         torch.zeros(1, 1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), impl="bogus")
