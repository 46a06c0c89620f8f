"""The port's grouped matmul against the JAX package's on the CPU: the same
numpy inputs through JAX ``grouped_matmul`` (the Pallas kernels in
interpret mode, and the plain ``scan``) and through the port (on CPU
tensors: the plain versions behind the K5 / K6 wrappers and the autograd
Function), over empty groups, a tail past ``sum(group_sizes)``, an
all-empty input, one group taking every row and tile-unaligned widths.

Bounds: fp32 within 1e-5 of the largest magnitude of the reference's
output (the same fp32 sums in another order; K up to 128 of unit normals
makes outputs of magnitude ~30, so an absolute 1e-5 would ask for more
than fp32 rounding gives). bf16
operands: both sides form exact fp32 products of the bf16 values and sum
them in fp32 before rounding the result to bf16, so they differ by at
most one bf16 ulp, 2**-7 relative (8e-3 below)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.ops.grouped_matmul import (
    _tgmm_einsum as jtgmm_einsum)
from distributed_training_guide_tpu.ops.grouped_matmul import (
    grouped_matmul as jgrouped_matmul)
from distributed_training_guide_tpu_torch.ops import grouped_matmul as tgm
import torch_threads  # noqa: F401  (one torch thread a test process)

FP32_TOL = 1e-5
BF16_REL = 8e-3

# (m, k, n, sizes)
SHAPES = [
    (16, 8, 12, [3, 0, 9, 4]),
    (64, 16, 24, [10, 0, 0, 30, 24]),
    (32, 8, 8, [0, 0, 0]),                 # all groups empty: all zeros
    (40, 8, 8, [5, 5, 5, 5]),              # sum < m: a tail of zeros
    (33, 7, 9, [33, 0, 0, 0, 0, 0]),       # one group takes all, odd dims
    (256, 128, 96, [40, 0, 77, 3, 0, 60, 1, 50]),   # M 256, G 8, tail 25
]
IDS = [f"m{m}-k{k}-n{n}-g{len(s)}" for m, k, n, s in SHAPES]


def _inputs(m, k, n, g, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((g, k, n)).astype(np.float32))


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=FP32_TOL * scale, err_msg=err_msg)


def _jax_gmm(lhs, rhs, sizes, impl, **kw):
    fn = jax.jit(lambda l, r, s: jgrouped_matmul(
        l, r, s, impl=impl, block_rows=8, block_cols=8,
        interpret=True if impl == "pallas" else None, **kw))
    return fn(lhs, rhs, jnp.asarray(sizes, jnp.int32))


@pytest.mark.parametrize("m,k,n,sizes", SHAPES, ids=IDS)
@pytest.mark.parametrize("impl", ["auto", "scan", "einsum"])
def test_forward_matches_jax(impl, m, k, n, sizes):
    lhs, rhs = _inputs(m, k, n, len(sizes))
    want = {i: np.asarray(_jax_gmm(jnp.asarray(lhs), jnp.asarray(rhs), sizes,
                                   i)) for i in ("pallas", "scan")}
    before = tgm.GMM_LAUNCHES
    got = tgm.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs),
                             torch.tensor(sizes, dtype=torch.int32),
                             impl=impl)
    assert tgm.GMM_LAUNCHES == before         # CPU: the plain versions
    assert got.dtype == torch.float32 and got.shape == (m, n)
    for name, w in want.items():
        _close(got.numpy(), w, err_msg=f"vs JAX {name}")
    assert not got[sum(sizes):].any()


def _jax_grads(lhs, rhs, sizes, cot, impl):
    sz = jnp.asarray(sizes, jnp.int32)
    return jax.jit(jax.grad(
        lambda l, r: jnp.sum(jgrouped_matmul(
            l, r, sz, impl=impl, block_rows=8, block_cols=8,
            interpret=True if impl == "pallas" else None) * cot),
        argnums=(0, 1)))(jnp.asarray(lhs), jnp.asarray(rhs))


@pytest.mark.parametrize("m,k,n,sizes", SHAPES, ids=IDS)
def test_function_grads_match_jax_custom_vjp(m, k, n, sizes):
    """The autograd Function's CPU backward (d_lhs through the K5 wrapper
    against rhs^T, d_rhs through the K6 wrapper) against ``jax.grad``
    through the Pallas custom_vjp in interpret mode; tail rows and empty
    groups get exactly zero gradient.

    Where M is not a multiple of the 8-row tile (m33), the Pallas tgmm
    reads the last tile's out-of-bounds ``dy`` rows unmasked (it masks
    only ``lhs``), and interpret mode fills them with NaN, so its d_rhs is
    NaN: there d_rhs is held against ``jax.grad`` through the JAX scan
    instead (ROADMAP.md queue 3)."""
    lhs, rhs = _inputs(m, k, n, len(sizes), seed=1)
    cot = np.random.default_rng(2).standard_normal((m, n)).astype(np.float32)
    jdl, jdr = _jax_grads(lhs, rhs, sizes, cot, "pallas")
    if m % 8:
        assert not np.isfinite(np.asarray(jdr)).all()
        jdr = _jax_grads(lhs, rhs, sizes, cot, "scan")[1]
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    before = (tgm.GMM_LAUNCHES, tgm.TGMM_LAUNCHES)
    out = tgm.grouped_matmul(tl, tr, torch.tensor(sizes, dtype=torch.int32))
    torch.sum(out * torch.from_numpy(cot)).backward()
    assert (tgm.GMM_LAUNCHES, tgm.TGMM_LAUNCHES) == before
    _close(tl.grad.numpy(), jdl)
    _close(tr.grad.numpy(), jdr)
    assert not tl.grad[sum(sizes):].any()
    for g, size in enumerate(sizes):
        if size == 0:
            assert not tr.grad[g].any()


@pytest.mark.parametrize("m,k,n,sizes", SHAPES[:2] + SHAPES[-1:],
                         ids=IDS[:2] + IDS[-1:])
def test_bf16_operands_match_jax(m, k, n, sizes):
    """bf16 lhs and rhs: the bf16 result (and the fp32 one under
    ``preferred_element_type``) against the JAX Pallas kernel's."""
    lhs, rhs = _inputs(m, k, n, len(sizes), seed=3)
    jl, jr = (jnp.asarray(x).astype(jnp.bfloat16) for x in (lhs, rhs))
    tl, tr = (torch.from_numpy(x).to(torch.bfloat16) for x in (lhs, rhs))
    sz = torch.tensor(sizes, dtype=torch.int32)
    for pref in (None, jnp.float32):
        want = np.asarray(_jax_gmm(jl, jr, sizes, "pallas",
                                   preferred_element_type=pref), np.float32)
        got = tgm.grouped_matmul(
            tl, tr, sz, preferred_element_type=None if pref is None
            else torch.float32)
        assert got.dtype == (torch.bfloat16 if pref is None
                             else torch.float32)
        if pref is None:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=BF16_REL, atol=1e-6)
        else:
            _close(got.numpy(), want)


@pytest.mark.parametrize("m,k,n,sizes", SHAPES, ids=IDS)
def test_tgmm_plain_versions_match_jax(m, k, n, sizes):
    """K6's plain version and the one-hot einsum against the JAX
    ``_tgmm_einsum`` (fp32)."""
    lhs, _ = _inputs(m, k, n, 1, seed=4)
    dy = np.random.default_rng(5).standard_normal((m, n)).astype(np.float32)
    want = np.asarray(jtgmm_einsum(jnp.asarray(lhs), jnp.asarray(dy),
                                       jnp.asarray(sizes, jnp.int32),
                                       len(sizes), jnp.float32))
    args = (torch.from_numpy(lhs), torch.from_numpy(dy),
            torch.tensor(sizes, dtype=torch.int32), len(sizes),
            torch.float32)
    for fn in (tgm.tgmm, tgm.tgmm_einsum):
        got = fn(*args)
        assert got.shape == (len(sizes), k, n)
        _close(got.numpy(), want)


def test_shape_and_impl_validation():
    lhs, rhs = (torch.from_numpy(x) for x in _inputs(16, 8, 8, 4))
    sz = torch.tensor([4, 4, 4, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="expects lhs"):
        tgm.grouped_matmul(lhs[0], rhs, sz)
    with pytest.raises(ValueError, match="mismatch"):
        tgm.grouped_matmul(lhs, rhs[:, :4], sz)
    with pytest.raises(ValueError, match="ragged_dot"):
        tgm.grouped_matmul(lhs, rhs, sz, impl="ragged")
    with pytest.raises(ValueError, match="unknown grouped_matmul impl"):
        tgm.grouped_matmul(lhs, rhs, sz, impl="cuda")
