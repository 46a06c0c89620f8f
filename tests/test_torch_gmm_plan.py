"""The grouped matmul's choice of body, the Hopper bodies' tile schedule and
the split bodies' arithmetic, on the CPU.

``_gmm_plan`` names K5's body from the operands' dtypes, strides and
16-byte alignment alone; it is pinned here for every dtype pair and every
alignment and stride case, and the load-time check of the library's own
table (``gmm_body``) is shown to refuse a table that departs from it in
any one of its conditions.

The split body (the backward's d_lhs: fp32 dy against the bf16 rhs^T)
splits dy into bf16 hi and lo and sums two bf16 products in fp32;
``gmm_reference(split_lhs=True)`` is that arithmetic in plain PyTorch,
held against the JAX ``_gmm_scan`` on the same fp32 dy and bf16 rhs^T
within 1e-5 of the output's largest magnitude (hi + lo misses each dy by
at most 2**-16 of it, and the rest is fp32 summation order).

``tile_schedule`` is the arithmetic that the Hopper body's blocks do on
the card: group_sizes -> (group, first row, rows) tiles of BM rows, each
inside one group, then the zero tiles from the total up. Hypothesis shows
that every row below the total has exactly one owner (its own group), that
every row from the total up is zeroed exactly once, and that the tiles fit
the static grid of ceil(M / BM) + G row slots, over empty groups, one
group taking every row, a tail past the total, sizes past M and up to 1024
groups. A product run tile by tile through that schedule is held against
the JAX ``_gmm_scan``: in fp32 within 1e-5 of the output's largest
magnitude (the same products summed in another order), with bf16
operands within 1e-2 relative L2 (each side rounds its fp32 sum to bf16
once: half an ulp, 2**-9, per element). Inputs come from
``numpy.random.default_rng`` and go to both packages.

K6 (the transposed product d_rhs[g] = lhs_g^T dy_g) likewise: ``_tgmm_plan``
is pinned for every dtype pair, alignment, row and column stride case and
output rows on and off 16 bytes, the
library's ``tgmm_body`` is refused if it departs from it in any one
condition, and ``tgmm_reference(split_dy=True)``, the split body's
arithmetic (fp32 dy as bf16 hi + lo against the exact bf16 lhs), is held
against the JAX ``_tgmm_einsum`` within 1e-5 of the output's largest
magnitude over empty groups, a tail past the total and widths off every
tile."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_training_guide_tpu.ops.grouped_matmul import (
    _gmm_scan, _tgmm_einsum)
from distributed_training_guide_tpu_torch.ops import grouped_matmul as tgm
import torch_threads  # noqa: F401  (one torch thread a test process)

BF = torch.bfloat16
F32 = torch.float32


def _lhs(k=64, off=0, m=16, dtype=BF):
    """[m, k] at an element offset ``off`` from an aligned allocation."""
    return torch.zeros(m * k + off, dtype=dtype)[off:].view(m, k)


def _rhs(k=64, n=64, off=0, dtype=BF, pad_n=0, pad_k=0):
    """[2, k, n] at an element offset, its rows (pad_n) or groups (pad_k)
    strided past their extent."""
    full = torch.zeros(2 * (k + pad_k) * (n + pad_n) + off, dtype=dtype)
    return full[off:].view(2, k + pad_k, n + pad_n)[:, :k, :n]


PLAN_CASES = {
    "bf16 aligned": (_lhs(), _rhs(), "wgmma"),
    "fp32 lhs": (_lhs(dtype=torch.float32), _rhs(), "fma"),
    "fp32 rhs": (_lhs(), _rhs(dtype=torch.float32), "fma"),
    "fp32 both": (_lhs(dtype=torch.float32), _rhs(dtype=torch.float32),
                  "fma"),
    "lhs base +16 bytes": (_lhs(off=8), _rhs(), "wgmma"),
    "lhs base +2 bytes": (_lhs(off=1), _rhs(), "wmma"),
    "rhs base +2 bytes": (_lhs(), _rhs(off=1), "wmma"),
    "lhs row stride 200 bytes": (_lhs(k=100), _rhs(k=100, n=72), "wmma"),
    "rhs row stride 136 bytes": (_lhs(), _rhs(pad_n=4), "wmma"),
    "rhs group stride on 16": (_lhs(), _rhs(pad_k=4), "wgmma"),
    "rhs group stride off 16": (_lhs(), torch.zeros(
        2 * (64 * 64 + 4), dtype=BF).as_strided((2, 64, 64),
                                                (64 * 64 + 4, 64, 1)),
        "wmma"),
    "rhs^T": (_lhs(), _rhs().transpose(1, 2), "wmma"),
    "fp32 dy against rhs^T": (_lhs(dtype=torch.float32),
                              _rhs().transpose(1, 2), "split"),
    "N 72": (_lhs(), _rhs(n=72), "wgmma"),
    "fp32 dy base +16 bytes": (_lhs(off=4, dtype=torch.float32),
                               _rhs().transpose(1, 2), "split"),
    "fp32 dy base +4 bytes": (_lhs(off=1, dtype=torch.float32),
                              _rhs().transpose(1, 2), "fma"),
    "fp32 dy row stride 264 bytes": (
        torch.zeros(16, 66)[:, :64], _rhs().transpose(1, 2), "fma"),
    "rhs^T base +2 bytes": (_lhs(dtype=torch.float32),
                            _rhs(off=1).transpose(1, 2), "fma"),
    "rhs^T row stride 136 bytes": (_lhs(dtype=torch.float32),
                                   _rhs(pad_n=4).transpose(1, 2), "fma"),
    "rhs^T group stride on 16": (_lhs(dtype=torch.float32),
                                 _rhs(pad_k=4).transpose(1, 2), "split"),
    "rhs^T group stride off 16": (_lhs(dtype=torch.float32), torch.zeros(
        2 * (64 * 64 + 4), dtype=BF).as_strided(
            (2, 64, 64), (64 * 64 + 4, 64, 1)).transpose(1, 2), "fma"),
    "qwen3 d_lhs (K 768, N 2048)": (
        _lhs(k=768, dtype=torch.float32),
        _rhs(k=2048, n=768).transpose(1, 2), "split"),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_gmm_plan_names_the_body(name):
    lhs, rhs, body = PLAN_CASES[name]
    assert tgm._gmm_plan(lhs, rhs) == body


def _c_tgmm_body_for(drop=None):
    """The library's ``tgmm_body_for`` rule written out in Python, with the
    condition ``drop`` left out (a mutant of K6's table)."""
    def tgmm_body(ldt, ddt, odt, n, lhs, ls, dy, ds):
        if drop == "split_to_fma":
            return 0
        split = {"lhs_dtype": ldt == 1, "dy_dtype": ddt == 0,
                 "lhs_base": lhs % 16 == 0, "dy_base": dy % 16 == 0,
                 "l_sk": ls[1] == 1, "d_sn": ds[1] == 1,
                 "l_sm": ls[0] * 2 % 16 == 0, "d_sm": ds[0] * 4 % 16 == 0,
                 "out_rows": n * (2 if odt == 1 else 4) % 16 == 0}
        split.pop(drop, None)
        return 1 if all(split.values()) else 0
    return tgmm_body


def _c_body_for(drop=None, tgmm_drop=None):
    """The library's ``body_for`` rule written out in Python, with the
    condition ``drop`` left out (a mutant of the table), beside K6's rule
    (``tgmm_drop`` left out)."""
    def gmm_body(ldt, rdt, lhs, l_sm, rhs, rs):
        if rdt != 1 and drop != "rhs_dtype":
            return 0
        if ldt == 0 and drop != "lhs_dtype":
            if drop == "split_to_fma":
                return 0
            split = {"split_lhs_base": lhs % 16 == 0,
                     "split_l_sm": l_sm * 4 % 16 == 0,
                     "split_rhs_base": rhs % 16 == 0,
                     "split_r_sk": rs[1] == 1,
                     "split_r_sg": rs[0] * 2 % 16 == 0,
                     "split_r_sn": rs[2] * 2 % 16 == 0}
            split.pop(drop, None)
            return 3 if all(split.values()) else 0
        if drop == "wgmma_to_wmma":
            return 1
        tma = {"lhs_base": lhs % 16 == 0, "l_sm": l_sm * 2 % 16 == 0,
               "rhs_base": rhs % 16 == 0, "r_sn": rs[2] == 1,
               "r_sg": rs[0] * 2 % 16 == 0, "r_sk": rs[1] * 2 % 16 == 0}
        tma.pop(drop, None)
        return 2 if all(tma.values()) else 1
    return types.SimpleNamespace(gmm_body=gmm_body,
                                 tgmm_body=_c_tgmm_body_for(tgmm_drop))


def test_body_table_check_passes_the_library_rule():
    tgm._check_body_table(_c_body_for())


@pytest.mark.parametrize("drop", ["lhs_dtype", "rhs_dtype", "lhs_base",
                                  "l_sm", "rhs_base", "r_sn", "r_sg", "r_sk",
                                  "wgmma_to_wmma", "split_lhs_base",
                                  "split_l_sm", "split_rhs_base",
                                  "split_r_sk", "split_r_sg", "split_r_sn",
                                  "split_to_fma"])
def test_body_table_check_refuses_a_library_that_disagrees(drop):
    """Each condition of the rule matters for some case of
    ``_plan_cases``: a table without it is refused before any launch."""
    with pytest.raises(RuntimeError, match="_gmm_plan names"):
        tgm._check_body_table(_c_body_for(drop))


def _check_schedule(sizes, m, bm):
    tiles = tgm.tile_schedule(sizes, m, bm)
    offs = np.concatenate([[0], np.cumsum(np.maximum(sizes, 0))])
    total = min(int(offs[-1]), m)
    owner = np.full(m, -2)
    zeroed = np.zeros(m, dtype=int)
    assert len(tiles) <= -(-m // bm) + len(sizes)        # the static grid
    for g, r0, rows in tiles:
        assert 0 < rows <= bm and 0 <= r0 and r0 + rows <= m
        if g < 0:
            zeroed[r0:r0 + rows] += 1
            continue
        assert offs[g] <= r0 and r0 + rows <= min(offs[g + 1], m)
        assert (r0 - offs[g]) % bm == 0
        assert (owner[r0:r0 + rows] == -2).all()
        owner[r0:r0 + rows] = g
    for r in range(total):
        g = owner[r]
        assert g >= 0 and offs[g] <= r < offs[g + 1], r
    assert (owner[total:] == -2).all()
    assert (zeroed[:total] == 0).all() and (zeroed[total:] == 1).all()


@settings(max_examples=300, deadline=None)
@given(st.data())
def test_tile_schedule_owns_every_row_once(data):
    g = data.draw(st.integers(1, 1024), label="groups")
    kind = data.draw(st.sampled_from(["random", "sparse", "one", "empty"]))
    m = data.draw(st.integers(0, 3000), label="m")
    if kind == "one":
        sizes = [0] * g
        sizes[data.draw(st.integers(0, g - 1))] = m
    elif kind == "empty":
        sizes = [0] * g
    else:
        hi = 3 if kind == "sparse" else max(1, 2 * m // g + 1)
        sizes = data.draw(st.lists(st.integers(-2, hi), min_size=g,
                                   max_size=g), label="sizes")
    for bm in (64, 128):
        _check_schedule(sizes, m, bm)


def test_tile_schedule_examples():
    assert tgm.tile_schedule([3, 0, 200, 5], 300, 128) == [
        (0, 0, 3), (2, 3, 128), (2, 131, 72), (3, 203, 5), (-1, 208, 92)]
    assert tgm.tile_schedule([500], 300, 128) == [
        (0, 0, 128), (0, 128, 128), (0, 256, 44)]
    assert tgm.tile_schedule([], 70, 64) == [(-1, 0, 64), (-1, 64, 6)]
    assert tgm.tile_block_rows(256) == 64 and tgm.tile_block_rows(257) == 128


def _scheduled_gmm(lhs, rhs, sizes, out_dtype):
    """K5 tile by tile through ``tile_schedule``: each tile's rows times its
    group's rhs with an fp32 sum, zero tiles zero."""
    m = lhs.shape[0]
    out = torch.full((m, rhs.shape[2]), float("nan"))
    for g, r0, rows in tgm.tile_schedule(sizes, m, tgm.tile_block_rows(m)):
        out[r0:r0 + rows] = (0.0 if g < 0
                             else lhs[r0:r0 + rows].float() @ rhs[g].float())
    return out.to(out_dtype)


GMM_CASES = {
    "decode": (64, 48, 40, [1 if i % 2 else 0 for i in range(64)] + [0] * 64),
    "ragged": (300, 40, 24, [40, 0, 77, 3, 0, 60, 1, 50, 0, 44]),
    "tail": (520, 32, 16, [7, 200, 0, 13]),
    "one-group": (260, 24, 40, [0, 260, 0]),
    "all-empty": (96, 16, 8, [0, 0, 0, 0]),
    "past-m": (200, 16, 8, [150, 100, 30]),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", list(GMM_CASES))
def test_scheduled_product_matches_jax_gmm_scan(name, dtype):
    m, k, n, sizes = GMM_CASES[name]
    rng = np.random.default_rng(m + k)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "fp32"
                else (BF, jnp.bfloat16))
    lhs, rhs = (torch.from_numpy(x).to(tdt).float().numpy()
                for x in (lhs, rhs))
    got = _scheduled_gmm(torch.from_numpy(lhs).to(tdt),
                         torch.from_numpy(rhs).to(tdt), sizes, tdt)
    want = np.asarray(_gmm_scan(
        jnp.asarray(lhs, jdt), jnp.asarray(rhs, jdt),
        jnp.asarray(sizes, jnp.int32), jdt).astype(jnp.float32))
    got = got.float().numpy()
    assert np.isfinite(got).all()
    total = min(sum(sizes), m)
    assert not got[total:].any()
    if total == 0:
        return
    if dtype == "fp32":
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, err
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 1e-2, err


def test_plan_cases_cover_every_dtype_pair():
    pairs = {(lhs.dtype, rhs.dtype) for lhs, rhs in tgm._plan_cases()}
    assert pairs == {(a, b) for a in (BF, torch.float32)
                     for b in (BF, torch.float32)}


def test_plan_cases_take_every_body():
    bodies = {tgm._gmm_plan(lhs, rhs) for lhs, rhs in tgm._plan_cases()}
    assert bodies == {"fma", "wmma", "wgmma", "split"}


@pytest.mark.parametrize("name", list(GMM_CASES))
def test_split_reference_matches_jax_gmm_scan_on_fp32_dy(name):
    """The backward's d_lhs form: fp32 dy [M, N] against rhs^T, a view of
    a bf16 [G, K, N] stack, through the split body's arithmetic, against
    the JAX scan on the same operands; and the split alone moves the
    result by no more than the same bound."""
    m, k, n, sizes = GMM_CASES[name]
    rng = np.random.default_rng(3 * m + n)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    rhs = torch.from_numpy(rng.standard_normal((len(sizes), k, n)).astype(
        np.float32)).to(BF)
    rt = rhs.transpose(1, 2)
    got = tgm.gmm_reference(torch.from_numpy(dy), rt,
                            torch.tensor(sizes, dtype=torch.int32),
                            torch.float32, split_lhs=True)
    want = np.asarray(_gmm_scan(
        jnp.asarray(dy), jnp.asarray(rt.float().numpy(), jnp.bfloat16),
        jnp.asarray(sizes, jnp.int32), jnp.float32))
    plain = tgm.gmm_reference(torch.from_numpy(dy), rt.float(),
                              torch.tensor(sizes, dtype=torch.int32),
                              torch.float32)
    got = got.numpy()
    total = min(sum(sizes), m)
    assert got.shape == (m, k) and np.isfinite(got).all()
    assert not got[total:].any()
    if total == 0:
        return
    scale = np.abs(want).max()
    for ref in (want, plain.numpy()):
        err = np.abs(got - ref).max() / scale
        assert err <= 1e-5, (name, err)


# K6: (lhs, dy, out dtype, body) for bf16 lhs against fp32 dy and every
# other dtype pair, bases, row strides and column strides on and off 16
# bytes, output rows (N values) on and off 16 bytes
def _dy(n=32, off=0, m=16, dtype=torch.float32):
    return torch.zeros(m * n + off, dtype=dtype)[off:].view(m, n)


TGMM_PLAN_CASES = {
    "bf16 lhs, fp32 dy": (_lhs(), _dy(), BF, "split"),
    "fp32 lhs": (_lhs(dtype=torch.float32), _dy(), BF, "fma"),
    "bf16 dy": (_lhs(), _dy(dtype=BF), BF, "fma"),
    "fp32 lhs, bf16 dy": (_lhs(dtype=torch.float32), _dy(dtype=BF), BF, "fma"),
    "lhs base +16 bytes": (_lhs(off=8), _dy(), BF, "split"),
    "lhs base +2 bytes": (_lhs(off=1), _dy(), BF, "fma"),
    "dy base +16 bytes": (_lhs(), _dy(off=4), BF, "split"),
    "dy base +4 bytes": (_lhs(), _dy(off=1), BF, "fma"),
    "lhs row stride 200 bytes": (_lhs(k=100), _dy(), BF, "fma"),
    "lhs row stride 144 bytes": (_lhs(k=72)[:, :64], _dy(), BF, "split"),
    "dy row stride 136 bytes": (_lhs(), _dy(n=34)[:, :32], BF, "fma"),
    "dy row stride 144 bytes": (_lhs(), _dy(n=36)[:, :32], BF, "split"),
    "lhs column stride 2": (_lhs(k=128)[:, ::2], _dy(), BF, "fma"),
    "dy column stride 2": (_lhs(), _dy(n=64)[:, ::2], BF, "fma"),
    "qwen3 gate (K 2048, N 768)": (_lhs(k=2048), _dy(n=768), BF, "split"),
    "qwen3 down (K 768, N 2048)": (_lhs(k=768), _dy(n=2048), BF, "split"),
    "fp32 out": (_lhs(), _dy(), F32, "split"),
    "bf16 out rows 72 bytes (N 36)": (_lhs(), _dy(n=36), BF, "fma"),
    "fp32 out rows 144 bytes (N 36)": (_lhs(), _dy(n=36), F32, "split"),
    "fp32 out rows 136 bytes (N 34)": (_lhs(), _dy(n=36)[:, :34], F32, "fma"),
    "bf16 out rows 140 bytes (N 70)": (_lhs(), _dy(n=72)[:, :70], BF, "fma"),
}


@pytest.mark.parametrize("name", list(TGMM_PLAN_CASES))
def test_tgmm_plan_names_the_body(name):
    lhs, dy, out_dtype, body = TGMM_PLAN_CASES[name]
    assert tgm._tgmm_plan(lhs, dy, out_dtype) == body


def test_tgmm_plan_cases_take_both_bodies():
    cases = tgm._tgmm_plan_cases()
    assert {tgm._tgmm_plan(*case) for case in cases} == {"fma", "split"}
    assert {(lhs.dtype, dy.dtype) for lhs, dy, _ in cases} == {
        (a, b) for a in (BF, F32) for b in (BF, F32)}
    assert {tgm._tgmm_plan(*case) for case in cases if case[2] == F32} == {
        "fma", "split"}


@pytest.mark.parametrize("drop", ["lhs_dtype", "dy_dtype", "lhs_base",
                                  "dy_base", "l_sk", "d_sn", "l_sm", "d_sm",
                                  "out_rows", "split_to_fma"])
def test_tgmm_body_table_check_refuses_a_library_that_disagrees(drop):
    """Each condition of K6's rule matters for some case of
    ``_tgmm_plan_cases``: a table without it is refused before any
    launch."""
    with pytest.raises(RuntimeError, match="_tgmm_plan names"):
        tgm._check_body_table(_c_body_for(tgmm_drop=drop))


# (m, k, n, sizes): empty groups, a tail past the total, widths off the
# 128-wide tiles and the 64-row chunks, one group taking every row
TGMM_CASES = {
    "ragged": (300, 72, 40, [40, 0, 77, 3, 0, 60, 1, 50, 0, 44]),
    "tail": (520, 136, 24, [7, 200, 0, 13]),
    "one-group": (260, 40, 136, [0, 260, 0]),
    "all-empty": (96, 16, 8, [0, 0, 0, 0]),
}


@pytest.mark.parametrize("name", list(TGMM_CASES))
def test_tgmm_split_reference_matches_jax_tgmm_einsum(name):
    """bf16 lhs against fp32 dy through the split body's arithmetic
    (``split_dy``), against the JAX einsum on the same operands (lhs as
    its exact fp32 values, as the JAX backward casts it); and the split
    alone moves the result by no more than the same bound. Empty groups
    come out zero."""
    m, k, n, sizes = TGMM_CASES[name]
    rng = np.random.default_rng(5 * m + k)
    lhs = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(BF)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    sz = torch.tensor(sizes, dtype=torch.int32)
    got = tgm.tgmm_reference(lhs, torch.from_numpy(dy), sz, len(sizes),
                             torch.float32, split_dy=True).numpy()
    plain = tgm.tgmm_reference(lhs, torch.from_numpy(dy), sz, len(sizes),
                               torch.float32).numpy()
    want = np.asarray(_tgmm_einsum(
        jnp.asarray(lhs.float().numpy()), jnp.asarray(dy),
        jnp.asarray(sizes, jnp.int32), len(sizes), jnp.float32))
    assert got.shape == (len(sizes), k, n) and np.isfinite(got).all()
    assert not got[np.asarray(sizes) == 0].any()
    if not sum(sizes):
        return
    scale = np.abs(want).max()
    for ref in (want, plain):
        err = np.abs(got - ref).max() / scale
        assert err <= 1e-5, (name, err)


def test_tgmm_reference_ignores_what_lies_outside_the_groups():
    """Rows past the total hold NaN in both operands: the plain version's
    d_rhs is finite and equal to the one with zeros there."""
    rng = np.random.default_rng(9)
    sizes = torch.tensor([30, 0, 50], dtype=torch.int32)
    lhs = torch.from_numpy(rng.standard_normal((100, 24)).astype(
        np.float32)).to(BF)
    dy = torch.from_numpy(rng.standard_normal((100, 16)).astype(np.float32))
    want = tgm.tgmm_reference(lhs, dy, sizes, 3, torch.float32,
                              split_dy=True)
    lhs[80:], dy[80:] = float("nan"), float("nan")
    got = tgm.tgmm_reference(lhs, dy, sizes, 3, torch.float32, split_dy=True)
    assert torch.equal(got, want)
