"""The redesigned paged attend (K4) on the CPU: the plan, and the split
arithmetic its kernels follow. The CUDA bodies leave each split's
online-softmax state (m, l, acc) and a combine pass merges them in split
order; ``split_partials_reference`` and ``combine_partials_reference``
are the plain versions of the two, and composed they must give what the
JAX Pallas kernel (interpret mode) and the gather path give. Inputs come
from numpy seeds and go through both packages. Splits of 1 or 2 pages
cut these small pools into many splits."""
import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.ops import paged_decode as jpd
from distributed_training_guide_tpu.serve import kv_pages as jkv
from distributed_training_guide_tpu_torch.ops import paged_decode as tpd
import torch_threads  # noqa: F401  (one torch thread a test process)

PAGE, D = 4, 8
BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8


@pytest.mark.parametrize("t,groups,q_dtype,kv_dtype,want", [
    (1, 4, BF16, BF16, ("split", 4, 16, 16)),     # llama-3.1-8b decode
    (256, 4, BF16, BF16, ("mma", 64, 32, 8)),     # llama-3.1-8b chunk
    (1, 8, BF16, BF16, ("split", 8, 16, 16)),     # qwen3-30b-a3b decode
    (256, 8, BF16, BF16, ("mma", 64, 32, 8)),     # qwen3-30b-a3b chunk
    (5, 4, BF16, BF16, ("split", 8, 16, 16)),     # a short verify tile
    (16, 4, BF16, I8, ("mma", 64, 32, 8)),        # 64 rows over int8
])
def test_plan_at_the_serve_shapes(t, groups, q_dtype, kv_dtype, want):
    """max_len 4096 at page 16 gives a 256-page table."""
    assert tuple(tpd._plan(t, groups, 128, q_dtype, kv_dtype, 256)) == want


def test_plan_reads_no_batch_and_sends_fp32_to_the_split_body():
    assert list(inspect.signature(tpd._plan).parameters) == [
        "t", "groups", "d", "q_dtype", "kv_dtype", "m"]
    for t, groups, kv in itertools.product([1, 5, 16, 64, 256], [1, 4, 8],
                                           [F32, BF16, I8]):
        plan = tpd._plan(t, groups, 128, F32, kv, 100)
        assert plan.body == "split" and plan.splits == 7, (t, groups, kv)
    # an fp32 pool under bf16 q stays on the CUDA cores too
    assert tpd._plan(256, 4, 128, BF16, F32, 100).body == "split"
    assert tpd._plan(15, 4, 128, BF16, BF16, 100).body == "split"
    with pytest.raises(ValueError, match="head_dim"):
        tpd._plan(1, 4, 80, BF16, BF16, 100)


def _case(rng, *, t, groups, lengths, m, quantized, d=D):
    """Shuffled physical pages, 0-filled (trash) table tails."""
    s = len(lengths)
    n_pages = s * m + 1
    phys = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((s, m), np.int32)
    for i, n in enumerate(lengths):
        own = min(m, (n + t - 1) // PAGE + 1)
        tables[i, :own] = phys[i * m:i * m + own]
    kp = rng.standard_normal((n_pages, PAGE, 2, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PAGE, 2, d)).astype(np.float32)
    q = rng.standard_normal((s, t, 2 * groups, d)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    if quantized:
        kq, vq = jkv.quantize_kv(jnp.asarray(kp)), jkv.quantize_kv(
            jnp.asarray(vp))
        jargs = (jnp.asarray(q), kq.q, vq.q, jnp.asarray(tables),
                 jnp.asarray(lens))
        jkw = dict(k_scale=kq.scale[..., 0], v_scale=vq.scale[..., 0])
    else:
        jargs = tuple(map(jnp.asarray, (q, kp, vp, tables, lens)))
        jkw = {}
    targs = tuple(torch.from_numpy(np.array(x)) for x in jargs)
    tkw = {k: torch.from_numpy(np.array(v)) for k, v in jkw.items()}
    return jargs, jkw, targs, tkw


def _composed(targs, tkw, pages_per_split, **kw):
    parts = tpd.split_partials_reference(*targs, **tkw,
                                         pages_per_split=pages_per_split,
                                         **kw)
    return parts, tpd.combine_partials_reference(*parts)


# splits of 2 pages = 8 tokens: contexts at 0, 1, the first split edge
# +- 1 page and +- 1 token, and the full table (its last row at the end)
SPLIT_GRID = list(itertools.product(
    [1, 5, 64], [1, 4, 8],
    [dict(), dict(window=6), dict(softcap=3.0), dict(quantized=True)]))


@pytest.mark.parametrize(
    "t,groups,variant", SPLIT_GRID,
    ids=[f"T{t}-g{g}-{'-'.join(v) or 'causal'}" for t, g, v in SPLIT_GRID])
def test_split_then_combine_matches_jax_kernel_and_gather(t, groups,
                                                          variant):
    """fp32, bound 1e-5: each split's softmax and the merge reorder the
    sums; every path dequantizes the same int8 x fp32-scale values."""
    variant = dict(variant)
    quantized = variant.pop("quantized", False)
    m = 8 if t < 64 else 20
    lengths = [0, 1, 8 - PAGE, 8 + PAGE, 7, 9, m * PAGE - t]
    rng = np.random.default_rng(1000 * t + 10 * groups + len(variant)
                                + 7 * quantized)
    jargs, jkw, targs, tkw = _case(rng, t=t, groups=groups, lengths=lengths,
                                   m=m, quantized=quantized)
    (pm, pl, _), got = _composed(targs, tkw, 2, **variant)
    assert pm.shape[0] == m // 2 and pl.shape[0] == m // 2
    want = jpd.paged_flash_attend(*jargs, **jkw, interpret=True, **variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    gather = tpd.paged_attend_reference(*targs, **tkw, **variant)
    np.testing.assert_allclose(got.numpy(), gather.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("pages_per_split", [1, 2])
def test_fully_masked_rows_are_exactly_zero(pages_per_split):
    """Rows past the table's capacity whose window holds no key: every
    split is neutral and the combine gives exactly 0, as the JAX kernel
    does (the gather path softmaxes such a row uniformly instead)."""
    rng = np.random.default_rng(5)
    m = 6
    cap = m * PAGE
    jargs, jkw, targs, tkw = _case(rng, t=5, groups=4,
                                   lengths=[cap - 1, cap + 3, 3], m=m,
                                   quantized=False)
    (_, pl, pacc), got = _composed(targs, tkw, pages_per_split, window=2)
    want = np.asarray(jpd.paged_flash_attend(*jargs, window=2,
                                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    dead = np.zeros(got.shape[:2], bool)
    dead[0, 2:] = True       # positions cap + 1.. see keys >= cap only
    dead[1, :] = True
    assert (got.numpy()[dead] == 0).all() and (want[dead] == 0).all()
    assert (pl.numpy()[:, dead] == 0).all()
    assert (pacc.numpy()[:, dead] == 0).all()
    assert np.abs(got.numpy()[~dead]).max() > 0


@pytest.mark.parametrize("case", ["suffix", "prefix"])
def test_neutral_splits_leave_the_combine_bitwise_unchanged(case):
    """A split with no live key for a row gives m = NEG_INF, l = 0,
    acc = 0; merged in split order it adds exact zeros. Here every row
    has the same dead splits: a short context (the table's tail is dead)
    or a window (its head is dead too)."""
    rng = np.random.default_rng(9)
    m = 8
    lengths, kw, live = (([5, 6, 7], {}, slice(0, 2)) if case == "suffix"
                         else ([13, 13], dict(window=3), slice(2, 4)))
    _, _, targs, tkw = _case(rng, t=1, groups=4, lengths=lengths, m=m,
                             quantized=False)
    (pm, pl, pacc), got = _composed(targs, tkw, 1, **kw)
    dead = torch.ones(m, dtype=torch.bool)
    dead[live] = False
    assert (pm[dead] == tpd.NEG_INF).all() and (pl[dead] == 0).all()
    assert (pacc[dead] == 0).all() and (pl[live] > 0).all()
    alone = tpd.combine_partials_reference(pm[live], pl[live], pacc[live])
    assert torch.equal(got, alone)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors ``split_partials`` and ``combine_partials`` are the
    plain versions over the plan's splits (a head_dim the kernels take),
    and the composition is ``paged_flash_attend``'s answer within 1e-5."""
    rng = np.random.default_rng(3)
    m = 40                                           # 3 splits of 16
    _, _, targs, tkw = _case(rng, t=5, groups=4, lengths=[0, 70, 150],
                             m=m, quantized=False, d=64)
    before = (tpd.SPLIT_LAUNCHES, tpd.MMA_LAUNCHES, tpd.COMBINE_LAUNCHES,
              tpd.LAUNCHES)
    parts = tpd.split_partials(*targs, window=50)
    assert parts[0].shape == (3, 3, 5, 8)
    out = tpd.combine_partials(*parts, targs[4], page=PAGE, table_pages=m,
                               pages_per_split=16, window=50)
    want = tpd.paged_flash_attend(*targs, window=50)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert (tpd.SPLIT_LAUNCHES, tpd.MMA_LAUNCHES, tpd.COMBINE_LAUNCHES,
            tpd.LAUNCHES) == before
