"""The CUDA kernels against their plain versions, on the card: the paged
attend (K4), the flash forward and backward (K1-K3), the grouped
matmul and its transposed form (K5, K6; their split bodies for fp32 dy) and
the block-dequant matmul of the int8 serve weights (K7; its tensor-core
body against the plain version at its arithmetic too). Marked ``gpu``:
the ``cuda`` fixture decides whether a card is present (never at import
time, so every test worker collects the same tests) and skips without
one. Run on a machine with the card (``--noconftest``: the suite's
conftest imports jax, which that machine need not have):

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest
"""
import itertools

import pytest
import torch

from distributed_training_guide_tpu_torch.models import get_model
from distributed_training_guide_tpu_torch.ops import flash_attention as fa
from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm
from distributed_training_guide_tpu_torch.ops import paged_decode as pd
from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm
from distributed_training_guide_tpu_torch.serve import (Request, ServeEngine,
                                                        generate_many)
from distributed_training_guide_tpu_torch.train.precision import (
    dequantize_blockwise, quantize_blockwise)

pytestmark = pytest.mark.gpu

# fp32 pools against the fp32 plain version: only the summation order
# differs. bf16 / int8 pools with bf16 q: the plain version rounds the
# probabilities (and an int8 pool's dequantized k/v) to bf16, the kernel
# keeps them fp32, and the output is rounded to bf16 (ulp 2**-8 at 1).
TOL = {"fp32": 2e-5, "bf16": 3e-2, "int8": 3e-2}
# a body's partials against split_partials_reference at the body's own
# arithmetic (the split-context body keeps fp32 and dequantizes int8 in
# fp32; the tensor-core body rounds int8 k/v and p / l to bf16, as the
# plain version does): m and l are fp32 sums of the same products in
# another order, so m absolute and l relative at 1e-4; acc / l per row
# in relative L2, fp32 throughout or p rounded to bf16 (2**-9 relative
# per probability, up to ~5e-3 per row where a few keys cancel)
PART_M_ABS, PART_L_REL = 1e-4, 1e-4
PART_ACC_REL_L2 = {"split": 1e-4, "mma": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, gen, *, t, pool, d, page, hq=8, hkv=2, s=4, m=70):
    p = s * m + 1
    perm = torch.randperm(p - 1, generator=gen, device=dev).int() + 1
    cap = m * page
    # every query row inside the table's capacity, as in the engine: a
    # row past it with a window can be fully masked, where the kernel
    # returns 0 (safe_l) and the plain softmax the mean of v. 70 pages
    # span 5 splits of the split-context body and 3 of the tensor-core one
    lengths = torch.tensor([cap - t, 0, page, (cap - t) // 2, 1, page - 1,
                            2 * page + 1, cap - t - page][:s],
                           dtype=torch.int32, device=dev)
    tables = torch.zeros(s, m, dtype=torch.int32, device=dev)
    for i in range(s):
        own = min(m, (int(lengths[i]) + t - 1) // page + 1)
        tables[i, :own] = perm[i * m:i * m + own]
    kf = torch.randn(p, page, hkv, d, generator=gen, device=dev)
    vf = torch.randn(p, page, hkv, d, generator=gen, device=dev)
    qdt = torch.float32 if pool == "fp32" else torch.bfloat16
    q = torch.randn(s, t, hq, d, generator=gen, device=dev).to(qdt)
    scales = {}
    if pool == "int8":
        ks, vs = kf.abs().amax(-1) / 127, vf.abs().amax(-1) / 127
        kp = torch.round(kf / ks[..., None]).to(torch.int8)
        vp = torch.round(vf / vs[..., None]).to(torch.int8)
        scales = dict(k_scale=ks.contiguous(), v_scale=vs.contiguous())
    else:
        kp, vp = kf.to(qdt), vf.to(qdt)
    return (q, kp, vp, tables, lengths), scales


def _bf16_ulps(got, want, floor=2e-6):
    """max |got - want| in units of (one bf16 ulp of max(|got|, |want|)
    plus ``floor``: the fp32 error of summing the splits' terms, up to
    |v| ~ 5, in another order, which exceeds the ulp where an element
    cancels to |o| < ~5e-4)."""
    big = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return ((got.float() - want.float()).abs() / (ulp + floor)).max().item()


def _hold_partials(parts, args, scales, plan, pool, **kw):
    """A body's partials (m, l, acc) against the plain ones over the same
    splits, on the (row, split) pairs with a live key."""
    q = args[0]
    rm, rl, racc = pd.split_partials_reference(
        q.float() if plan.body == "split" else q, *args[1:],
        pages_per_split=plan.pages_per_split, **kw, **scales)
    m, l, acc = parts
    live = rl > 0
    assert torch.equal(live, l > 0)
    assert (m - rm)[live].abs().max().item() <= PART_M_ABS
    assert (l / rl - 1)[live].abs().max().item() <= PART_L_REL
    o, ro = acc[live] / l[live][:, None], racc[live] / rl[live][:, None]
    assert (o - ro).abs().max().item() <= TOL[pool]
    assert ((o - ro).norm(dim=-1) / ro.norm(dim=-1)).max().item() <= \
        PART_ACC_REL_L2[plan.body]


def _hold_call(out, parts, pool):
    """The call is the body and the combine: its output is the fp32
    combine of the body's partials, rounded once to q's dtype (within an
    ulp plus the fp32 floor)."""
    comb = pd.combine_partials_reference(*parts)
    if pool == "fp32":
        assert (out - comb).abs().max().item() <= TOL["fp32"]
    else:
        assert _bf16_ulps(out, comb) <= 1.0


# T 1 and 5 run the split-context body; T 16 and up with bf16 q the
# tensor-core body (T * groups >= 64), with fp32 q the split-context one;
# groups 4 (llama-3.1-8b) at every page, groups 8 (qwen3-30b-a3b) at 16;
# head_dim 96 (gpt-neox-20b) on pages of 1, 24 and 128 positions
GRID = (list(itertools.product([1, 5, 16, 64, 256], ["fp32", "bf16", "int8"],
                               [64, 128, 256], [8, 16, 64], [4]))
        + list(itertools.product([1, 5, 16, 64, 256],
                                 ["fp32", "bf16", "int8"], [64, 128, 256],
                                 [16], [8]))
        + [c for c in itertools.product([1, 5, 16, 64, 256],
                                        ["fp32", "bf16", "int8"], [96],
                                        [1, 24, 128], [4])
           if c[3] * 70 > c[0]])      # T inside the 70-page table


@pytest.mark.parametrize("t,pool,d,page,groups", GRID,
                         ids=[f"T{t}-{p}-d{d}-page{g}" + ("" if gr == 4
                                                          else f"-g{gr}")
                              for t, p, d, g, gr in GRID])
def test_kernel_matches_plain_version(cuda, t, pool, d, page, groups):
    gen = torch.Generator(device=cuda).manual_seed(t * 1000 + d + page)
    args, scales = _case(cuda, gen, t=t, pool=pool, d=d, page=page,
                         hq=2 * groups)
    q, kp, _, tables, _ = args
    plan = pd._plan(t, groups, d, q.dtype, kp.dtype, tables.shape[1])
    for window, softcap in ((None, None), (7, None), (None, 5.0)):
        before = pd.LAUNCHES
        out = pd.paged_flash_attend(*args, window=window, softcap=softcap,
                                    **scales)
        torch.cuda.synchronize()
        assert pd.LAUNCHES == before + 1
        ref = pd.paged_attend_reference(*args, window=window,
                                        softcap=softcap, **scales)
        assert out.dtype == args[0].dtype and out.shape == args[0].shape
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= TOL[pool], (window, softcap, err)
        parts = pd.split_partials(*args, window=window, softcap=softcap,
                                  **scales)
        _hold_partials(parts, args, scales, plan, pool, window=window,
                       softcap=softcap)
        _hold_call(out, parts, pool)


BODY_CASES = list(itertools.product([1, 64], ["fp32", "bf16", "int8"]))


@pytest.mark.parametrize("t,pool", BODY_CASES,
                         ids=[f"T{t}-{p}" for t, p in BODY_CASES])
def test_body_and_combine_match_their_plain_versions(cuda, t, pool):
    """Each kernel alone: a body's partials against
    ``split_partials_reference`` (m, l relative, and acc / l, over the
    plan's splits, at the body's own arithmetic) and the combine kernel
    against
    ``combine_partials_reference`` on the same partials. The combine reads
    only the splits in each row's band; the rest are neutral here."""
    gen = torch.Generator(device=cuda).manual_seed(7 + t)
    args, scales = _case(cuda, gen, t=t, pool=pool, d=128, page=16)
    q, kp, _, tables, lengths = args
    plan = pd._plan(t, 4, 128, q.dtype, kp.dtype, tables.shape[1])
    assert plan.splits > 1
    body = "MMA_LAUNCHES" if plan.body == "mma" else "SPLIT_LAUNCHES"
    before = (getattr(pd, body), pd.COMBINE_LAUNCHES)
    m, l, acc = pd.split_partials(*args, window=300, **scales)
    out = pd.combine_partials(m, l, acc, lengths, page=16,
                              table_pages=tables.shape[1],
                              pages_per_split=plan.pages_per_split,
                              window=300)       # fp32 out: no bf16 rounding
    torch.cuda.synchronize()
    assert (getattr(pd, body), pd.COMBINE_LAUNCHES) == (before[0] + 1,
                                                        before[1] + 1)
    _hold_partials((m, l, acc), args, scales, plan, pool, window=300)
    ref = pd.combine_partials_reference(m, l, acc)
    assert (out - ref).abs().max().item() <= TOL["fp32"]
    full = pd.paged_attend_reference(*args, window=300, **scales)
    assert (out.to(q.dtype).float() - full.float()).abs().max().item() <= \
        TOL[pool]


@pytest.mark.parametrize("t,pool", BODY_CASES,
                         ids=[f"T{t}-{p}" for t, p in BODY_CASES])
def test_rows_bitwise_equal_whatever_the_batch(cuda, t, pool):
    """The plan reads neither S nor the lengths: every row of an S = 8
    call equals, bit for bit, the same slot's row in an S = 1 call."""
    gen = torch.Generator(device=cuda).manual_seed(11 + t)
    args, scales = _case(cuda, gen, t=t, pool=pool, d=128, page=16, s=8)
    q, kp, vp, tables, lengths = args
    batched = pd.paged_flash_attend(*args, window=300, **scales)
    for i in range(q.shape[0]):
        alone = pd.paged_flash_attend(q[i:i + 1], kp, vp, tables[i:i + 1],
                                      lengths[i:i + 1], window=300, **scales)
        assert torch.equal(batched[i], alone[0]), i


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    (q, kp, vp, tables, lengths), _ = _case(cuda, gen, t=5, pool="fp32",
                                            d=64, page=8)
    with pytest.raises(ValueError, match="tables"):
        pd.paged_flash_attend(q, kp, vp, tables.long(), lengths)
    with pytest.raises(ValueError, match="contiguous"):
        pd.paged_flash_attend(q.transpose(0, 1).contiguous().transpose(0, 1),
                              kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="head_dim"):
        pd.paged_flash_attend(q[..., :32].contiguous(),
                              kp[..., :32].contiguous(),
                              vp[..., :32].contiguous(), tables, lengths)
    with pytest.raises(ValueError, match="lies on|operand on"):
        pd.paged_flash_attend(q, kp.cpu(), vp, tables, lengths)
    # what no body takes: another head_dim, page, q dtype or pool dtype
    with pytest.raises(ValueError, match="head_dim"):
        pd.paged_flash_attend(q[..., :48].contiguous(),
                              kp[..., :48].contiguous(),
                              vp[..., :48].contiguous(), tables, lengths)
    big = torch.zeros(kp.shape[0], 512, *kp.shape[2:], dtype=kp.dtype,
                      device=cuda)                  # pages of 1 to 256 only
    with pytest.raises(ValueError, match="page size"):
        pd.paged_flash_attend(q, big, big.clone(), tables, lengths)
    with pytest.raises(ValueError, match="q dtype"):
        pd.paged_flash_attend(q.half(), kp.half(), vp.half(), tables,
                              lengths)
    with pytest.raises(ValueError, match="pool dtype"):
        pd.paged_flash_attend(q, kp.half(), vp.half(), tables, lengths)


def test_engine_on_card_matches_cpu_engine_greedy(cuda):
    """A head_dim-64 llama-debug variant in fp32: the engine on the card
    (every paged attend through the kernel) emits the same greedy tokens
    as the CPU engine (the plain version), bucketed and chunked."""
    bundle = get_model("llama-debug", dtype=torch.float32, hidden_size=256,
                       num_heads=4, num_kv_heads=2)
    params = bundle.init(bundle.config, 0, device="cpu")
    reqs = [Request(prompt_ids=[3 + i, 17, 42, 7, 9][:1 + i % 5],
                    max_new_tokens=6 + i % 4, seed=i) for i in range(6)]
    for chunk in (None, 8):
        kw = dict(n_slots=3, page_size=8, max_len=64, prefill_chunk=chunk)
        before = pd.LAUNCHES
        gpu = generate_many(ServeEngine(bundle, params, device=cuda, **kw),
                            reqs)
        assert pd.LAUNCHES > before
        cpu = generate_many(ServeEngine(bundle, params, device="cpu", **kw),
                            reqs)
        assert [r.token_ids for r in gpu] == [r.token_ids for r in cpu]


# flash: fp32 against the fp32 plain version (summation order only): o and
# lse 2e-5 abs, grads 1e-4 abs; bf16: the kernels round p and ds to bf16
# for their tensor-core products and the outputs to bf16, where the plain
# version keeps fp32 (about 3e-3 measured), relative L2 1e-2
FLASH_FP32 = {"o": 2e-5, "lse": 2e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
FLASH_BF16_REL_L2 = 1e-2
FLASH_GRID = list(itertools.product([64, 128, 256], ["fp32", "bf16"],
                                    [(8, 2), (4, 4)]))
# (causal, window, softcap, band offsets)
FLASH_VARIANTS = ((True, None, None, None), (True, 48, None, None),
                  (True, None, 5.0, None), (False, None, None, None),
                  (True, 64, None, (32, 0)))


def _flash_inputs(dev, gen, dtype, hq, hkv, d, b=2, sq=200, sk=200):
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    return [torch.randn(*shape, generator=gen, device=dev).to(dt)
            for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
                          (b, sq, hq, d))]


@pytest.mark.parametrize("d,dtype,heads", FLASH_GRID,
                         ids=[f"d{d}-{t}-{hq}x{hkv}"
                              for d, t, (hq, hkv) in FLASH_GRID])
def test_flash_kernels_match_plain_versions(cuda, d, dtype, heads):
    hq, hkv = heads
    gen = torch.Generator(device=cuda).manual_seed(d + hq)
    q, k, v, do = _flash_inputs(cuda, gen, dtype, hq, hkv, d)
    for causal, window, softcap, offs in FLASH_VARIANTS:
        kw = dict(causal=causal, softcap=softcap)
        if offs is None:
            kw["window"] = window
        else:
            kw["band"] = fa.pack_band(window, *offs)
        before = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             ro.float()).contiguous()
        dq, dk, dv = fa.flash_bwd_with_stats(q, k, v, do, rlse, delta, **kw)
        torch.cuda.synchronize()
        assert (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == tuple(
            x + 1 for x in before)
        rdq, rdk, rdv = fa.flash_bwd_reference(q, k, v, do, rlse, delta,
                                               **kw)
        for key, got, want in (("o", o, ro), ("lse", lse, rlse),
                               ("dq", dq, rdq), ("dk", dk, rdk),
                               ("dv", dv, rdv)):
            assert got.dtype == want.dtype and got.shape == want.shape
            diff = got.float() - want.float()
            if dtype == "fp32" or key == "lse":
                err, bound = diff.abs().max().item(), FLASH_FP32[key]
            else:
                err = (diff.norm() / want.float().norm()).item()
                bound = FLASH_BF16_REL_L2
            assert err <= bound, (causal, window, softcap, offs, key, err)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_autograd_matches_plain_autograd(cuda, d):
    """K1 + K2 + K3 through ``flash_attention``'s autograd against torch
    autograd through the plain forward, fp32, GQA with a window and a
    softcap: grads within 1e-4."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v, _ = _flash_inputs(cuda, gen, "fp32", 8, 2, d)

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*leaves)
        torch.sum(o * torch.cos(o)).backward()
        return [x.grad for x in leaves]

    got = grads(lambda q, k, v: fa.flash_attention(
        q, k, v, window=48, logit_softcap=5.0))
    want = grads(lambda q, k, v: fa.flash_attention_reference(
        q, k, v, window=48, softcap=5.0)[0])
    for label, g, w in zip("qkv", got, want):
        assert (g - w).abs().max().item() <= 1e-4, label


def test_flash_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, _ = _flash_inputs(cuda, gen, "fp32", 4, 2, 64)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="stride"):
        fa.flash_fwd(q.transpose(-1, -2).contiguous().transpose(-1, -2),
                     k, v)
    with pytest.raises(ValueError, match="operand on"):
        fa.flash_fwd(q, k.cpu(), v)


# the Hopper backward bodies (bf16, D 64 / 128) against the plain version
# at their own arithmetic (``round_p_ds``: p and ds rounded to bf16 before
# the products): only the fp32 order of the sums and the exp differ
# (~1e-6 relative), which moves a few bf16 roundings of p, ds and the
# outputs by one ulp, ~1e-4 in relative L2; 1e-3 leaves 10x room
FLASH_KERNEL_ARITH_REL_L2 = 1e-3
# (B, Sq, Sk, causal, window, softcap, band offsets): lengths off the 64-
# and 128-row tiles, Sq != Sk, a band, a softcap, a window
HOPPER_BWD_CASES = {
    "ragged": (2, 200, 333, False, None, None, None),
    "ragged-causal": (1, 333, 200, True, None, None, (133, 0)),
    "cross": (1, 130, 390, True, None, None, (260, 0)),
    "band": (1, 300, 300, True, 64, None, (32, 8)),
    "softcap": (2, 257, 257, True, None, 5.0, None),
    "window": (1, 450, 450, True, 100, None, None),
}
HOPPER_GRID = list(itertools.product([64, 128], [4, 8],
                                     list(HOPPER_BWD_CASES)))


@pytest.mark.parametrize("d,groups,name", HOPPER_GRID,
                         ids=[f"d{d}-g{g}-{n}" for d, g, n in HOPPER_GRID])
def test_hopper_bwd_bodies_match_plain_versions(cuda, d, groups, name):
    """bf16 K2 / K3 (the wgmma bodies) against the fp32 plain version at
    the bf16 bound, against the plain version at their own arithmetic at
    a tight bound, and bitwise equal from one launch to the next."""
    assert fa._bwd_plan(d, torch.bfloat16) == "wgmma"
    b, sq, sk, causal, window, softcap, offs = HOPPER_BWD_CASES[name]
    hkv = 2
    gen = torch.Generator(device=cuda).manual_seed(d + groups)
    q, k, v, do = (torch.randn(*shape, generator=gen, device=cuda).bfloat16()
                   for shape in ((b, sq, hkv * groups, d), (b, sk, hkv, d),
                                 (b, sk, hkv, d), (b, sq, hkv * groups, d)))
    kw = dict(causal=causal, softcap=softcap)
    if offs is None:
        kw["window"] = window
    else:
        kw["band"] = fa.pack_band(window, *offs)
    ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         ro.float()).contiguous()
    args = (q, k, v, do, rlse, delta)
    before = (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.ALIGN_COPIES)
    got = fa.flash_bwd_with_stats(*args, **kw)
    again = fa.flash_bwd_with_stats(*args, **kw)
    torch.cuda.synchronize()
    assert (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.ALIGN_COPIES) == (
        before[0] + 2, before[1] + 2, before[2])
    plain = fa.flash_bwd_reference(*args, **kw)
    arith = (fa.flash_dq_reference(*args, **kw, round_p_ds=True),
             *fa.flash_dkv_reference(*args, **kw, round_p_ds=True))
    for key, g, a, w, wa in zip(("dq", "dk", "dv"), got, again, plain,
                                arith):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.equal(g, a), key
        for want, bound in ((w, FLASH_BF16_REL_L2),
                            (wa, FLASH_KERNEL_ARITH_REL_L2)):
            err = ((g.float() - want.float()).norm()
                   / want.float().norm()).item()
            assert err <= bound, (key, err, bound)


def test_hopper_bwd_copies_a_misaligned_operand(cuda):
    """An operand whose base is off 16 bytes cannot be read by a tensor
    map: the wrapper copies it (counted in ``ALIGN_COPIES``) and the
    result is that of the aligned operand, bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, s, hq, hkv, d = 1, 192, 8, 2, 64
    q, k, v, do = (torch.randn(*shape, generator=gen, device=cuda).bfloat16()
                   for shape in ((b, s, hq, d), (b, s, hkv, d),
                                 (b, s, hkv, d), (b, s, hq, d)))
    ro, lse = fa.flash_attention_reference(q, k, v)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         ro.float()).contiguous()
    flat = torch.empty(q.numel() + 4, dtype=q.dtype, device=cuda)
    q_off = flat[4:].view(q.shape)           # base 8 bytes past 16
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 == 8
    want = fa.flash_bwd_with_stats(q, k, v, do, lse, delta)
    before = fa.ALIGN_COPIES
    got = fa.flash_bwd_with_stats(q_off, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert fa.ALIGN_COPIES - before == 2     # once for K2, once for K3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bwd_library_table_is_bwd_plan(cuda):
    """The built backward library's own table (``flash_bwd_body``) picks
    the body that ``_bwd_plan`` names at every dtype and head_dim, so the
    wrapper's labels and alignment copies follow the body that runs."""
    lib = fa._build.load("flash_bwd")
    fa._check_body_table(lib)
    assert [lib.flash_bwd_body(1, d) for d in fa.HEAD_DIMS] == [2, 2, 1]


# the Hopper forward body (bf16, D 64 / 128) against the plain version at
# its own arithmetic (``round_p``: kv tiles of 64 keys, a running max, p
# rounded to bf16 before P V): the order of the fp32 sums and exp2 against
# exp move a few bf16 roundings by one ulp, ~1e-4 in relative L2; 1e-3
# leaves 10x room. lse against the fp32 plain version at FLASH_FP32's
# 2e-5: the kernel's l and m are fp32, p unrounded in l.
HOPPER_FWD_CASES = {**HOPPER_BWD_CASES,
                    "masked-rows": (2, 200, 200, True, None, None, (0, 64))}
HOPPER_FWD_GRID = list(itertools.product([64, 128], [1, 4, 8],
                                         list(HOPPER_FWD_CASES)))


@pytest.mark.parametrize("d,groups,name", HOPPER_FWD_GRID,
                         ids=[f"d{d}-g{g}-{n}" for d, g, n in HOPPER_FWD_GRID])
def test_hopper_fwd_body_matches_plain_version(cuda, d, groups, name):
    """bf16 K1 (the wgmma body) against the fp32 plain version at the bf16
    bound, against the plain version at its own arithmetic at a tight
    bound, lse within 2e-5 (-1e30 and o = 0 on a row with no live key),
    bitwise equal from one launch to the next, no alignment copy."""
    assert fa._fwd_plan(d, torch.bfloat16) == "wgmma"
    b, sq, sk, causal, window, softcap, offs = HOPPER_FWD_CASES[name]
    hkv = 2
    gen = torch.Generator(device=cuda).manual_seed(3 * d + groups)
    q, k, v = (torch.randn(*shape, generator=gen, device=cuda).bfloat16()
               for shape in ((b, sq, hkv * groups, d), (b, sk, hkv, d),
                             (b, sk, hkv, d)))
    kw = dict(causal=causal, softcap=softcap)
    if offs is None:
        kw["window"] = window
    else:
        kw["band"] = fa.pack_band(window, *offs)
    before = (fa.FWD_BODY_LAUNCHES["wgmma"], fa.ALIGN_COPIES)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o2, lse2 = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa.FWD_BODY_LAUNCHES["wgmma"], fa.ALIGN_COPIES) == (
        before[0] + 2, before[1])
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
    ao, _ = fa.flash_attention_reference(q, k, v, **kw, round_p=True)
    assert o.dtype == torch.bfloat16 and o.shape == ro.shape
    for want, bound in ((ro, FLASH_BF16_REL_L2),
                        (ao, FLASH_KERNEL_ARITH_REL_L2)):
        err = ((o.float() - want.float()).norm()
               / want.float().norm()).item()
        assert err <= bound, (err, bound)
    assert (lse - rlse).abs().max().item() <= FLASH_FP32["lse"]
    dead = rlse == fa.NEG_INF
    if name == "masked-rows":
        assert dead.any()
    assert not o.transpose(1, 2)[dead].any()


def test_hopper_fwd_copies_a_misaligned_operand(cuda):
    """An operand whose base is off 16 bytes is copied for the forward's
    tensor maps (counted), and the result is that of the aligned operand,
    bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    b, s, hq, hkv, d = 1, 333, 8, 2, 128
    q, k, v = (torch.randn(*shape, generator=gen, device=cuda).bfloat16()
               for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    flat = torch.empty(v.numel() + 4, dtype=v.dtype, device=cuda)
    v_off = flat[4:].view(v.shape)           # base 8 bytes past 16
    v_off.copy_(v)
    want = fa.flash_fwd(q, k, v)
    before = fa.ALIGN_COPIES
    got = fa.flash_fwd(q, k, v_off)
    torch.cuda.synchronize()
    assert fa.ALIGN_COPIES - before == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fwd_library_table_is_fwd_plan(cuda):
    """The built forward library's own table (``flash_fwd_body``) picks
    the body that ``_fwd_plan`` names at every dtype and head_dim."""
    lib = fa._build.load("flash_fwd")
    fa._check_body_table(lib, "flash_fwd")
    assert [lib.flash_fwd_body(1, d) for d in fa.HEAD_DIMS] == [2, 2, 1]
    assert [lib.flash_fwd_body(0, d) for d in fa.HEAD_DIMS] == [0, 0, 0]


def test_trainer_on_card_matches_cpu(cuda):
    """A head_dim-64 llama-debug variant in fp32: three Trainer steps on
    the card (attention through K1-K3) against the CPU's (the plain
    versions), same params and batches: loss and grad norm within 1e-4
    relative."""
    from distributed_training_guide_tpu_torch.train.optimizer import (
        adamw_cosine)
    from distributed_training_guide_tpu_torch.train.step import Trainer

    bundle = get_model("llama-debug", dtype=torch.float32, hidden_size=256,
                       num_heads=4, num_kv_heads=2)
    params = bundle.init(bundle.config, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batches = [torch.randint(0, 512, (2, 128), generator=gen)
               for _ in range(3)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        trainer = Trainer(bundle=bundle, optimizer=adamw_cosine(1e-3),
                          attn_impl="flash", device=dev)
        state = trainer.init_state_from_params(params, 0)
        before = fa.FWD_LAUNCHES
        metrics = []
        for ids in batches:
            ids = ids.to(dev)
            _, m = trainer.step_fn(state, {"input_ids": ids, "labels": ids})
            metrics.append({k: v.item() for k, v in m.items()})
        launched = fa.FWD_LAUNCHES - before
        assert launched == (6 if dev.type == "cuda" else 0)
        out[dev.type] = metrics
    for g, c in zip(out["cuda"], out["cpu"]):
        for key in ("loss", "grad_norm"):
            assert abs(g[key] - c[key]) <= 1e-4 * abs(c[key]), (key, g, c)


# grouped matmul: fp32 against the fp32 plain version (summation order
# only), max abs error within 1e-5 of the output's largest magnitude; bf16
# operands: both sides sum exact fp32 products in fp32 and round the result
# once, so the relative L2 error is about half a bf16 ulp (2e-3); bound
# 1e-2. (m, k, n, sizes): the decode shape of a 128-expert top-8 model at
# small widths, the large-tile body with widths off the tiles, an empty
# input, a tail, one group taking all rows
GMM_CASES = [
    ("decode", 64, 256, 192, [1 if i % 2 else 0 for i in range(128)]),
    ("ragged", 300, 100, 72, [40, 0, 77, 3, 0, 60, 1, 50, 0, 44]),
    ("large", 1000, 128, 256, [100] * 10),
    ("all-empty", 96, 64, 64, [0, 0, 0, 0]),
    ("tail", 520, 64, 136, [7, 200, 0, 13]),
    ("one-group", 260, 48, 40, [260, 0, 0]),
]
GMM_GRID = [(c, dt) for c in GMM_CASES for dt in ("fp32", "bf16")]


def _gmm_inputs(dev, gen, m, k, n, sizes, dtype):
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    lhs = torch.randn(m, k, generator=gen, device=dev).to(dt)
    rhs = torch.randn(len(sizes), k, n, generator=gen, device=dev).to(dt)
    return lhs, rhs, torch.tensor(sizes, dtype=torch.int32, device=dev)


def _gmm_err(got, want, dtype):
    diff = got.float() - want.float()
    if dtype == "fp32":
        return (diff.abs().max() / want.abs().max().clamp_min(1e-30)).item(), 1e-5
    return (diff.norm() / want.float().norm().clamp_min(1e-30)).item(), 1e-2


@pytest.mark.parametrize("case,dtype", GMM_GRID,
                         ids=[f"{c[0]}-{d}" for c, d in GMM_GRID])
def test_gmm_kernel_matches_plain_version(cuda, case, dtype):
    name, m, k, n, sizes = case
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    lhs, rhs, sz = _gmm_inputs(cuda, gen, m, k, n, sizes, dtype)
    for out_dtype in (None, torch.float32):
        before = gm.GMM_LAUNCHES
        got = gm.gmm(lhs, rhs, sz, out_dtype)
        torch.cuda.synchronize()
        assert gm.GMM_LAUNCHES == before + 1
        want = gm.gmm_reference(lhs, rhs, sz, out_dtype or lhs.dtype)
        assert got.dtype == want.dtype and got.shape == (m, n)
        assert not got[sum(sizes):].any()
        if sum(sizes):
            err, bound = _gmm_err(got, want, dtype)
            assert err <= bound, (name, out_dtype, err)


@pytest.mark.parametrize("case", GMM_CASES, ids=[c[0] for c in GMM_CASES])
def test_gmm_kernel_takes_transposed_bf16_rhs_in_fp32(cuda, case):
    """The backward's form: fp32 dy against rhs^T, a strided view of a
    bf16 [G, N, K] stack, converted as the kernel loads it."""
    name, m, k, n, sizes = case
    gen = torch.Generator(device=cuda).manual_seed(7 + m)
    dy = torch.randn(m, n, generator=gen, device=cuda)
    rhs = torch.randn(len(sizes), k, n, generator=gen,
                      device=cuda).to(torch.bfloat16)
    sz = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    before = gm.GMM_BODY_LAUNCHES["split"]
    got = gm.gmm(dy, rhs.transpose(1, 2), sz, torch.float32)
    assert gm.GMM_BODY_LAUNCHES["split"] == before + 1   # the split body
    want = gm.gmm_reference(dy, rhs.float().transpose(1, 2), sz,
                            torch.float32)
    if sum(sizes):
        err, bound = _gmm_err(got, want, "fp32")
        assert err <= bound, (name, err)


@pytest.mark.parametrize("case,dtype", GMM_GRID,
                         ids=[f"{c[0]}-{d}" for c, d in GMM_GRID])
def test_tgmm_kernel_matches_plain_version(cuda, case, dtype):
    """K6 with fp32 dy (the backward's), lhs in fp32 or bf16, output in
    lhs's dtype; empty groups exactly zero."""
    name, m, k, n, sizes = case
    gen = torch.Generator(device=cuda).manual_seed(3 * m + n)
    lhs, _, sz = _gmm_inputs(cuda, gen, m, k, n, sizes, dtype)
    dy = torch.randn(m, n, generator=gen, device=cuda)
    before = gm.TGMM_LAUNCHES
    got = gm.tgmm(lhs, dy, sz, len(sizes), lhs.dtype)
    torch.cuda.synchronize()
    assert gm.TGMM_LAUNCHES == before + 1
    want = gm.tgmm_reference(lhs.float(), dy, sz, len(sizes), lhs.dtype)
    assert got.dtype == want.dtype and got.shape == (len(sizes), k, n)
    for g, size in enumerate(sizes):
        if size == 0:
            assert not got[g].any()
    if sum(sizes):
        err, bound = _gmm_err(got, want, "fp32")
        # a bf16 output rounds once: half an ulp of 2**-8 relative
        assert err <= (bound if dtype == "fp32" else 4e-3), (name, err)


def test_gmm_rows_are_batch_invariant(cuda):
    """A group's rows come out bitwise the same alone and beside other
    groups' rows (decode-sized and prefill-sized M take different tile
    bodies), in bf16 and fp32."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    for dtype in ("bf16", "fp32"):
        lhs, rhs, _ = _gmm_inputs(cuda, gen, 1000, 256, 192, [0] * 8, dtype)
        crowd = torch.tensor([100, 300, 0, 8, 200, 92, 150, 150],
                             dtype=torch.int32, device=cuda)
        full = gm.gmm(lhs, rhs, crowd)
        start = 408                        # group 4's rows
        alone = torch.zeros(8, dtype=torch.int32, device=cuda)
        alone[4] = 8
        few = gm.gmm(lhs[start:start + 8].contiguous(), rhs, alone)
        assert torch.equal(few, full[start:start + 8]), dtype


def _routed(gen, dev, tokens, experts, topk):
    idx = torch.rand(tokens, experts, generator=gen,
                     device=dev).topk(topk, dim=-1).indices.flatten()
    return torch.zeros(experts, dtype=torch.int32, device=dev).scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))


# the Hopper body's cases: (name, M, K, N, routed tokens or fixed sizes):
# qwen3-30b-a3b's decode (8 tokens x top-8 of 128 experts) and training
# (4096 x top-8) shapes, gate / up and down widths, and the small cases a
# tensor map can read (K, N off the 64- and 128-wide tiles, empty groups,
# a tail, one group taking every row)
GMM_HOPPER_CASES = [
    ("qwen3-decode-gate", 64, 2048, 768, 8),
    ("qwen3-decode-down", 64, 768, 2048, 8),
    ("qwen3-train-gate", 32768, 2048, 768, 4096),
    ("qwen3-train-down", 32768, 768, 2048, 4096),
    ("decode", 64, 256, 192, [1 if i % 2 else 0 for i in range(128)]),
    ("large", 1000, 128, 256, [100] * 10),
    ("all-empty", 96, 64, 64, [0, 0, 0, 0]),
    ("tail", 520, 64, 136, [7, 200, 0, 13]),
    ("one-group", 260, 48, 40, [260, 0, 0]),
]


@pytest.mark.parametrize("case", GMM_HOPPER_CASES,
                         ids=[c[0] for c in GMM_HOPPER_CASES])
def test_gmm_hopper_body_matches_plain_version(cuda, case):
    """bf16 K5 through the wgmma body (``_gmm_plan``, counted per body)
    against the plain version in bf16 and fp32 out, rows past the total
    exactly zero, bitwise equal from one launch to the next."""
    name, m, k, n, sizes = case
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    if isinstance(sizes, int):
        sz = _routed(gen, cuda, sizes, 128, 8)
    else:
        sz = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    lhs = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    rhs = (torch.randn(sz.shape[0], k, n, generator=gen, device=cuda)
           * 0.05).bfloat16()
    assert gm._gmm_plan(lhs, rhs) == "wgmma"
    total = int(sz.sum())
    for out_dtype in (torch.bfloat16, torch.float32):
        before = gm.GMM_BODY_LAUNCHES["wgmma"]
        got = gm.gmm(lhs, rhs, sz, out_dtype)
        again = gm.gmm(lhs, rhs, sz, out_dtype)
        torch.cuda.synchronize()
        assert gm.GMM_BODY_LAUNCHES["wgmma"] == before + 2
        assert torch.equal(got, again)
        want = gm.gmm_reference(lhs, rhs, sz, out_dtype)
        assert got.dtype == out_dtype and got.shape == (m, n)
        assert not got[total:].any()
        if total:
            err = ((got.float() - want.float()).norm()
                   / want.float().norm()).item()
            assert err <= 1e-2, (name, out_dtype, err)


@pytest.mark.parametrize("n", [768, 256, 320])
def test_gmm_hopper_rows_are_batch_invariant_at_full_tiles(cuda, n):
    """A group's rows through the Hopper body alone (decode-sized M: 64 x
    128 tiles, m64n64k16 products) and beside 1000 other rows (128 x 256
    tiles, one m64n256k16 product per k step where a tile is full) come out
    bitwise the same, in bf16 and fp32 out."""
    gen = torch.Generator(device=cuda).manual_seed(13 + n)
    lhs = torch.randn(1000, 512, generator=gen, device=cuda).bfloat16()
    rhs = torch.randn(8, 512, n, generator=gen, device=cuda).bfloat16()
    crowd = torch.tensor([100, 300, 0, 8, 200, 92, 150, 150],
                         dtype=torch.int32, device=cuda)
    alone = torch.zeros(8, dtype=torch.int32, device=cuda)
    alone[4] = 200
    start = 408                            # group 4's rows
    for out_dtype in (torch.bfloat16, torch.float32):
        full = gm.gmm(lhs, rhs, crowd, out_dtype)
        few = gm.gmm(lhs[start:start + 200].contiguous(), rhs, alone,
                     out_dtype)
        assert torch.equal(few, full[start:start + 200]), out_dtype


# the split body (d_lhs: fp32 dy against the bf16 rhs^T) at qwen3-30b-a3b's
# training and decode shapes and small cases: (name, M, K, N, routed tokens
# or fixed sizes), K the width of dy
GMM_SPLIT_CASES = [
    ("qwen3-train-dlhs-gate", 32768, 768, 2048, 4096),
    ("qwen3-train-dlhs-down", 32768, 2048, 768, 4096),
    ("qwen3-decode-dlhs", 64, 768, 2048, 8),
    ("ragged", 300, 72, 104, [40, 0, 77, 3, 0, 60, 1, 50, 0, 44]),
    ("tail", 520, 136, 64, [7, 200, 0, 13]),
    ("all-empty", 96, 64, 64, [0, 0, 0, 0]),
]


@pytest.mark.parametrize("case", GMM_SPLIT_CASES,
                         ids=[c[0] for c in GMM_SPLIT_CASES])
def test_gmm_split_body_matches_plain_versions(cuda, case):
    """fp32 dy against rhs^T (a view of a bf16 [G, N, K] stack) through the
    split body: in fp32 out within 1e-6 relative L2 of its arithmetic
    (``split_bf16`` dy against rhs^T) summed in fp64, within 2e-6 of the
    plain version at that arithmetic (``split_lhs``, whose own fp32 sum
    adds up to ~1e-6) and within the existing 1e-5 of the fp32 plain
    version (the split misses each dy by at most 2**-16 of it); bf16 out
    the rounding of the fp32 out and within 1e-2; rows past the total
    zero."""
    name, m, k, n, sizes = case
    gen = torch.Generator(device=cuda).manual_seed(m + k + n + 1)
    if isinstance(sizes, int):
        sz = _routed(gen, cuda, sizes, 128, 8)
    else:
        sz = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    dy = torch.randn(m, k, generator=gen, device=cuda)
    rhs = (torch.randn(sz.shape[0], n, k, generator=gen, device=cuda)
           * 0.05).bfloat16()
    rt = rhs.transpose(1, 2)
    assert gm._gmm_plan(dy, rt) == "split"
    before = gm.GMM_BODY_LAUNCHES["split"]
    got = gm.gmm(dy, rt, sz, torch.float32)
    got16 = gm.gmm(dy, rt, sz, torch.bfloat16)
    torch.cuda.synchronize()
    assert gm.GMM_BODY_LAUNCHES["split"] == before + 2
    total = int(sz.sum())
    assert got.shape == (m, n) and not got[total:].any()
    assert torch.equal(got16, got.to(torch.bfloat16))
    if not total:
        return
    at_arith = gm.gmm_reference(dy, rt, sz, torch.float32, split_lhs=True)
    plain = gm.gmm_reference(dy, rt.float(), sz, torch.float32)
    exact = torch.zeros(m, n, dtype=torch.float64, device=cuda)
    split = gm.split_bf16(dy).double()
    lo = 0
    for g, size in enumerate(sz.tolist()):
        exact[lo:lo + size] = split[lo:lo + size] @ rt[g].double()
        lo += size
    assert _rel_l2(got, exact) <= 1e-6, (name, _rel_l2(got, exact))
    assert _rel_l2(got, at_arith) <= 2e-6, (name, _rel_l2(got, at_arith))
    err, bound = _gmm_err(got, plain, "fp32")
    assert err <= bound, (name, err)
    assert _rel_l2(got, plain) <= 1e-5
    assert _rel_l2(got16, plain) <= 1e-2


def test_gmm_library_table_is_gmm_plan(cuda):
    """The built grouped-matmul library's own table (``gmm_body``) picks
    the body that ``_gmm_plan`` names for every dtype, alignment and
    stride case of ``_plan_cases``."""
    gm._check_body_table(gm._build.load("grouped_matmul"))


# K6's split body (bf16 lhs against fp32 dy): GMM_CASES, with lhs and dy
# rows padded to 16 bytes so that tensor maps read them at any width;
# qwen3-30b-a3b's training gate / up and down shapes with routed sizes
TGMM_SPLIT_CASES = GMM_CASES + [
    ("qwen3-train-gate", 32768, 2048, 768, 4096),
    ("qwen3-train-down", 32768, 768, 2048, 4096),
]


def _tgmm_split_inputs(dev, gen, m, k, n, sizes):
    """bf16 lhs [m, k] and fp32 dy [m, n] with row strides on 16 bytes,
    group_sizes (routed top-8 of 128 for an int)."""
    if isinstance(sizes, int):
        sz = _routed(gen, dev, sizes, 128, 8)
    else:
        sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
    lhs = torch.zeros(m, -(-k // 8) * 8, dtype=torch.bfloat16,
                      device=dev)[:, :k]
    lhs.copy_(torch.randn(m, k, generator=gen, device=dev))
    dy = torch.zeros(m, -(-n // 4) * 4, device=dev)[:, :n]
    dy.copy_(torch.randn(m, n, generator=gen, device=dev))
    return lhs, dy, sz


@pytest.mark.parametrize("case", TGMM_SPLIT_CASES,
                         ids=[c[0] for c in TGMM_SPLIT_CASES])
def test_tgmm_split_body_matches_plain_versions(cuda, case):
    """bf16 lhs against fp32 dy through K6's split body: in fp32 out within
    2e-6 relative L2 of the plain version at its arithmetic
    (``split_dy``: the same products, summed in another order) and within
    the existing 1e-5 of the fp32 plain version (the split misses each dy
    by at most 2**-16 of it); bf16 out the rounding of the fp32 out and
    within 4e-3 of the largest magnitude (half an ulp, 2**-9); empty groups
    exactly zero."""
    name, m, k, n, sizes = case
    gen = torch.Generator(device=cuda).manual_seed(m + k + n + 2)
    lhs, dy, sz = _tgmm_split_inputs(cuda, gen, m, k, n, sizes)
    g = sz.shape[0]
    assert {gm._tgmm_plan(lhs, dy, dt)
            for dt in (torch.float32, torch.bfloat16)} == {"split"}
    before = gm.TGMM_BODY_LAUNCHES["split"]
    got = gm.tgmm(lhs, dy, sz, g, torch.float32)
    got16 = gm.tgmm(lhs, dy, sz, g, torch.bfloat16)
    torch.cuda.synchronize()
    assert gm.TGMM_BODY_LAUNCHES["split"] == before + 2
    assert got.shape == (g, k, n) and not got[sz == 0].any()
    assert torch.equal(got16, got.to(torch.bfloat16))
    if not int(sz.sum()):
        return
    at_arith = gm.tgmm_reference(lhs, dy, sz, g, torch.float32,
                                 split_dy=True)
    plain = gm.tgmm_reference(lhs, dy, sz, g, torch.float32)
    assert _rel_l2(got, at_arith) <= 2e-6, (name, _rel_l2(got, at_arith))
    assert _rel_l2(got, plain) <= 1e-5, (name, _rel_l2(got, plain))
    err, bound = _gmm_err(got, plain, "fp32")
    assert err <= bound, (name, err)
    assert _gmm_err(got16, plain, "fp32")[0] <= 4e-3


def test_tgmm_out_rows_off_16_bytes_take_the_fma_body(cuda):
    """bf16 lhs against fp32 dy into output rows off 16 bytes (N 70: 140
    or 280 bytes, which the split body's TMA stores cannot write): the FMA
    body runs, as ``_tgmm_plan`` names, within 1e-5 of the fp32 plain
    version; empty groups exactly zero."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    sizes = [40, 0, 77, 3, 0, 60, 1, 50, 0, 44]
    lhs, dy, sz = _tgmm_split_inputs(cuda, gen, 300, 72, 70, sizes)
    assert {gm._tgmm_plan(lhs, dy, dt)
            for dt in (torch.float32, torch.bfloat16)} == {"fma"}
    before = dict(gm.TGMM_BODY_LAUNCHES)
    got = gm.tgmm(lhs, dy, sz, 10, torch.float32)
    got16 = gm.tgmm(lhs, dy, sz, 10, torch.bfloat16)
    torch.cuda.synchronize()
    assert gm.TGMM_BODY_LAUNCHES == {**before, "fma": before["fma"] + 2}
    assert not got[sz == 0].any() and not got16[sz == 0].any()
    plain = gm.tgmm_reference(lhs, dy, sz, 10, torch.float32)
    assert _rel_l2(got, plain) <= 1e-5, _rel_l2(got, plain)
    assert _gmm_err(got16, plain, "fp32")[0] <= 4e-3


def test_tgmm_split_body_ignores_rows_outside_the_groups(cuda):
    """Rows past the total hold NaN in lhs and dy (a caller's garbage
    tail): K6's split body comes out finite, bitwise equal to the same
    call with those rows finite, and within 2e-6 of its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    lhs, dy, sz = _tgmm_split_inputs(cuda, gen, 520, 136, 136,
                                     [7, 200, 0, 13])
    clean = gm.tgmm(lhs, dy, sz, 4, torch.float32)
    lhs[220:], dy[220:] = float("nan"), float("nan")
    got = gm.tgmm(lhs, dy, sz, 4, torch.float32)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, clean)
    want = gm.tgmm_reference(lhs, dy, sz, 4, torch.float32, split_dy=True)
    assert _rel_l2(got, want) <= 2e-6


def test_tgmm_split_rows_are_group_invariant(cuda):
    """A group's d_rhs through K6's split body is bitwise the same with the
    other groups' sizes and rows changed and its own rows moved to another
    start (its chunks count from its first row), in fp32 and bf16 out."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    lhs, dy, crowd = _tgmm_split_inputs(
        cuda, gen, 1000, 256, 192, [100, 300, 0, 8, 200, 92, 150, 150])
    other, dy2, moved = _tgmm_split_inputs(
        cuda, gen, 900, 256, 192, [5, 0, 37, 0, 200, 1, 300, 3])
    other[42:242], dy2[42:242] = lhs[408:608], dy[408:608]   # group 4
    for out_dtype in (torch.float32, torch.bfloat16):
        full = gm.tgmm(lhs, dy, crowd, 8, out_dtype)
        again = gm.tgmm(other, dy2, moved, 8, out_dtype)
        assert torch.equal(full[4], again[4]), out_dtype


def test_tgmm_library_table_is_tgmm_plan(cuda):
    """The built library's ``tgmm_body`` picks, for operands on the card,
    the body that ``_tgmm_plan`` names: bf16 lhs against fp32 dy on and off
    16 bytes, fp32 lhs, bf16 dy, each into bf16 and fp32 output rows."""
    import ctypes

    lib = gm._build.load("grouped_matmul")
    gm._check_body_table(lib)
    bf = torch.bfloat16
    lhs = torch.zeros(64, 72, dtype=bf, device=cuda)
    dy = torch.zeros(64, 36, device=cuda)
    for a, b in ((lhs, dy), (lhs[:, 1:], dy), (lhs[:, :64], dy[:, 1:]),
                 (lhs.float(), dy), (lhs, dy.to(bf)),
                 (lhs[:, :66], dy[:, :33])):
        ls, ds = ((ctypes.c_longlong * 2)(*x.stride()) for x in (a, b))
        for out_dtype in (torch.float32, bf):
            got = lib.tgmm_body(
                gm._DTYPE_CODE[a.dtype], gm._DTYPE_CODE[b.dtype],
                gm._DTYPE_CODE[out_dtype], b.shape[1], a.data_ptr(), ls,
                b.data_ptr(), ds)
            assert gm._TGMM_BODIES[got] == gm._tgmm_plan(a, b, out_dtype)


def test_tgmm_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    lhs, dy, sz = _tgmm_split_inputs(cuda, gen, 16, 8, 8, [4, 4, 4, 4])
    with pytest.raises(ValueError, match="dtype"):
        gm.tgmm(lhs.half(), dy, sz, 4, torch.float32)
    with pytest.raises(ValueError, match="output dtype"):
        gm.tgmm(lhs, dy, sz, 4, torch.float16)
    with pytest.raises(ValueError, match="operand on"):
        gm.tgmm(lhs, dy.cpu(), sz, 4, torch.float32)
    with pytest.raises(ValueError, match="differ in rows"):
        gm.tgmm(lhs, dy[:8], sz, 4, torch.float32)
    big = torch.zeros(gm.MAX_GROUPS + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="groups"):
        gm.tgmm(lhs, dy, big, gm.MAX_GROUPS + 1, torch.float32)


def test_grouped_matmul_autograd_matches_plain_autograd(cuda):
    """The Function (K5 forward; K5 d_lhs and K6 d_rhs in fp32) against
    torch autograd through the plain scan, fp32: output and grads within
    1e-5 of their largest magnitude."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    lhs, rhs, sz = _gmm_inputs(cuda, gen, 300, 100, 72,
                               [40, 0, 77, 3, 0, 60, 1, 50, 0, 44], "fp32")
    cot = torch.randn(300, 72, generator=gen, device=cuda)

    def run(impl):
        l, r = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
        out = gm.grouped_matmul(l, r, sz, impl=impl)
        torch.sum(out * cot).backward()
        return out, l.grad, r.grad

    before = (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
    got = run("auto")
    assert (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES) == (before[0] + 2,
                                                   before[1] + 1)
    want = run("scan")
    for g, w in zip(got, want):
        err, bound = _gmm_err(g, w, "fp32")
        assert err <= bound, err
    assert not got[1][int(sz.sum()):].any()


def test_gmm_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    lhs, rhs, sz = _gmm_inputs(cuda, gen, 16, 8, 8, [4, 4, 4, 4], "fp32")
    with pytest.raises(ValueError, match="dtype"):
        gm.gmm(lhs.half(), rhs.half(), sz)
    with pytest.raises(ValueError, match="operand on"):
        gm.gmm(lhs, rhs.cpu(), sz)
    big = torch.zeros(gm.MAX_GROUPS + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="groups"):
        gm.gmm(lhs, torch.zeros(gm.MAX_GROUPS + 1, 8, 8, device=cuda), big)


def _moe_debug_hd64():
    return get_model("moe-debug", dtype=torch.float32, hidden_size=256,
                     num_heads=4, num_kv_heads=2, capacity_factor=4.0,
                     moe_dispatch="ragged")


def test_moe_engine_on_card_matches_cpu_engine_greedy(cuda):
    """A head_dim-64 moe-debug variant in fp32: the engine on the card
    (K4 attends, K5 expert products) emits the CPU engine's greedy tokens,
    bucketed and chunked, with 3 K5 launches per layer per forward."""
    bundle = _moe_debug_hd64()
    params = bundle.init(bundle.config, 0, device="cpu")
    reqs = [Request(prompt_ids=[3 + i, 17, 42, 7, 9][:1 + i % 5],
                    max_new_tokens=6 + i % 4, seed=i) for i in range(6)]
    for chunk in (None, 8):
        kw = dict(n_slots=3, page_size=8, max_len=64, prefill_chunk=chunk)
        before = gm.GMM_LAUNCHES
        eng = ServeEngine(bundle, params, device=cuda, **kw)
        gpu = generate_many(eng, reqs)
        forwards = eng.decode_steps + eng.programs.prefill_calls
        assert gm.GMM_LAUNCHES - before == 3 * 2 * forwards
        cpu = generate_many(ServeEngine(bundle, params, device="cpu", **kw),
                            reqs)
        assert [r.token_ids for r in gpu] == [r.token_ids for r in cpu]


def test_moe_trainer_on_card_matches_cpu(cuda):
    """Three fp32 ragged-dispatch Trainer steps on the card (K1-K3, K5,
    K6) against the CPU's (the plain versions): loss and grad norm within
    1e-4 relative; per step 6 K5 and 3 K6 launches per layer."""
    from distributed_training_guide_tpu_torch.train.optimizer import (
        adamw_cosine)
    from distributed_training_guide_tpu_torch.train.step import Trainer

    bundle = _moe_debug_hd64()
    params = bundle.init(bundle.config, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batches = [torch.randint(0, 512, (2, 128), generator=gen)
               for _ in range(3)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        trainer = Trainer(bundle=bundle, optimizer=adamw_cosine(1e-3),
                          attn_impl="flash", device=dev)
        state = trainer.init_state_from_params(params, 0)
        before = (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
        metrics = []
        for ids in batches:
            ids = ids.to(dev)
            _, m = trainer.step_fn(state, {"input_ids": ids, "labels": ids})
            metrics.append({k: v.item() for k, v in m.items()})
        launched = (gm.GMM_LAUNCHES - before[0], gm.TGMM_LAUNCHES - before[1])
        layers = bundle.config.num_layers
        assert launched == ((18 * layers, 9 * layers) if dev.type == "cuda"
                            else (0, 0))
        out[dev.type] = metrics
    for g, c in zip(out["cuda"], out["cpu"]):
        for key in ("loss", "grad_norm"):
            assert abs(g[key] - c[key]) <= 1e-4 * abs(c[key]), (key, g, c)
        assert g["moe_dropped_frac"] == 0.0


# K7 against its plain version: fp32 sums of the same fp32 products in
# another order, relative L2 1e-5; a bf16 output rounds the fp32 sum once
# (half an ulp, 2**-9 relative), relative L2 1e-2. (M, K, N, bs): decode
# and prefill rows at engine block size, the K split (K 4096), a short
# last block with N % 4 != 0, block sizes off a multiple of 4, bs 128
QMM_CASES = [
    (8, 4096, 1024, 32), (1, 512, 1024, 32), (37, 640, 1000, 24),
    (300, 96, 33, 32), (64, 4096, 512, 32), (5, 100, 64, 128),
    (3, 64, 10, 5), (16, 4096, 14336 // 4, 32),
]


def _qmm_inputs(dev, gen, m, k, n, bs, xdt):
    w = torch.randn(k, n, generator=gen, device=dev) * 0.02
    qt = quantize_blockwise(w, block_size=bs)
    x = torch.randn(m, k, generator=gen, device=dev).to(xdt)
    return x, qt


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("case", QMM_CASES,
                         ids=[f"M{m}-K{k}-N{n}-bs{bs}"
                              for m, k, n, bs in QMM_CASES])
def test_qmm_kernel_matches_plain_version(cuda, case):
    m, k, n, bs = case
    gen = torch.Generator(device=cuda).manual_seed(m + k + n + bs)
    for xdt in (torch.float32, torch.bfloat16):
        x, qt = _qmm_inputs(cuda, gen, m, k, n, bs, xdt)
        want = qm.quantized_matmul_reference(x, qt.q, qt.scale)
        for out_dtype, bound in ((torch.float32, 1e-5),
                                 (torch.bfloat16, 1e-2)):
            before = qm.LAUNCHES
            got = qm.dequant_matmul(x, qt.q, qt.scale, out_dtype)
            torch.cuda.synchronize()
            assert qm.LAUNCHES == before + 1
            assert got.shape == (m, n) and got.dtype == out_dtype
            assert bool(torch.isfinite(got.float()).all())
            assert _rel_l2(got, want) <= bound, (xdt, out_dtype)
            if out_dtype == torch.bfloat16:
                # one rounding of the kernel's own fp32 sum
                f32 = qm.dequant_matmul(x, qt.q, qt.scale)
                assert torch.equal(got, f32.to(torch.bfloat16))


def test_qmm_rows_are_bitwise_invariant_in_m(cuda):
    """Row r of an M = 37 (and M = 300) product equals the M = 1 product
    of that row bit for bit, split K included."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    for k, n in ((4096, 1024), (640, 1000)):
        x, qt = _qmm_inputs(cuda, gen, 300, k, n, 32, torch.bfloat16)
        full = qm.dequant_matmul(x, qt.q, qt.scale)
        part = qm.dequant_matmul(x[:37].contiguous(), qt.q, qt.scale)
        for r in (0, 5, 36):
            one = qm.dequant_matmul(x[r:r + 1].contiguous(), qt.q, qt.scale)
            assert torch.equal(one[0], part[r]) and torch.equal(one[0],
                                                                full[r])


@pytest.mark.parametrize("m", [1, 8, 37, 256, 2048])
def test_qmm_wgmma_body_matches_split_and_plain_versions(cuda, m):
    """bf16 x through the tensor-core body at llama-3.1-8b's K and a
    quarter of its gate width, bs 32: in fp32 out within 1e-6 relative L2
    of its arithmetic (x against the ``split_bf16`` weight) summed in fp64,
    within 2e-6 of the plain version at that arithmetic (``split_w``, whose
    own fp32 sum over K 4096 adds up to ~1e-6), within the existing 1e-5
    of the fp32 plain version and 1e-2 in bf16 out, the bf16 output the
    rounding of the fp32 one."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    x, qt = _qmm_inputs(cuda, gen, m, 4096, 3584, 32, torch.bfloat16)
    assert qm._qmm_plan(x, qt.q, qt.scale) == "wgmma"
    before = qm.BODY_LAUNCHES["wgmma"]
    got = qm.dequant_matmul(x, qt.q, qt.scale)
    got16 = qm.dequant_matmul(x, qt.q, qt.scale, torch.bfloat16)
    torch.cuda.synchronize()
    assert qm.BODY_LAUNCHES["wgmma"] == before + 2
    assert got.shape == (m, 3584) and bool(torch.isfinite(got).all())
    assert torch.equal(got16, got.to(torch.bfloat16))
    at_arith = qm.quantized_matmul_reference(x, qt.q, qt.scale, split_w=True)
    plain = qm.quantized_matmul_reference(x, qt.q, qt.scale)
    exact = x.double() @ qm.split_bf16(dequantize_blockwise(qt)).double()
    assert _rel_l2(got, exact) <= 1e-6, _rel_l2(got, exact)
    assert _rel_l2(got, at_arith) <= 2e-6, _rel_l2(got, at_arith)
    assert _rel_l2(got, plain) <= 1e-5, _rel_l2(got, plain)
    assert _rel_l2(got16, plain) <= 1e-2


@pytest.mark.parametrize("bs", [1, 2, 16, 32, 64, 96, 128, 256])
def test_qmm_wgmma_body_takes_any_block_size(cuda, bs):
    """The tensor-core body's scale tile holds 8 to 132 blocks of a column
    tile by the block size (bs 1: a block a column, each column its own
    scale): each within the fp32 bound of the plain version, at M 8 and
    200."""
    gen = torch.Generator(device=cuda).manual_seed(bs)
    for m in (8, 200):
        x, qt = _qmm_inputs(cuda, gen, m, 512, 3072, bs, torch.bfloat16)
        assert qm._qmm_plan(x, qt.q, qt.scale) == "wgmma"
        got = qm.dequant_matmul(x, qt.q, qt.scale)
        torch.cuda.synchronize()
        want = qm.quantized_matmul_reference(x, qt.q, qt.scale)
        assert _rel_l2(got, want) <= 1e-5, (bs, m, _rel_l2(got, want))


@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096), (4096, 1024)])
def test_qmm_wgmma_rows_are_bitwise_invariant_in_m(cuda, k, n):
    """Through the tensor-core body at llama-3.1-8b's gate, down and wk
    widths (the K split G of each from (K, N)): rows of M = 2048, 256 and
    37 products equal the M = 1 and M = 8 products of those rows bit for
    bit."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    x, qt = _qmm_inputs(cuda, gen, 2048, k, n, 32, torch.bfloat16)
    assert qm._qmm_plan(x, qt.q, qt.scale) == "wgmma"
    full = qm.dequant_matmul(x, qt.q, qt.scale, torch.bfloat16)
    eight = qm.dequant_matmul(x[:8].contiguous(), qt.q, qt.scale,
                              torch.bfloat16)
    assert torch.equal(eight, full[:8])
    for rows in (256, 37):
        part = qm.dequant_matmul(x[:rows].contiguous(), qt.q, qt.scale,
                                 torch.bfloat16)
        assert torch.equal(part, full[:rows]), rows
    for r in (0, 5, 36, 1000, 2047):
        one = qm.dequant_matmul(x[r:r + 1].contiguous(), qt.q, qt.scale,
                                torch.bfloat16)
        assert torch.equal(one[0], full[r]), r


def test_qmm_library_table_is_qmm_plan(cuda):
    """The built library's own table (``qmm_body``) picks the body that
    ``_qmm_plan`` names for every dtype, alignment and row case of
    ``_plan_cases``."""
    qm._check_body_table(qm._build.load("quantized_matmul"))


def test_qmm_auto_launches_the_kernel_and_never_the_plain_form(cuda,
                                                               monkeypatch):
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 3, 256, generator=gen, device=cuda)
    qt = quantize_blockwise(torch.randn(256, 96, generator=gen, device=cuda),
                            block_size=32)

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(qm, "quantized_matmul_reference", refuse)
    before = qm.LAUNCHES
    for impl in ("auto", "pallas"):
        out = qm.quantized_matmul(x, qt, impl=impl)
        assert out.shape == (2, 3, 96) and out.is_cuda
    assert qm.LAUNCHES == before + 2


def test_qmm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, qt = _qmm_inputs(cuda, gen, 4, 64, 64, 32, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        qm.dequant_matmul(x.half(), qt.q, qt.scale)
    with pytest.raises(ValueError, match="operand on"):
        qm.dequant_matmul(x, qt.q.cpu(), qt.scale)
    with pytest.raises(ValueError, match="int8"):
        qm.dequant_matmul(x, qt.q.float(), qt.scale)


def test_int8_engine_on_card_matches_cpu_engine_greedy(cuda):
    """A head_dim-64 llama-debug variant in fp32 with int8 weights: the
    engine on the card (every standard-form product through K7, 7 per
    layer and the head per forward) emits the CPU engine's greedy tokens,
    bucketed and chunked."""
    bundle = get_model("llama-debug", dtype=torch.float32, hidden_size=256,
                       num_heads=4, num_kv_heads=2)
    params = bundle.init(bundle.config, 0, device="cpu")
    reqs = [Request(prompt_ids=[3 + i, 17, 42, 7, 9][:1 + i % 5],
                    max_new_tokens=6 + i % 4, seed=i) for i in range(6)]
    per_forward = 7 * bundle.config.num_layers + 1
    for chunk in (None, 8):
        kw = dict(n_slots=3, page_size=8, max_len=64, prefill_chunk=chunk,
                  weight_dtype="int8")
        before = qm.LAUNCHES
        eng = ServeEngine(bundle, params, device=cuda, **kw)
        gpu = generate_many(eng, reqs)
        forwards = eng.decode_steps + eng.programs.prefill_calls
        assert qm.LAUNCHES - before == per_forward * forwards
        cpu = generate_many(ServeEngine(bundle, params, device="cpu", **kw),
                            reqs)
        assert [r.token_ids for r in gpu] == [r.token_ids for r in cpu]


@pytest.mark.parametrize("policy,k1_per_layer", [
    (None, 1), ("all", 2), ("dots", 2), ("attn", 1), ("attn_mlp", 1)])
def test_remat_policy_launches_k1_per_layer(cuda, policy, k1_per_layer):
    """A head_dim-64 llama-debug variant in bf16 through the flash kernels:
    the flash forward is one custom op, so "attn" / "attn_mlp" keep its
    (o, lse) and backward launches no K1 again; K2 and K3 once per layer
    under every policy. Loss and grads bitwise those of the step without
    remat (recomputation launches the same kernels on the same inputs)."""
    from distributed_training_guide_tpu_torch.models import llama
    from distributed_training_guide_tpu_torch.ops.cross_entropy import (
        causal_lm_loss)

    bundle = get_model("llama-debug", hidden_size=256, num_heads=4,
                       num_kv_heads=2)
    cfg = bundle.config
    base = bundle.init(cfg, 0, device=cuda)
    ids = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))

    def run(**kw):
        leaves = []

        def req(t):
            if isinstance(t, dict):
                return {k: req(v) for k, v in t.items()}
            leaves.append(t.detach().clone().requires_grad_())
            return leaves[-1]

        params = req(base)
        counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
        loss = causal_lm_loss(llama.apply(cfg, params, ids,
                                          attn_impl="flash", **kw), ids)
        loss.backward()
        torch.cuda.synchronize()
        used = [now - was for now, was in zip(
            (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES), counts)]
        return loss.detach(), [x.grad for x in leaves], used

    loss0, grads0, _ = run()
    loss, grads, used = run(remat=policy is not None, remat_policy=policy)
    layers = cfg.num_layers
    assert used == [k1_per_layer * layers, layers, layers]
    assert torch.equal(loss, loss0)
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_op_under_selective_checkpoint_equals_the_kernels(cuda, dtype):
    """The custom op's autograd under the "attn" policy: one K1 launch, and
    dq, dk, dv bitwise equal to K1 then K2 / K3 called directly (what the
    autograd Function before the custom op computed)."""
    from distributed_training_guide_tpu_torch.ops import remat

    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = _flash_inputs(cuda, gen, dtype, 8, 2, 64, sq=256, sk=256)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def body(q, k, v):
        return fa.flash_attention(q * 1, k * 1, v * 1, window=96)

    before = fa.FWD_LAUNCHES
    o = remat.remat(body, *leaves, policy="attn")
    o.backward(do)
    torch.cuda.synchronize()
    assert fa.FWD_LAUNCHES - before == 1
    o2, lse = fa.flash_fwd(q, k, v, window=96)
    assert torch.equal(o.detach(), o2)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o2.float())
    want = fa.flash_bwd_with_stats(q, k, v, do, lse, delta.contiguous(),
                                   window=96)
    for label, x, w in zip("qkv", leaves, want):
        assert torch.equal(x.grad, w), label


@pytest.fixture(scope="module")
def nccl_world_of_one():
    """A one-rank NCCL group from the torchrun env contract (a TCPStore on
    a free local port), taken down after the module's plan tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    import os
    import socket

    import torch.distributed as dist

    from distributed_training_guide_tpu_torch.launch import (
        maybe_initialize_distributed)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        maybe_initialize_distributed("cuda")
        yield
        dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("strategy,mesh_kw,accum", [
    ("ddp", {}, 1), ("zero1", {}, 1), ("zero2", {}, 2), ("fsdp", {"fsdp": 1},
                                                         1),
    ("tp", {"tp": 1}, 1), ("tp_fsdp", {"tp": 1, "fsdp": 1}, 1)])
def test_plan_at_world_one_is_the_single_plan(cuda, nccl_world_of_one,
                                              strategy, mesh_kw, accum):
    """Every plan on a one-rank NCCL mesh (each collective a copy), bf16
    compute through K1-K3 at head_dim 64: two steps' losses and grad norms
    within 1e-5 / 1e-4 relative of the single plan's on the same weights
    and batch (ddp, zero and fsdp run its arithmetic; tp takes the loss
    through the vocab-parallel logsumexp), and one launch of each of K1-K3
    per layer per microbatch."""
    from distributed_training_guide_tpu_torch.parallel import (make_mesh,
                                                               make_plan)
    from distributed_training_guide_tpu_torch.train import optimizer as topt
    from distributed_training_guide_tpu_torch.train.step import Trainer

    bundle = get_model("llama-debug", hidden_size=256, num_heads=4,
                       num_kv_heads=2)
    cfg = bundle.config
    gen = torch.Generator(device=cuda).manual_seed(3)
    shape = (accum, 2, 256) if accum > 1 else (2, 256)
    ids = torch.randint(0, cfg.vocab_size, shape, device=cuda, generator=gen)
    batch = {"input_ids": ids, "labels": ids}

    def run(plan):
        t = Trainer(bundle=bundle, optimizer=topt.adamw_cosine(1e-3),
                    grad_accum=accum, plan=plan, device=cuda)
        state = t.init_state(0)
        out = []
        before = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
        for _ in range(2):
            state, m = t.step_fn(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        used = [now - was for now, was in zip(
            (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES), before)]
        return out, used

    single, used1 = run(None)
    sharded, used = run(make_plan(strategy, make_mesh(**mesh_kw)))
    assert used == used1 == [2 * accum * cfg.num_layers] * 3
    for (loss, norm), (loss1, norm1) in zip(sharded, single):
        assert abs(loss - loss1) <= 1e-5 * abs(loss1)
        assert abs(norm - norm1) <= 1e-4 * abs(norm1)


@pytest.mark.parametrize("s", [512, 4096])
def test_flash_kernels_at_the_405b_head_layout(cuda, s):
    """K1-K3 at llama-3.1-405b's attention (B 1, Hq 128, Hkv 8: a GQA
    group of 16, D 128, bf16, causal) against the fp32 plain versions at
    the bf16 bound and against the plain versions at their own arithmetic
    at the tight bound, each launch through the Hopper body."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v, do = (torch.randn(*shape, generator=gen, device=cuda).bfloat16()
                   for shape in ((1, s, 128, 128), (1, s, 8, 128),
                                 (1, s, 8, 128), (1, s, 128, 128)))
    before = (fa.FWD_BODY_LAUNCHES["wgmma"], fa.ALIGN_COPIES)
    o, lse = fa.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (fa.FWD_BODY_LAUNCHES["wgmma"], fa.ALIGN_COPIES) == (
        before[0] + 1, before[1])
    ro, rlse = fa.flash_attention_reference(q, k, v)
    ao, _ = fa.flash_attention_reference(q, k, v, round_p=True)

    def rel(got, want):
        return ((got.float() - want.float()).norm()
                / want.float().norm()).item()
    assert rel(o, ro) <= FLASH_BF16_REL_L2
    assert rel(o, ao) <= FLASH_KERNEL_ARITH_REL_L2
    assert (lse - rlse).abs().max().item() <= FLASH_FP32["lse"]
    del ao
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         ro.float()).contiguous()
    args = (q, k, v, do, rlse, delta)
    got = fa.flash_bwd_with_stats(*args)
    plain = fa.flash_bwd_reference(*args)
    for key, g, w in zip(("dq", "dk", "dv"), got, plain):
        assert rel(g, w) <= FLASH_BF16_REL_L2, key
    del plain
    arith = (fa.flash_dq_reference(*args, round_p_ds=True),
             *fa.flash_dkv_reference(*args, round_p_ds=True))
    for key, g, w in zip(("dq", "dk", "dv"), got, arith):
        assert rel(g, w) <= FLASH_KERNEL_ARITH_REL_L2, key


def test_offload_on_the_card_is_bitwise_and_frees_the_card(cuda):
    """Params and optimizer state offloaded to pinned host memory between
    steps: the same losses, grad norms and params as without offload,
    bitwise, every offloaded tensor a pinned host buffer between steps,
    and the card's allocated bytes lower by the offloaded bytes."""
    from distributed_training_guide_tpu_torch.train import optimizer as topt
    from distributed_training_guide_tpu_torch.train.state import named_leaves
    from distributed_training_guide_tpu_torch.train.step import Trainer

    bundle = get_model("llama-debug", hidden_size=256, num_heads=4,
                       num_kv_heads=2, num_layers=4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    ids = torch.randint(0, 512, (3, 2, 256), device=cuda, generator=gen)

    def run(**off):
        t = Trainer(bundle=bundle, optimizer=topt.adamw_cosine(1e-3),
                    device=cuda, **off)
        state = t.init_state(0)
        out, alloc = [], []
        for b in ids:
            state, m = t.step_fn(state, {"input_ids": b, "labels": b})
            out.append((float(m["loss"]), float(m["grad_norm"])))
            torch.cuda.synchronize()
            alloc.append(torch.cuda.memory_allocated())
            if state.offload is not None:
                assert state.offload.on_host(state)
        params = {p: x.detach().cpu() for p, x in named_leaves(state.params)}
        host = 0 if state.offload is None else state.offload.host_bytes(state)
        del state, t
        return out, params, alloc[-1], host

    want, wparams, walloc, _ = run()
    base = torch.cuda.memory_allocated()    # after the library workspaces
    for off in ({"offload_opt_state": True},
                {"offload_opt_state": True, "offload_params": True}):
        got, params, alloc, host = run(**off)
        assert got == want, off
        assert all(torch.equal(params[p], wparams[p]) for p in wparams)
        # the allocator rounds each tensor up to 512 bytes
        assert abs((walloc - alloc) - host) <= 512 * 4 * len(wparams), off
        # no device copy outlives its state
        assert torch.cuda.memory_allocated() == base, off


@pytest.mark.parametrize("d,heads", [(64, 12), (128, 16)],
                         ids=["gpt2-d64", "pythia-d128"])
def test_flash_kernels_read_fused_qkv_slices_in_place(cuda, d, heads):
    """The gpt2 / neox forwards hand K1-K3 q, k and v sliced from one fused
    [B, S, 3, H, D] bf16 projection (a sequence stride of 3HD): every
    output bitwise the same launch's on contiguous copies, and no operand
    copied for the Hopper bodies' tensor maps."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    b, s = 2, 384
    qkv = torch.randn(b, s, 3, heads * d, generator=gen, device=cuda).to(
        torch.bfloat16)
    q, k, v = (qkv[:, :, i].reshape(b, s, heads, d) for i in range(3))
    assert not q.is_contiguous()
    do = torch.randn(b, s, heads, d, generator=gen, device=cuda).to(
        torch.bfloat16)
    copies = fa.ALIGN_COPIES
    o, lse = fa.flash_fwd(q, k, v)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
    grads = fa.flash_bwd_with_stats(q, k, v, do, lse, delta)
    assert fa.ALIGN_COPIES == copies
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    want = (*fa.flash_fwd(qc, kc, vc),
            *fa.flash_bwd_with_stats(qc, kc, vc, do, lse, delta))
    for key, got, w in zip(("o", "lse", "dq", "dk", "dv"),
                           (o, lse, *grads), want):
        assert torch.equal(got, w), key


def test_paged_attend_at_group_one_through_the_pool_commit(cuda):
    """gpt2's decode: Hq = Hkv = 12 (one live row of the split body's 4),
    D 64, q / k / v sliced from one fused [S, 1, 3, 12 * 64] projection
    and committed into the pages by ``kv_pages.paged_attend``: the same
    output and pages as contiguous copies (bitwise), and the output within
    ``TOL["bf16"]`` of the plain path on the committed pages."""
    from distributed_training_guide_tpu_torch.serve import kv_pages as kvp

    gen = torch.Generator(device=cuda).manual_seed(12)
    s, h, d, page, m = 4, 12, 64, 16, 64
    lengths = torch.tensor([0, 17, 500, 1000], dtype=torch.int32,
                           device=cuda)
    tables = (torch.randperm(s * m, generator=gen, device=cuda).int()
              .reshape(s, m) + 1)
    qkv = torch.randn(s, 1, 3, h * d, generator=gen, device=cuda).to(
        torch.bfloat16)
    q, k, v = (qkv[:, :, i].reshape(s, 1, h, d) for i in range(3))
    pools = torch.randn(2, s * m + 1, page, h, d, generator=gen,
                        device=cuda).to(torch.bfloat16)
    outs = []
    for args in ((q, k, v), tuple(x.contiguous() for x in (q, k, v))):
        kp, vp = pools[0].clone(), pools[1].clone()
        before = pd.LAUNCHES
        attn, _ = kvp.paged_attend(*args, kp, vp, tables, lengths)
        assert pd.LAUNCHES == before + 1
        outs.append((attn, kp, vp))
    (a1, k1, v1), (a2, k2, v2) = outs
    assert torch.equal(a1, a2) and torch.equal(k1, k2) and torch.equal(v1, v2)
    want = pd.paged_attend_reference(q.contiguous(), k1, v1, tables, lengths)
    assert (a1.float() - want.float()).abs().max().item() <= TOL["bf16"]


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


# q scaled by this in the softcap checks: the scores' std goes from 1 to 12
# and their largest reach ~45, where 50 * tanh(s / 50) takes ~10 off them
# (scores of std 1 never come near the cap)
CAP_Q_SCALE = 12.0


def test_gemma2_shape_kernels_match_plain_versions(cuda):
    """gemma2-2b's attention (Hq 8, Hkv 4, D 256, softcap 50, the scale
    256**-0.5, a 4096 window) at S 4608 so that the window binds: K1-K3
    (the WMMA bodies) within ``FLASH_BF16_REL_L2`` of their plain versions
    (lse within the fp32 bound, scaled with q), and K4 at decode over 8
    slots of 6000 tokens within ``FLASH_BF16_REL_L2`` (and, on q as drawn,
    ``TOL["bf16"]``): on q as drawn and on q scaled by ``CAP_Q_SCALE``,
    where the plain output without the cap lies far outside the bound."""
    gen = torch.Generator(device=cuda).manual_seed(256)
    kw = dict(window=4096, softcap=50.0, scale=256.0 ** -0.5)
    no_cap = dict(kw, softcap=None)
    q0, k, v, do = _flash_inputs(cuda, gen, "bf16", 8, 4, 256, b=1, sq=4608,
                                 sk=4608)
    for c in (1.0, CAP_Q_SCALE):
        q = (q0.float() * c).to(q0.dtype)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             ro.float()).contiguous()
        got = fa.flash_bwd_with_stats(q, k, v, do, rlse, delta, **kw)
        want = fa.flash_bwd_reference(q, k, v, do, rlse, delta, **kw)
        assert (lse - rlse).abs().max().item() <= FLASH_FP32["lse"] * c
        for key, g, w in zip(("o", "dq", "dk", "dv"), (o, *got),
                             (ro, *want)):
            err = _rel_l2(g, w)
            assert err <= FLASH_BF16_REL_L2, (c, key, err)
        if c > 1:
            moved = _rel_l2(fa.flash_attention_reference(q, k, v, **no_cap)[0],
                            ro)
            assert moved > 10 * FLASH_BF16_REL_L2, moved
    s, ctx, page = 8, 6000, 16
    m = -(-ctx // page)
    tables = (torch.randperm(s * m, generator=gen, device=cuda).int()
              .reshape(s, m) + 1)
    lengths = torch.full((s,), ctx - 1, dtype=torch.int32, device=cuda)
    kp = torch.randn(s * m + 1, page, 4, 256, generator=gen,
                     device=cuda).to(torch.bfloat16)
    vp = torch.randn_like(kp)
    qd0 = torch.randn(s, 1, 8, 256, generator=gen, device=cuda).to(
        torch.bfloat16)
    for c in (1.0, CAP_Q_SCALE):
        qd = (qd0.float() * c).to(qd0.dtype)
        out = pd.paged_flash_attend(qd, kp, vp, tables, lengths, **kw)
        ref = pd.paged_attend_reference(qd, kp, vp, tables, lengths, **kw)
        assert _rel_l2(out, ref) <= FLASH_BF16_REL_L2, (c, _rel_l2(out, ref))
        if c == 1.0:
            assert (out.float() - ref.float()).abs().max().item() <= TOL[
                "bf16"]
        else:
            moved = _rel_l2(pd.paged_attend_reference(
                qd, kp, vp, tables, lengths, **no_cap), ref)
            assert moved > 10 * FLASH_BF16_REL_L2, moved


# the bf16 bodies at the calls the ring makes: (B, S, Hq, Hkv, D, causal,
# window, band offsets, scale, softcap, q scale): llama-3.2-1b's past
# chunk pairs (non-causal), llama-3.1-8b's chunk pair whose keys lie
# partly below the 4096 band, gemma2-2b's cp-4 chunk pair at S 16384 (the
# WMMA body) on q as drawn and on q x CAP_Q_SCALE
RING_PAIR_CASES = {
    "past-512": (1, 512, 32, 8, 64, False, None, None, None, None, 1.0),
    "past-2048": (1, 2048, 32, 8, 64, False, None, None, None, None, 1.0),
    "8b-band": (1, 2048, 32, 8, 128, True, 4096, (6144, 2048), None, None,
                1.0),
    "gemma2-band": (1, 2048, 8, 4, 256, True, 4096, (10240, 6144), 1 / 16,
                    50.0, 1.0),
    "gemma2-band-x12": (1, 2048, 8, 4, 256, True, 4096, (10240, 6144),
                        1 / 16, 50.0, CAP_Q_SCALE)}


@pytest.mark.parametrize("name", list(RING_PAIR_CASES))
def test_flash_bodies_at_the_ring_pair_shapes(cuda, name):
    """K1-K3's bf16 bodies at ``causal=False`` and at bands with nonzero
    (q_off, k_off): within ``FLASH_BF16_REL_L2`` of their plain versions
    (lse within the fp32 bound, scaled with q; -1e30 and o = 0 on rows with
    no live key), and at the kernels' own arithmetic within
    ``FLASH_KERNEL_ARITH_REL_L2`` (K1 on the wgmma body; K2 / K3 on
    both)."""
    b, s, hq, hkv, d, causal, window, offs, scale, cap, c = \
        RING_PAIR_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(14 + d)
    q, k, v, do = _flash_inputs(cuda, gen, "bf16", hq, hkv, d, b=b, sq=s,
                                sk=s)
    q = (q.float() * c).to(q.dtype)
    kw = dict(causal=causal, scale=scale, softcap=cap)
    if offs is not None:
        kw["band"] = fa.pack_band(window, *offs)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
    assert _rel_l2(o, ro) <= FLASH_BF16_REL_L2
    assert (lse - rlse).abs().max().item() <= FLASH_FP32["lse"] * c
    dead = rlse == fa.NEG_INF
    assert not o.transpose(1, 2)[dead].any()
    if fa._fwd_plan(d, q.dtype) == "wgmma":
        ao, _ = fa.flash_attention_reference(q, k, v, **kw, round_p=True)
        assert _rel_l2(o, ao) <= FLASH_KERNEL_ARITH_REL_L2
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         ro.float()).contiguous()
    args = (q, k, v, do, rlse, delta)
    got = fa.flash_bwd_with_stats(*args, **kw)
    want = fa.flash_bwd_reference(*args, **kw)
    arith = fa.flash_bwd_reference(*args, **kw, round_p_ds=True)
    for key, g, w, a in zip(("dq", "dk", "dv"), got, want, arith):
        assert _rel_l2(g, w) <= FLASH_BF16_REL_L2, key
        assert _rel_l2(g, a) <= FLASH_KERNEL_ARITH_REL_L2, key


def _members(x, cp=4):
    return list(torch.chunk(x, cp, dim=1))


def test_ring_on_the_card_matches_the_plain_version(cuda):
    """The zigzag ring over 4 virtual members (llama-3.2-1b's attention,
    bf16, S 1024): 36 launches of each of K1-K3 (cp (2cp + 1)), o and its
    grads within ``FLASH_BF16_REL_L2`` of the plain whole-sequence
    attention."""
    from distributed_training_guide_tpu_torch.ops import ring_attention as ra
    from distributed_training_guide_tpu_torch.ops.collectives import (
        LocalExchange)

    gen = torch.Generator(device=cuda).manual_seed(20)
    q, k, v, do = _flash_inputs(cuda, gen, "bf16", 32, 8, 64, b=1, sq=1024,
                                sk=1024)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    o = torch.cat(ra.ring_attention(LocalExchange(4), *(
        _members(x) for x in leaves)), dim=1)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert tuple(n - m for n, m in zip(
        (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES), before)) == (
        36, 36, 36)
    ro, rlse = fa.flash_attention_reference(q, k, v)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         ro.float()).contiguous()
    want = fa.flash_bwd_reference(q, k, v, do, rlse, delta)
    for g, w in zip((o, *grads), (ro, *want)):
        assert _rel_l2(g, w) <= FLASH_BF16_REL_L2


def test_ulysses_on_the_card_equals_whole_sequence_k1(cuda):
    """Ulysses over 4 virtual members: one K1 launch a member on the full
    sequence of its heads, within ``FLASH_BF16_REL_L2`` of whole-sequence
    K1 (attention is independent per head)."""
    from distributed_training_guide_tpu_torch.ops import ulysses_attention
    from distributed_training_guide_tpu_torch.ops.collectives import (
        LocalExchange)

    gen = torch.Generator(device=cuda).manual_seed(21)
    q, k, v, _ = _flash_inputs(cuda, gen, "bf16", 32, 8, 64, b=1, sq=2048,
                               sk=2048)
    before = fa.FWD_LAUNCHES
    with torch.no_grad():
        outs = ulysses_attention.ulysses_members(
            LocalExchange(4), _members(q), _members(k), _members(v),
            impl="flash")
    torch.cuda.synchronize()
    assert fa.FWD_LAUNCHES - before == 4
    whole, _ = fa.flash_fwd(q, k, v)
    assert _rel_l2(torch.cat(outs, dim=1), whole) <= FLASH_BF16_REL_L2


def test_ulysses_on_the_card_gathers_where_cp_does_not_divide_kv_heads(
        cuda):
    """Ulysses over 4 virtual members on llama-3.1-8b's attention on a tp-4
    rank (Hq 8, Hkv 2, D 128: cp 4 does not divide the kv heads) under
    impl 'auto': q, k, v gathered and K1-K3 once a member on the whole
    sequence, forward and backward within ``FLASH_BF16_REL_L2`` of
    whole-sequence K1-K3."""
    from distributed_training_guide_tpu_torch.ops import ulysses_attention
    from distributed_training_guide_tpu_torch.ops.collectives import (
        LocalExchange)

    gen = torch.Generator(device=cuda).manual_seed(23)
    q, k, v, do = _flash_inputs(cuda, gen, "bf16", 8, 2, 128, b=1, sq=2048,
                                sk=2048)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    o = torch.cat(ulysses_attention.ulysses_members(
        LocalExchange(4), *(_members(x) for x in leaves), impl="auto"),
        dim=1)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert tuple(n - m for n, m in zip(
        (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES), before)) == (
        4, 4, 4)
    ro, rlse = fa.flash_fwd(q, k, v)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         ro.float()).contiguous()
    want = fa.flash_bwd_with_stats(q, k, v, do, rlse, delta)
    for g, w in zip((o, *grads), (ro, *want)):
        assert _rel_l2(g, w) <= FLASH_BF16_REL_L2


def test_pipeline_on_the_card_equals_the_single_device(cuda):
    """The 1F1B pipeline over 2 virtual stages (llama-3.2-1b cut to 4
    layers, bf16 compute, B 4, S 512, M 4) against the single device's
    forward and backward of each microbatch, averaged: the loss and every
    grad within 1e-6 in relative L2 (only the fp32 order of the grad sums
    differs); K1 twice per layer and microbatch (the stage's forward
    recomputed), K2 / K3 once."""
    from distributed_training_guide_tpu_torch.ops.cross_entropy import (
        causal_lm_loss)
    from distributed_training_guide_tpu_torch.parallel.pipeline import (
        make_pipeline_value_and_grad)
    from distributed_training_guide_tpu_torch.train.state import named_leaves

    bundle = get_model("llama-3.2-1b", num_layers=4)
    cfg = bundle.config
    params = bundle.init(cfg, 0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(22)
    ids = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                        device=cuda)
    leaves = dict(named_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    want_loss = 0.0
    for m in range(4):
        rows = ids[m:m + 1]
        loss = causal_lm_loss(bundle.apply(cfg, params, rows,
                                           attn_impl="flash"), rows) / 4
        loss.backward()
        want_loss += float(loss.detach())
    ref = {p: t.grad for p, t in leaves.items()}
    for t in leaves.values():
        t.grad = None
        t.requires_grad_(False)
    before = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    loss, grads = make_pipeline_value_and_grad(bundle, pp=2,
                                               attn_impl="flash")(
        params, {"input_ids": ids, "labels": ids})
    torch.cuda.synchronize()
    assert tuple(n - m for n, m in zip(
        (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES), before)) == (
        32, 16, 16)
    assert abs(float(loss) - want_loss) <= 1e-6 * abs(want_loss)
    for path, g in named_leaves(grads):
        assert _rel_l2(g, ref[path]) <= 1e-6, path


# ---------------------------------------------------------------------------
# K5 / K6 on the ep-local window (models/moe.py:_local_groups_compute): a
# member's run of the group-sorted [M, D] buffer of 4 members' tokens from
# its experts' offset, about a quarter of the rows live, the rest other
# experts' rows (here NaN) that both kernels must ignore
# ---------------------------------------------------------------------------

EP_G, EP_K, EP_D, EP_F, EP_TOKENS = 128, 8, 2048, 768, 4 * 512


def _ep_window(dev, gen, member):
    sizes = _routed(gen, dev, EP_TOKENS, EP_G, EP_K)
    m, e_loc = EP_TOKENS * EP_K, EP_G // 4
    e0 = member * e_loc
    local = sizes[e0:e0 + e_loc].contiguous()
    live = int(local.sum())
    x = torch.full((m, EP_D), float("nan"), device=dev).bfloat16()
    x[:live] = torch.randn(live, EP_D, generator=gen, device=dev).bfloat16()
    dy = torch.full((m, EP_F), float("nan"), device=dev)
    dy[:live] = torch.randn(live, EP_F, generator=gen, device=dev)
    rhs = (torch.randn(e_loc, EP_D, EP_F, generator=gen, device=dev)
           * 0.02).bfloat16()
    return x, dy, rhs, local, live


@pytest.mark.parametrize("member", [0, 1, 3])
def test_k5_k6_on_the_ep_window_match_plain_versions(cuda, member):
    """At qwen3-30b-a3b's widths (E 128, top-8, D 2048, F 768), member
    ``member`` of 4's window (M 16384): K5's forward through the Hopper
    body within 1e-2 relative L2 of the plain version, the fp32-dy d_lhs
    and K6 through their split bodies within 2e-6 of their plain versions
    at their arithmetic; the rows past the local total NaN in both
    operands reach no output (rows past the total zero)."""
    gen = torch.Generator(device=cuda).manual_seed(151 + member)
    x, dy, rhs, sz, live = _ep_window(cuda, gen, member)
    rt = rhs.transpose(1, 2)
    g = sz.shape[0]
    assert (gm._gmm_plan(x, rhs), gm._gmm_plan(dy, rt),
            gm._tgmm_plan(x, dy, torch.float32)) == ("wgmma", "split",
                                                     "split")
    fwd = gm.gmm(x, rhs, sz)
    dlhs = gm.gmm(dy, rt, sz, torch.float32)
    drhs = gm.tgmm(x, dy, sz, g, torch.float32)
    torch.cuda.synchronize()
    for out in (fwd, dlhs, drhs):
        assert torch.isfinite(out.float()).all()
    assert not fwd[live:].any() and not dlhs[live:].any()
    xl, dyl = x[:live], dy[:live]
    assert _rel_l2(fwd[:live], gm.gmm_reference(xl, rhs, sz,
                                                torch.bfloat16)) <= 1e-2
    assert _rel_l2(dlhs[:live], gm.gmm_reference(
        dyl, rt, sz, torch.float32, split_lhs=True)) <= 2e-6
    assert _rel_l2(drhs, gm.tgmm_reference(xl, dyl, sz, g, torch.float32,
                                           split_dy=True)) <= 2e-6


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 1e-2)])
def test_ep_exchange_autograd_matches_the_single_device(cuda, dtype, bound):
    """``make_ragged_ep_dispatch`` over 4 virtual members on the card (K5
    on each member's window, K5 / K6 in its backward) against the single
    device's ragged dispatch through the same kernels, E 32, top-4, D 256,
    F 128, 4 x 256 tokens: the output and the grads of the rows, the
    routing weights and the three expert stacks within ``bound`` relative
    L2 (fp32: the members' partials summed in another order; bf16: also
    rounded), in bf16 the expert stacks' grads bitwise (the split bodies
    sum each group from its own first row, wherever the window puts it),
    3 forward and 6 backward launches a member."""
    import dataclasses

    from distributed_training_guide_tpu_torch.models import moe
    from distributed_training_guide_tpu_torch.ops.collectives import (
        LocalExchange)

    cfg = dataclasses.replace(
        get_model("moe-debug", dtype=dtype, moe_dispatch="ragged").config,
        num_experts=32, experts_per_token=4, hidden_size=256,
        intermediate_size=128)
    gen = torch.Generator(device=cuda).manual_seed(17)
    n, t = 4, 256
    x = torch.randn(n * t, 256, generator=gen, device=cuda).to(dtype)
    idx = torch.rand(n * t, 32, generator=gen,
                     device=cuda).topk(4, dim=-1).indices
    probs = torch.rand(n * t, 4, generator=gen, device=cuda) + 0.1
    probs = probs / probs.sum(-1, keepdim=True)
    w = [(torch.randn(32, *s, generator=gen, device=cuda) * 0.05).to(dtype)
         for s in ((256, 128), (256, 128), (128, 256))]
    cot = torch.randn(n * t, 256, generator=gen, device=cuda).to(dtype)

    def run(ep):
        leaves = [a.clone().requires_grad_() for a in (x, probs, *w)]
        xv, pv, gate, up, down = leaves
        if ep:
            disp = moe.make_ragged_ep_dispatch(LocalExchange(n), cfg)
            ws = [list(torch.chunk(a, n)) for a in (gate, up, down)]
            y = torch.cat(disp(list(torch.chunk(xv, n)),
                               list(torch.chunk(idx, n)),
                               list(torch.chunk(pv, n)), *ws))
        else:
            ef = idx.T.reshape(-1)
            y = moe._ragged_dispatch(cfg, xv, ef, pv.T.reshape(-1),
                                     moe._group_sizes(ef, 32),
                                     {"gate": gate, "up": up, "down": down},
                                     dtype)
        return [y.detach(), *torch.autograd.grad(y, leaves, cot)]

    want = run(False)
    before = (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
    got = run(True)
    torch.cuda.synchronize()
    assert (gm.GMM_LAUNCHES - before[0], gm.TGMM_LAUNCHES - before[1]) == (
        6 * n, 3 * n)
    for key, a, b in zip(("y", "dx", "dprobs", "dgate", "dup", "ddown"),
                         got, want):
        assert _rel_l2(a, b) <= bound, (key, _rel_l2(a, b))
        if dtype == torch.bfloat16 and key in ("dgate", "dup", "ddown"):
            assert torch.equal(a, b), (key, _rel_l2(a, b))


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-6),
                                         (torch.bfloat16, 5e-3)])
def test_ring_on_the_card_holds_the_bulk_exchange(cuda, dtype, bound):
    """``make_ragged_ep_dispatch(overlap=True)`` over 4 virtual members on
    the card against the bulk exchange, through K5 / K6 (E 32, top-4, D
    256, F 128, 4 x 256 tokens): the output within 1e-6 relative L2 (the
    same products per row, the partials summed in member order) and the
    grads of the rows, the routing weights and the expert stacks within
    ``bound`` (fp32: sums over the hops in another order; bf16: each hop's
    expert grad rounded before the sum, ~2.3e-3 rel L2 for 4 hops:
    ``chip_smoke.py:OVL_RING_GRAD_REL_L2``); each member runs its window on
    each hop: 3 K5 forward, 3 K5 and 3 K6 backward launches a hop."""
    import dataclasses

    from distributed_training_guide_tpu_torch.models import moe
    from distributed_training_guide_tpu_torch.ops.collectives import (
        LocalExchange)

    cfg = dataclasses.replace(
        get_model("moe-debug", dtype=dtype, moe_dispatch="ragged").config,
        num_experts=32, experts_per_token=4, hidden_size=256,
        intermediate_size=128)
    gen = torch.Generator(device=cuda).manual_seed(22)
    n, t = 4, 256
    x = torch.randn(n * t, 256, generator=gen, device=cuda).to(dtype)
    idx = torch.rand(n * t, 32, generator=gen,
                     device=cuda).topk(4, dim=-1).indices
    probs = torch.rand(n * t, 4, generator=gen, device=cuda) + 0.1
    probs = probs / probs.sum(-1, keepdim=True)
    w = [(torch.randn(32, *s, generator=gen, device=cuda) * 0.05).to(dtype)
         for s in ((256, 128), (256, 128), (128, 256))]
    cot = torch.randn(n * t, 256, generator=gen, device=cuda).to(dtype)

    def run(overlap):
        leaves = [a.clone().requires_grad_() for a in (x, probs, *w)]
        xv, pv, gate, up, down = leaves
        disp = moe.make_ragged_ep_dispatch(LocalExchange(n), cfg,
                                           overlap=overlap)
        ws = [list(torch.chunk(a, n)) for a in (gate, up, down)]
        y = torch.cat(disp(list(torch.chunk(xv, n)),
                           list(torch.chunk(idx, n)),
                           list(torch.chunk(pv, n)), *ws))
        return [y.detach(), *torch.autograd.grad(y, leaves, cot)]

    bulk = run(False)
    before = (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
    ring = run(True)
    torch.cuda.synchronize()
    assert (gm.GMM_LAUNCHES - before[0], gm.TGMM_LAUNCHES - before[1]) == (
        6 * n * n, 3 * n * n)
    assert _rel_l2(ring[0], bulk[0]) <= 1e-6
    for key, a, b in zip(("dx", "dprobs", "dgate", "dup", "ddown"),
                         ring[1:], bulk[1:]):
        assert _rel_l2(a, b) <= bound, (key, _rel_l2(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_loss_on_the_card_matches_the_whole_tensor_loss(cuda, dtype):
    """The fused hidden->loss through ``torch.mm(..., out_dtype=float32)``
    on the card against ``causal_lm_loss`` of ``matmul_f32_out``'s logits
    (the head the unscheduled path runs), at a head of 8192 x 1024 with
    -100 labels and 7 chunks over rows they do not divide: the value
    within 1e-5 relative (fp32 sums in another order), dh and dW within
    1e-5 of their largest element in fp32 and within 1e-2 relative L2 in
    bf16 (the products' fp32 sums in another order, then rounded)."""
    from distributed_training_guide_tpu_torch.ops.cross_entropy import (
        causal_lm_loss, fused_linear_cross_entropy)
    from distributed_training_guide_tpu_torch.ops.matmul import (
        matmul_f32_out)

    gen = torch.Generator(device=cuda).manual_seed(5)
    h = torch.randn(2, 333, 1024, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(1024, 8192, generator=gen, device=cuda) * 0.03
         ).to(dtype)
    labels = torch.randint(0, 8192, (2, 333), generator=gen, device=cuda)
    labels[0, 10:40] = -100

    def run(fused):
        hv, wv = h.clone().requires_grad_(), w.clone().requires_grad_()
        if fused:
            nll, cnt = fused_linear_cross_entropy(hv, wv, labels,
                                                  num_chunks=7)
            loss = nll / cnt.clamp_min(1)
        else:
            loss = causal_lm_loss(matmul_f32_out(hv, wv), labels)
        loss.backward()
        return float(loss.detach()), hv.grad, wv.grad

    v, gh, gw = run(True)
    v0, gh0, gw0 = run(False)
    assert abs(v - v0) <= 1e-5 * abs(v0)
    for a, b in ((gh, gh0), (gw, gw0)):
        if dtype == torch.float32:
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        else:
            assert _rel_l2(a, b) <= 1e-2


@pytest.mark.parametrize("strategy", ["fsdp", "tp_fsdp"])
def test_schedule_at_world_one_on_the_card(cuda, nccl_world_of_one,
                                           strategy):
    """The overlap schedule on a one-rank NCCL mesh, bf16 compute through
    K1-K3: two steps bitwise the unscheduled run on the same fused loss
    (``loss_chunks`` 4), the same K1-K3 launches, and every layer's 7 fsdp
    leaves gathered in the forward and again in the backward."""
    from distributed_training_guide_tpu_torch.parallel import (make_mesh,
                                                               make_plan)
    from distributed_training_guide_tpu_torch.train import optimizer as topt
    from distributed_training_guide_tpu_torch.train.step import Trainer

    bundle = get_model("llama-debug", hidden_size=256, num_heads=4,
                       num_kv_heads=2)
    cfg = bundle.config
    gen = torch.Generator(device=cuda).manual_seed(4)
    ids = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                        generator=gen)
    batch = {"input_ids": ids, "labels": ids}

    def run(sched):
        t = Trainer(bundle=bundle, optimizer=topt.adamw_cosine(1e-3),
                    plan=make_plan(strategy, make_mesh()), device=cuda,
                    overlap_schedule=sched, loss_chunks=4)
        state = t.init_state(0)
        before = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
        out = []
        for _ in range(2):
            state, m = t.step_fn(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        used = [now - was for now, was in zip(
            (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES), before)]
        return out, used, t.plan_state.layer_schedule

    got, used, sched = run(True)
    want, used0, _ = run(False)
    assert got == want
    assert used == used0 == [2 * cfg.num_layers] * 3
    n = 2 * cfg.num_layers * 7
    assert sched.counts == {"gather": n, "regather": n}


# speculative verify and decode horizons on the card: K4's rows at
# T = k + 1 against T = 1, the verify forward's logits against the decode
# steps', and a horizon keeping the pools' storage


@pytest.mark.parametrize("k,heads,pool", [
    (k, heads, pool) for k in (4, 7, 15) for heads in ((8, 2), (16, 2))
    for pool in ("fp32", "bf16", "int8")])
def test_verify_rows_against_single_rows(cuda, k, heads, pool):
    """Row j of a T = k + 1 call against a T = 1 call at ``lengths + j``
    on the same pages: bitwise where both calls run the same body with
    the same rows per block (the split body's sums do not depend on the
    tile otherwise), within the kernel's tolerance where they do not."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    hq, hkv = heads
    t = k + 1
    (q, kp, vp, tables, lengths), scales = _case(
        cuda, gen, t=t, pool=pool, d=128, page=16, hq=hq, hkv=hkv)
    whole = pd.paged_flash_attend(q, kp, vp, tables, lengths, **scales)
    rows = torch.cat([pd.paged_flash_attend(
        q[:, j:j + 1].contiguous(), kp, vp, tables, lengths + j, **scales)
        for j in range(t)], dim=1)
    plans = [pd._plan(n, hq // hkv, 128, q.dtype, kp.dtype, tables.shape[1])
             for n in (t, 1)]
    if plans[0][:2] == plans[1][:2]:
        assert torch.equal(whole, rows)
    else:
        err = (whole.float() - rows.float()).abs().max().item()
        assert err <= TOL[pool], (plans, err)


def test_verify_logits_against_decode_steps_on_card(cuda):
    """llama-debug at head_dim 64 in fp32 on the card: one [3, 5] verify
    forward (all_logits) against five T = 1 decode steps fed the same
    tokens on a clone of the pools, within 1e-4 of the largest logit, and
    the engine's speculation emitting the spec-off tokens."""
    from distributed_training_guide_tpu_torch.models import llama
    from distributed_training_guide_tpu_torch.serve.kv_pages import (
        init_pages, make_attend)

    bundle = get_model("llama-debug", dtype=torch.float32, hidden_size=256,
                       num_heads=4, num_kv_heads=2)
    cfg = bundle.config
    params = bundle.init(cfg, 0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    tables = (torch.randperm(3 * 4, generator=gen, device=cuda).int() + 1
              ).reshape(3, 4)
    pages = init_pages(cfg, 13, 8, device=cuda)
    prompt = torch.randint(3, 500, (3, 7), generator=gen, device=cuda)
    zero = torch.zeros(3, dtype=torch.int32, device=cuda)
    llama.paged_decode_step(cfg, params, prompt, zero, pages,
                            make_attend(tables, zero))
    lens = zero + 7
    ids = torch.randint(3, 500, (3, 5), generator=gen, device=cuda)
    other = {n: v.clone() for n, v in pages.items()}
    got = llama.paged_decode_step(cfg, params, ids, lens, pages,
                                  make_attend(tables, lens),
                                  all_logits=True)[0]
    want = torch.stack([llama.paged_decode_step(
        cfg, params, ids[:, j:j + 1], lens + j, other,
        make_attend(tables, lens + j))[0] for j in range(5)], dim=1)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    reqs = [Request(prompt_ids=[9, 8, 7, 9, 8, 7, 9][:3 + i], seed=i,
                    max_new_tokens=16) for i in range(3)]
    kw = dict(n_slots=3, page_size=8, max_len=64, device=cuda)
    off = generate_many(ServeEngine(bundle, params, **kw), reqs)
    eng = ServeEngine(bundle, params, speculate="ngram", spec_k=4, **kw)
    on = generate_many(eng, reqs)
    assert [r.token_ids for r in on] == [r.token_ids for r in off]
    assert eng.spec["tokens_drafted"] > 0


def test_horizon_keeps_the_pools_on_card(cuda):
    """decode_horizon 4 on the card: the tokens of decode_horizon 1, the
    same pool storage before and after, fewer host reads than steps."""
    bundle = get_model("llama-debug", dtype=torch.float32, hidden_size=256,
                       num_heads=4, num_kv_heads=2)
    params = bundle.init(bundle.config, 0, device=cuda)
    reqs = [Request(prompt_ids=[3 + i, 17, 42][:1 + i % 3], seed=i,
                    max_new_tokens=9 + i, temperature=0.7 * (i % 2))
            for i in range(4)]
    kw = dict(n_slots=3, page_size=8, max_len=64, device=cuda)
    k1 = generate_many(ServeEngine(bundle, params, **kw), reqs)
    eng = ServeEngine(bundle, params, decode_horizon=4, **kw)
    ptrs = {n: eng.pages[n].data_ptr() for n in ("k", "v")}
    k4 = generate_many(eng, reqs)
    assert [r.token_ids for r in k4] == [r.token_ids for r in k1]
    assert all(eng.pages[n].data_ptr() == ptrs[n] for n in ("k", "v"))
    assert eng.host_dispatches < eng.decode_steps


# the new roads of K5 (multi-LoRA serving and the post objective): fp32
# lhs and rhs run the FMA body. (name, M, K, N, group sizes)
GMM_LORA_CASES = [
    ("lora-a-decode", 8, 4096, 8, [3, 0, 2, 0, 3]),
    ("lora-b-decode", 8, 8, 4096, [3, 0, 2, 0, 3]),
    ("lora-b-wv", 8, 8, 1024, [1, 4, 0, 3, 0]),
    ("lora-a-chunk", 256, 4096, 8, [0, 256, 0, 0, 0]),
    ("post-objective", 8 * 127, 1, 1, [40, 0, 64, 127, 0, 3, 90, 0]),
]


@pytest.mark.parametrize("case", GMM_LORA_CASES,
                         ids=[c[0] for c in GMM_LORA_CASES])
def test_gmm_lora_and_post_shapes_match_plain_version(cuda, case):
    """fp32 within 1e-5 of the plain version's largest value, rows past
    the groups zero, the FMA body, and the post objective's d_lhs (K5
    against rhs^T) with no K6 launch: the scalars take no gradient."""
    name, m, k, n, sizes = case
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    lhs, rhs, sz = _gmm_inputs(cuda, gen, m, k, n, sizes, "fp32")
    fma = gm.GMM_BODY_LAUNCHES["fma"]
    got = gm.gmm(lhs, rhs, sz)
    torch.cuda.synchronize()
    assert gm.GMM_BODY_LAUNCHES["fma"] == fma + 1, name
    want = gm.gmm_reference(lhs, rhs, sz, torch.float32)
    err, bound = _gmm_err(got, want, "fp32")
    assert err <= bound and not got[sum(sizes):].any(), (name, err)
    x = lhs.clone().requires_grad_()
    tgmm = gm.TGMM_LAUNCHES
    gm.grouped_matmul(x, rhs, sz).sum().backward()
    torch.cuda.synchronize()
    assert gm.TGMM_LAUNCHES == tgmm
    xc = lhs.cpu().requires_grad_()
    gm.grouped_matmul(xc, rhs.cpu(), sz.cpu()).sum().backward()
    err, bound = _gmm_err(x.grad.cpu(), xc.grad, "fp32")
    assert err <= bound, (name, "d_lhs", err)


def _tenant_engine(bundle, params, dev, payloads, **kw):
    eng = ServeEngine(bundle, params, device=dev, n_slots=4, page_size=8,
                      max_len=64, max_adapters=4, adapter_rank=4, **kw)
    return eng, [eng.publish_adapter(p) for p in payloads]


def test_tenants_on_card(cuda):
    """A head_dim-64 llama-debug variant in fp32 with three tenants: adapter
    0 gives the adapter-free engine's tokens, each tenant's stream
    co-batched gives its solo stream, K5 carried the deltas, and the card's
    tokens equal the CPU engine's."""
    bundle = get_model("llama-debug", dtype=torch.float32, hidden_size=256,
                       num_heads=4, num_kv_heads=2)
    params = bundle.init(bundle.config, 0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    payloads = [{t: {"a": torch.randn(2, 256, 4, generator=gen) * 0.3,
                     "b": torch.randn(2, 4, n, generator=gen) * 0.3}
                 for t, n in (("wq", 256), ("wv", 128))} for _ in range(3)]
    reqs = [Request(prompt_ids=[3 + i, 17, 42, 7][:2 + i % 3], seed=i,
                    max_new_tokens=8, adapter_id=i % 4) for i in range(6)]
    base = generate_many(ServeEngine(bundle, params, device=cuda, n_slots=4,
                                     page_size=8, max_len=64),
                         [Request(prompt_ids=r.prompt_ids, seed=r.seed,
                                  max_new_tokens=8) for r in reqs])
    eng, slots = _tenant_engine(bundle, params, cuda, payloads)
    assert slots == [1, 2, 3]
    before = gm.GMM_LAUNCHES
    together = generate_many(eng, reqs)
    assert gm.GMM_LAUNCHES > before
    for r, b, t in zip(reqs, base, together):
        if r.adapter_id == 0:
            assert t.token_ids == b.token_ids
        solo, _ = _tenant_engine(bundle, params, cuda, payloads)
        assert generate_many(solo, [r])[0].token_ids == t.token_ids
    cpu, _ = _tenant_engine(bundle, params, "cpu", payloads)
    assert [r.token_ids for r in generate_many(cpu, reqs)] == \
        [r.token_ids for r in together]


# ---- the serve fleet on the card --------------------------------------------

def _fleet_model(dev):
    bundle = get_model("llama-debug", dtype=torch.float32, hidden_size=256,
                       num_heads=4, num_kv_heads=2)
    return bundle, bundle.init(bundle.config, 0, device=dev)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_wire_moves_card_pages_bitwise(cuda, pool):
    """Pages of a card pool gathered to pinned host memory, framed, sent
    over the loopback channel and scattered into a second card pool
    arrive bitwise (bf16 as raw 2-byte words; int8 with its scale rows)."""
    from distributed_training_guide_tpu_torch.serve import kv_pages as kvp
    from distributed_training_guide_tpu_torch.serve import transport as tw

    bundle, _ = _fleet_model(cuda)
    src = kvp.init_pages(bundle.config, 12, 8, kv_dtype=pool, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for leaf in tw.pool_leaf_names(src):
        t = tw._leaf(src, leaf)
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=cuda, dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
    payload = tw.gather_payload(src, [3, 7, 1])
    assert all(v.is_pinned() for v in payload.values())
    sender, receiver = tw.loopback_channel(pin=True)
    try:
        assert sender.send(tw.encode_frame(0, {}, payload), 0) == "delivered"
        _, _, got = receiver.inbox.get(timeout=10.0)
    finally:
        sender.sock.close()
        receiver.sock.close()
    dst = kvp.init_pages(bundle.config, 12, 8, kv_dtype=pool, device=cuda)
    tw.scatter_payload(dst, [2, 4, 9], got)
    for leaf in tw.pool_leaf_names(src):
        a = tw._leaf(src, leaf)[:, [3, 7, 1]]
        b = tw._leaf(dst, leaf)[:, [2, 4, 9]]
        assert torch.equal(a.view(torch.uint8) if a.dtype != torch.int8
                           else a, b.view(torch.uint8)
                           if b.dtype != torch.int8 else b), leaf


@pytest.mark.parametrize("transport", ["same_host", "cross_host"])
def test_disagg_pair_on_card_equals_monolith(cuda, transport):
    """The disaggregated pair on the card: the monolith's tokens, K4 on
    both halves' paths, and cross-host the pages' bytes over the wire."""
    from distributed_training_guide_tpu_torch.serve.disagg import \
        DisaggEngine

    bundle, params = _fleet_model(cuda)
    reqs = [Request(prompt_ids=[3 + i, 17, 42, 9][:2 + i % 3], seed=i,
                    max_new_tokens=8) for i in range(5)]
    kw = dict(n_slots=2, page_size=8, max_len=64, device=cuda)
    mono = generate_many(ServeEngine(bundle, params, **kw), reqs)
    before = pd.LAUNCHES
    pair = DisaggEngine(bundle, params, transport=transport, **kw)
    got = generate_many(pair, reqs)
    assert [r.token_ids for r in got] == [r.token_ids for r in mono]
    assert pd.LAUNCHES > before
    moved = pair.stats()["handoff_bytes_copied"]
    assert (moved > 0) == (transport == "cross_host")
    pair.close()


def test_fleet_kill_replay_and_tier_on_card(cuda):
    """A two-replica fleet on the card, one replica killed mid-decode:
    every request decodes its uninterrupted tokens; a host tier under a
    small pool spills and restores to the tier-free tokens."""
    from distributed_training_guide_tpu_torch.serve.router import \
        local_fleet

    bundle, params = _fleet_model(cuda)
    reqs = [Request(prompt_ids=[3 + i, 17, 42], seed=i, max_new_tokens=12,
                    temperature=0.7 * (i % 2)) for i in range(6)]
    kw = dict(n_slots=2, page_size=8, max_len=64, device=cuda)
    want = generate_many(ServeEngine(bundle, params, **kw), reqs)
    fleet = local_fleet(bundle, params, 2,
                        router_kw=dict(heartbeat_timeout_s=60.0), **kw)
    ids = [fleet.submit(r) for r in reqs]
    done, it = {}, 0
    while fleet.has_work:
        if it == 3:
            fleet.replicas["r0"].kill()
        done.update({r.request_id: r for r in fleet.step()})
        it += 1
    assert [done[i].token_ids for i in ids] == [r.token_ids for r in want]
    tier = ServeEngine(bundle, params, n_slots=4, page_size=8, max_len=32,
                       n_pages=7, host_tier_bytes=1 << 24, device=cuda)
    free = ServeEngine(bundle, params, n_slots=1, page_size=8, max_len=32,
                       device=cuda)
    small = [Request(prompt_ids=[3 + i, 17], seed=i, max_new_tokens=14)
             for i in range(6)]
    got = generate_many(tier, small)
    assert tier.stats()["preempted"] > 0
    assert tier.stats()["restore_hits"] > 0
    assert [r.token_ids for r in got] == \
        [generate_many(free, [r])[0].token_ids for r in small]


def test_supervised_crash_resume_on_card(cuda, tmp_path):
    """The train CLI on the card (a head_dim-64 llama-debug variant, K1-K3)
    under the restart supervisor: ``DTG_FAULT_CRASH_STEP=4`` SIGKILLs the
    worker after step 4's checkpoint, the restart resumes and runs steps
    5-6, and the stitched losses are bitwise the uninterrupted run's."""
    import ast
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from distributed_training_guide_tpu_torch.models.hf_export import (
        _hf_config)
    from distributed_training_guide_tpu_torch.train import cli

    root = Path(__file__).resolve().parents[1]
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    (cfg / "config.json").write_text(json.dumps(_hf_config(get_model(
        "llama-debug", hidden_size=256, num_heads=4, num_kv_heads=2))))
    train = ["-m", f"hf:{cfg}", "-d", "synthetic:20000", "-s", "128", "-b",
             "2", "--max-steps", "6", "--log-freq", "1"]
    golden = cli.run_training(cli.get_parser().parse_args(train))
    want = {i["global_step"]: i["running_loss"] for i in golden["infos"]}
    logs = tmp_path / "sup"
    env = dict(os.environ, DTG_FAULT_CRASH_STEP="4",
               PYTHONPATH=str(root) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m",
         "distributed_training_guide_tpu_torch.launch.supervisor",
         "--max-restarts", "2", "--restart-backoff", "0.05", "--log-dir",
         str(logs), "--", sys.executable, "-m",
         "distributed_training_guide_tpu_torch.train", *train, "-e",
         "drill", "--ckpt-freq", "2", "--save-dir", str(tmp_path)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    assert "attempt 0 failed rc=-9" in proc.stdout
    got, launched = {}, 0
    for n in (0, 1):
        text = (logs / f"attempt_{n}" / "stderr.log").read_text()
        infos = [ast.literal_eval(line[line.index("INFO:{") + 5:])
                 for line in text.splitlines() if "INFO:{" in line]
        infos = [i for i in infos if "global_step" in i]
        got.update({i["global_step"]: i["running_loss"] for i in infos})
        launched += infos[-1]["launches/flash_fwd"]
        assert ("Resumed=True" in text) == (n == 1)
    assert got == want
    assert launched == 6 * 2       # 2 layers, steps 1-4 then 5-6
