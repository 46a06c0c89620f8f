"""The CUDA kernel against its plain version, on the card. Marked ``gpu``:
the ``cuda`` fixture decides whether a card is present (never at import
time, so every test worker collects the same tests) and skips without
one. Run on a machine with the card:

    python -m pytest tests/test_torch_gpu.py -q -m gpu
"""
import itertools

import pytest
import torch

from distributed_training_guide_tpu_torch.models import get_model
from distributed_training_guide_tpu_torch.ops import paged_decode as pd
from distributed_training_guide_tpu_torch.serve import (Request, ServeEngine,
                                                        generate_many)

pytestmark = pytest.mark.gpu

# fp32 pools against the fp32 plain version: only the summation order
# differs. bf16 / int8 pools with bf16 q: the plain version rounds the
# probabilities (and an int8 pool's dequantized k/v) to bf16, the kernel
# keeps them fp32, and the output is rounded to bf16 (ulp 2**-8 at 1).
TOL = {"fp32": 2e-5, "bf16": 3e-2, "int8": 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, gen, *, t, pool, d, page, hq=8, hkv=2, s=4, m=12):
    p = s * m + 1
    perm = torch.randperm(p - 1, generator=gen, device=dev).int() + 1
    cap = m * page
    # every query row inside the table's capacity, as in the engine: a
    # row past it with a window can be fully masked, where the kernel
    # returns 0 (safe_l) and the plain softmax the mean of v
    lengths = torch.tensor([cap - t, 0, page, (cap - t) // 2][:s],
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


GRID = list(itertools.product([1, 5, 64], ["fp32", "bf16", "int8"],
                              [64, 128, 256], [8, 16, 64]))


@pytest.mark.parametrize("t,pool,d,page", GRID,
                         ids=[f"T{t}-{p}-d{d}-page{g}" for t, p, d, g in GRID])
def test_kernel_matches_plain_version(cuda, t, pool, d, page):
    gen = torch.Generator(device=cuda).manual_seed(t * 1000 + d + page)
    args, scales = _case(cuda, gen, t=t, pool=pool, d=d, page=page)
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
