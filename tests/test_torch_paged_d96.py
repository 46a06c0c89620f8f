"""K4 at head_dim 96 and pages outside 8..64, on the CPU: the port's plain
paged attend (``paged_attend_reference``, what the CUDA kernel is held to
on the card) against the JAX Pallas kernel in interpret mode, which takes
any shape (its compiled form needs ``head_dim % 64 == 0``; the JAX engine
serves gpt-neox-20b through its gather path). fp32, bound 1e-5: the two
sum the same products in another order. Inputs come from numpy seeds."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.ops import paged_decode as jpd
from distributed_training_guide_tpu.serve import kv_pages as jkv
from distributed_training_guide_tpu_torch.ops import paged_decode as tpd
import torch_threads  # noqa: F401  (one torch thread a test process)

D = 96
TOL = 1e-5


def _case(rng, *, t, hq, hkv, page, lengths, m, quantized):
    """Shuffled physical pages per slot, 0-filled (trash) table tails."""
    s = len(lengths)
    n_pages = s * m + 1
    phys = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((s, m), np.int32)
    for i, n in enumerate(lengths):
        own = min(m, (n + t - 1) // page + 1)
        tables[i, :own] = phys[i * m:i * m + own]
    kp = rng.standard_normal((n_pages, page, hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, D)).astype(np.float32)
    q = rng.standard_normal((s, t, hq, D)).astype(np.float32)
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


# T 1 (decode), 5 (a verify tile), 16 (a chunk); gpt-neox-20b's group of 1
# and a GQA group of 4; pages of 4, 24 and 128 positions
GRID = [(t, hq, page, variant)
        for t, (hq, page) in itertools.product(
            [1, 5, 16], [(2, 4), (8, 24), (8, 128)])
        for variant in ("causal", "window", "softcap", "int8")
        if variant == "causal" or (t, page) in ((5, 24), (1, 4), (16, 128))]


@pytest.mark.parametrize(
    "t,hq,page,variant", GRID,
    ids=[f"T{t}-hq{hq}-page{p}-{v}" for t, hq, p, v in GRID])
def test_plain_attend_at_head_dim_96_matches_jax_interpret(t, hq, page,
                                                           variant):
    hkv = 2
    m = max(2, 48 // page + 1)
    cap = m * page
    # an empty slot, a slot on a page edge, the last row at the table's end
    lengths = [0, min(page, cap - t), cap - t]
    rng = np.random.default_rng(97 * t + hq + page)
    jargs, jkw, targs, tkw = _case(rng, t=t, hq=hq, hkv=hkv, page=page,
                                   lengths=lengths, m=m,
                                   quantized=variant == "int8")
    kw = {"window": dict(window=7), "softcap": dict(softcap=3.0)}.get(
        variant, {})
    want = np.asarray(jpd.paged_flash_attend(*jargs, **jkw, interpret=True,
                                             **kw))
    got = tpd.paged_attend_reference(*targs, **tkw, **kw)
    assert got.shape == (3, t, hq, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_the_kernels_take_head_dim_96_and_any_page_up_to_256():
    """The shapes K4's CUDA launch takes (its plain version takes any)."""
    assert 96 in tpd.HEAD_DIMS
    for page in (1, 4, 24, 128, 256):
        assert tpd.paged_decode_eligible(96, page)
    assert not tpd.paged_decode_eligible(96, 512)
    assert not tpd.paged_decode_eligible(80, 16)
    plan = tpd._plan(256, 1, 96, torch.bfloat16, torch.bfloat16, 16)
    assert plan.body == "mma"
    assert tpd._plan(1, 1, 96, torch.bfloat16, torch.int8, 16).body == \
        "split"


def test_a_head_dim_96_neox_engine_gives_the_jax_engines_greedy_tokens():
    """neox-debug widened to two heads of 96 (gpt-neox-20b's head_dim):
    the port's engine on the CPU (the plain attend K4 is held to) against
    the JAX engine (its gather path at D 96), the same weights moved over
    as numpy: greedy tokens equal, bucketed and chunked prefill."""
    import jax

    from distributed_training_guide_tpu.models import get_model as jget
    from distributed_training_guide_tpu.serve import (
        Request as JRequest, ServeEngine as JServeEngine)
    from distributed_training_guide_tpu.serve.api import (
        generate_many as jgenerate)
    from distributed_training_guide_tpu_torch.models import (
        from_jax, get_model)
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many)

    over = dict(hidden_size=192, num_heads=2)
    jb = jget("neox-debug", dtype=jnp.float32, **over)
    jparams = jb.init(jb.config, jax.random.key(0))
    tb = get_model("neox-debug", dtype=torch.float32, **over)
    assert tb.config.head_size == D
    tparams = from_jax.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         device="cpu")
    prompts = [[3, 17, 42], [5, 6, 7, 8, 9, 10, 11, 12, 13], [9]]
    for chunk in (None, 4):
        kw = dict(n_slots=2, page_size=4, max_len=32, prefill_chunk=chunk)
        want = jgenerate(JServeEngine(jb, jparams, **kw), [
            JRequest(prompt_ids=p, max_new_tokens=6) for p in prompts])
        got = generate_many(ServeEngine(tb, tparams, device="cpu", **kw), [
            Request(prompt_ids=p, max_new_tokens=6) for p in prompts])
        assert [r.token_ids for r in got] == [r.token_ids for r in want]
