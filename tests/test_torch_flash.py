"""The port's flash attention against the JAX package's on the CPU: the
plain versions of K1 (forward) and K2 / K3 (backward from given lse and
delta) against the Pallas kernels run in interpret mode, as
``tests/test_flash_attention.py`` runs them (B 2, S 64, blocks of 32,
head_dim 32), then autograd through ``flash_attention`` against
``jax.grad``, and the ``multihead_attention`` dispatch. Inputs come from
``numpy.random.default_rng`` and go to both packages.

Bounds, in fp32: forward (o, lse) 1e-5 abs (the same online softmax in
another tile order on O(1) values); backward 1e-4 abs (three products over
64 keys, each summed in another order). A row with no live key is held in
the forward only: both give o = 0 and lse = -1e30, but in backward the
Pallas kernels' exp(NEG_INF - lse) is 1 on that row's masked lanes, where
the port gives 0 (the gradient of a constant output)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.ops import flash_attention as jfa
from distributed_training_guide_tpu_torch.ops import attention as tattn
from distributed_training_guide_tpu_torch.ops import flash_attention as tfa
import torch_threads  # noqa: F401  (one torch thread a test process)

FWD_TOL = 1e-5
BWD_TOL = 1e-4
B, S, D, BLOCK = 2, 64, 32, 32

# name: (hq, hkv, causal, window, softcap, scale, (q_off, k_off) or None)
CASES = {
    "gqa": (4, 2, True, None, None, None, None),
    "mha": (4, 4, True, None, None, None, None),
    "noncausal": (4, 2, False, None, None, None, None),
    "window16": (4, 2, True, 16, None, None, None),
    "softcap_scale": (4, 2, True, None, 50.0, 0.3, None),
    "band_offsets": (4, 2, True, 24, None, None, (16, 8)),
    "masked_rows": (4, 2, True, None, None, None, (0, 8)),
}


def _inputs(hq, hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, hq, D)).astype(np.float32)
    return q, k, v, do


def _bhsd(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3)


def _jax_fwd(q, k, v, case):
    _, _, causal, window, softcap, scale, offs = case
    band = None if offs is None else jfa._pack_band(window, *offs)
    o, lse = jfa._flash_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal,
                            None if band is not None else window, BLOCK,
                            BLOCK, True, scale=scale, softcap=softcap,
                            band=band)
    return np.array(o.transpose(0, 2, 1, 3)), np.array(lse), band


def _torch_kw(case):
    _, _, causal, window, softcap, scale, offs = case
    band = None if offs is None else tfa.pack_band(window, *offs)
    return dict(causal=causal, window=None if band is not None else window,
                scale=scale, softcap=softcap, band=band)


def test_pack_band_is_the_jax_encoding():
    for args in ((None,), (16,), (24, 16, 8)):
        assert (tfa.pack_band(*args).numpy()
                == np.asarray(jfa._pack_band(*args))).all()


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax_interpret(name):
    case = CASES[name]
    q, k, v, _ = _inputs(*case[:2])
    jo, jlse, _ = _jax_fwd(q, k, v, case)
    to, tlse = tfa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **_torch_kw(case))
    np.testing.assert_allclose(to.numpy(), jo, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), jlse, rtol=0, atol=FWD_TOL)
    if name == "masked_rows":        # rows 0..7 see no key (k_off = 8)
        assert (to[:, :8] == 0).all()
        assert (tlse[..., :8] == tfa.NEG_INF).all()


@pytest.mark.parametrize("name", list(CASES))
def test_backward_from_stats_matches_jax_interpret(name):
    case = CASES[name]
    hq, hkv, causal, window, softcap, scale, _ = case
    q, k, v, do = _inputs(hq, hkv, seed=1)
    jo, jlse, band = _jax_fwd(q, k, v, case)
    delta = np.einsum("bshd,bshd->bhs", do, jo).astype(np.float32)
    jgrads = jfa.flash_bwd_with_stats(
        _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(do), jnp.asarray(jlse),
        jnp.asarray(delta), causal=causal,
        window=None if band is not None else window, block_q=BLOCK,
        block_k=BLOCK, interpret=True, scale=scale, softcap=softcap,
        band=band)
    tgrads = tfa.flash_bwd_with_stats(
        *(torch.from_numpy(x) for x in (q, k, v, do, jlse, delta)),
        **_torch_kw(case))
    for label, jg, tg in zip(("dq", "dk", "dv"), jgrads, tgrads):
        jg = np.asarray(jg.transpose(0, 2, 1, 3))
        if name == "masked_rows":
            if label != "dq":        # the Pallas masked lanes give p = 1
                continue
            assert (tg[:, :8] == 0).all()
            jg, tg = jg[:, 8:], tg[:, 8:]
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=BWD_TOL,
                                   err_msg=label)


@pytest.mark.parametrize("window,softcap", [(None, None), (16, 50.0)])
def test_autograd_matches_jax_grad(window, softcap):
    q, k, v, _ = _inputs(4, 2, seed=2)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=True, window=window,
                                block_q=BLOCK, block_k=BLOCK, interpret=True,
                                logit_softcap=softcap)
        return jnp.sum(o * jnp.cos(o))

    jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = tfa.FWD_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES
    o = tfa.flash_attention(tq, tk, tv, causal=True, window=window,
                            logit_softcap=softcap)
    tl = torch.sum(o * torch.cos(o))
    tl.backward()
    assert (tfa.FWD_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES) == before
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for label, jg, t in zip("qkv", jgrads, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=0,
                                   atol=BWD_TOL, err_msg=f"d{label}")


def test_multihead_attention_dispatch_on_cpu():
    q, k, v, _ = _inputs(4, 2, seed=3)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    plain = tattn._xla_attention(q, k, v, True, None, None)
    # auto never picks the kernel for a CPU tensor, aligned shapes or not
    assert torch.equal(tattn.multihead_attention(q, k, v), plain)
    flash = tattn.multihead_attention(q, k, v, impl="flash", window=16)
    ref, _ = tfa.flash_attention_reference(q, k, v, causal=True, window=16)
    assert torch.equal(flash, ref)
    with pytest.raises(ValueError, match="impl"):
        tattn.multihead_attention(q, k, v, impl="pallas")
