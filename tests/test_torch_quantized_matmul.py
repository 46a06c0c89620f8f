"""The port's block-dequant matmul against the JAX package's on the CPU.

The same int8 containers (quantized by the JAX package from numpy inputs
made from a seed, carried across bit for bit) go through both. The port's
plain standard form (what K7 computes, and what CPU tensors take) against
the JAX ``_matmul_xla`` and against the JAX Pallas kernel K7 in interpret
mode: fp32, 1e-5 absolute and relative (the same fp32 products, summed in
another order over K <= 64). The transpose form (tied head) against the
JAX ``_matmul_t_xla``: 1e-4, as the JAX tests bound it (per-block partial
products accumulated in order). ``quantized_take`` against JAX: 1e-6.
The errors raise as in JAX, and the plain standard form never holds the
whole fp32 weight."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distributed_training_guide_tpu.ops import quantized_matmul as jqm
from distributed_training_guide_tpu.train.precision import Quantized as JQ
from distributed_training_guide_tpu.train.precision import \
    quantize_blockwise as jquantize
from distributed_training_guide_tpu_torch.ops import quantized_matmul as tqm
from distributed_training_guide_tpu_torch.train.precision import (
    Quantized, dequantize_blockwise)
import torch_threads  # noqa: F401  (one torch thread a test process)

# (K, N, bs): engine-sized blocks, a short last block (33 = 32 + 1), a
# block size off every power of two, and the TPU kernel's bs = 128
CASES = [(64, 64, 32), (64, 512, 32), (64, 33, 32), (7, 10, 5),
         (64, 256, 128)]


def _pair(rng, shape, bs):
    """(JAX container, the port's) of one random weight."""
    w = rng.standard_normal(shape).astype(np.float32)
    jq = jquantize(jnp.asarray(w), block_size=bs)
    tq = Quantized(q=torch.from_numpy(np.array(jq.q)),
                   scale=torch.from_numpy(np.array(jq.scale)))
    return jq, tq


@pytest.mark.parametrize("k,n,bs", CASES,
                         ids=[f"K{k}-N{n}-bs{bs}" for k, n, bs in CASES])
def test_standard_form_matches_jax_xla_and_pallas_interpret(k, n, bs):
    rng = np.random.default_rng(k * 1000 + n + bs)
    jq, tq = _pair(rng, (k, n), bs)
    x = rng.standard_normal((5, k)).astype(np.float32)
    want_xla = np.asarray(jqm.quantized_matmul(jnp.asarray(x), jq,
                                               impl="xla"))
    want_k7 = np.asarray(jqm.quantized_matmul(jnp.asarray(x), jq,
                                              impl="pallas", interpret=True))
    before = tqm.LAUNCHES
    for impl in ("auto", "pallas", "xla"):
        got = tqm.quantized_matmul(torch.from_numpy(x), tq, impl=impl)
        assert got.dtype == torch.float32 and got.shape == (5, n)
        for want in (want_xla, want_k7):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
    assert tqm.LAUNCHES == before       # CPU tensors take the plain form
    # the bf16 epilogue is one rounding of the fp32 result
    got16 = tqm.quantized_matmul(torch.from_numpy(x), tq,
                                 out_dtype=torch.bfloat16)
    assert torch.equal(got16, got.to(torch.bfloat16))


def test_leading_dims_flatten_and_restore():
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (64, 96), 32)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    got = tqm.quantized_matmul(torch.from_numpy(x), tq)
    want = np.asarray(jqm.quantized_matmul(jnp.asarray(x), jq, impl="xla"))
    assert got.shape == (2, 3, 96)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v,e,bs", [(48, 64, 32), (96, 64, 32),
                                    (40, 50, 16)])
def test_transpose_form_matches_jax(v, e, bs):
    rng = np.random.default_rng(v + e)
    jq, tq = _pair(rng, (v, e), bs)
    x = rng.standard_normal((5, e)).astype(np.float32)
    want = np.asarray(jqm.quantized_matmul(jnp.asarray(x), jq,
                                           transpose=True, impl="xla"))
    for impl in ("auto", "xla"):
        got = tqm.quantized_matmul(torch.from_numpy(x), tq, transpose=True,
                                   impl=impl)
        assert got.shape == (5, v)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_quantized_take_matches_jax():
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng, (32, 48), 16)
    ids = np.array([[3, 31, 0], [7, 7, 1]], np.int32)
    want = np.asarray(jqm.quantized_take(jq, jnp.asarray(ids)))
    got = tqm.quantized_take(tq, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), dequantize_blockwise(tq).numpy()[ids], rtol=0, atol=0)


class _SqrtShim:
    def __init__(self, qt):
        self.q, self.scale, self.sqrt_domain = qt.q, qt.scale, True


def test_errors_raise_as_in_jax():
    rng = np.random.default_rng(5)
    jq, tq = _pair(rng, (64, 96), 32)
    jt, tt = _pair(rng, (48, 64), 32)
    x = np.zeros((5, 64), np.float32)
    three_d = {"jax": JQ(q=jnp.zeros((2, 4, 64), jnp.int8),
                         scale=jnp.ones((2, 4, 2))),
               "torch": Quantized(q=torch.zeros(2, 4, 64, dtype=torch.int8),
                                  scale=torch.ones(2, 4, 2))}
    for side, mm, xs, w, wt, cls in (
            ("jax", jqm.quantized_matmul, jnp.asarray(x), jq, jt, JQ),
            ("torch", tqm.quantized_matmul, torch.from_numpy(x), tq, tt,
             Quantized)):
        with pytest.raises(ValueError, match="impl"):
            mm(xs, wt, impl="cuda")
        with pytest.raises(ValueError, match="2-D"):
            mm(xs, three_d[side])
        with pytest.raises(ValueError, match="contraction mismatch"):
            mm(xs, cls(q=w.q[:32], scale=w.scale[:32]))
        with pytest.raises(ValueError, match="sqrt_domain"):
            mm(xs, _SqrtShim(wt))
        with pytest.raises(NotImplementedError, match="transpose"):
            mm(xs, wt, transpose=True, impl="pallas")


def test_eligibility_answers_for_the_hopper_kernel():
    """Every linear-domain 2-D standard-form container, the engine's bs =
    32 and short last blocks included; never the transpose form."""
    rng = np.random.default_rng(6)
    for shape, bs in (((64, 256), 32), ((64, 33), 32), ((7, 10), 5),
                      ((64, 256), 128)):
        _, tq = _pair(rng, shape, bs)
        assert tqm.quantized_matmul_eligible(tq)
        assert not tqm.quantized_matmul_eligible(tq, transpose=True)
    assert not tqm.quantized_matmul_eligible(_SqrtShim(tq))
    assert not tqm.quantized_matmul_eligible(
        Quantized(q=torch.zeros(2, 4, 64, dtype=torch.int8),
                  scale=torch.ones(2, 4, 2)))


class _Shapes(TorchDispatchMode):
    """Records (shape, dtype) of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.append((tuple(t.shape), t.dtype))
        return out


def test_plain_standard_form_never_builds_the_whole_fp32_weight():
    """What the JAX test pins in the decode HLO: no fp32 tensor of the
    weight's full [K, N] shape, only groups of whole column blocks."""
    rng = np.random.default_rng(7)
    _, tq = _pair(rng, (64, 512), 32)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    with _Shapes() as rec:
        out = tqm.quantized_matmul(x, tq)
    assert out.shape == (5, 512)
    assert ((64, 512), torch.float32) not in rec.seen
    # it did dequantize, half the blocks (256 columns) at a time
    widths = {s[1] for s, dt in rec.seen if dt == torch.float32
              and len(s) == 2 and s[0] == 64}
    assert 256 in widths and max(widths) < 512


def test_cpu_wrapper_takes_the_plain_version_without_a_launch():
    rng = np.random.default_rng(8)
    _, tq = _pair(rng, (64, 96), 32)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    before = tqm.LAUNCHES
    got = tqm.dequant_matmul(x, tq.q, tq.scale, torch.bfloat16)
    assert tqm.LAUNCHES == before
    assert torch.equal(got, tqm.quantized_matmul_reference(
        x, tq.q, tq.scale).to(torch.bfloat16))
