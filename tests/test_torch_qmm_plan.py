"""The block-dequant matmul's choice of body and the tensor-core body's
arithmetic, on the CPU.

``_qmm_plan`` names K7's body from the operands' dtypes and 16-byte
alignment alone; it is pinned here case by case, and the load-time check
of the library's own table (``qmm_body``) is shown to refuse a table that
departs from it in any one of its conditions.

The tensor-core body forms each weight w = q * scale in fp32, splits it
into bf16 hi and lo and sums two bf16 products in fp32:
``quantized_matmul_reference(split_w=True)`` is that arithmetic in plain
PyTorch. It is held against the JAX ``_matmul_xla`` and the JAX Pallas
kernel K7 in interpret mode, with containers quantized by the JAX package
from numpy inputs made from a seed, over llama-debug's projection and head
widths at the engine's bs = 32, bs 128, bs 24 and a short last block:
within 1e-5 relative L2, since hi + lo misses w by at most 2**-16 |w|
(about 2**-18 typically) and the rest is fp32 summation order. The split
itself is held to that 2**-16 bound element by element."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.ops import quantized_matmul as jqm
from distributed_training_guide_tpu.train.precision import \
    quantize_blockwise as jquantize
from distributed_training_guide_tpu_torch.ops import quantized_matmul as tqm
from distributed_training_guide_tpu_torch.train.precision import Quantized
import torch_threads  # noqa: F401  (one torch thread a test process)

BF, I8, F32 = torch.bfloat16, torch.int8, torch.float32


def _at(shape, dtype, off=0):
    """A zero tensor of ``shape`` at an element offset ``off`` from an
    aligned allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + off, dtype=dtype)[off:].view(*shape)


X, Q, S = _at((8, 64), BF), _at((64, 128), I8), _at((64, 4), F32)
PLAN_CASES = {
    "bf16 x, all on 16": (X, Q, S, "wgmma"),
    "fp32 x": (X.float(), Q, S, "fma"),
    "x base +16 bytes": (_at((8, 64), BF, 8), Q, S, "wgmma"),
    "x base +2 bytes": (_at((8, 64), BF, 1), Q, S, "fma"),
    "x row 200 bytes (K 100)": (_at((8, 100), BF), _at((100, 128), I8),
                                _at((100, 4), F32), "fma"),
    "q base +16 bytes": (X, _at((64, 128), I8, 16), S, "wgmma"),
    "q base +1 byte": (X, _at((64, 128), I8, 1), S, "fma"),
    "q row 72 bytes (N 72)": (X, _at((64, 72), I8), S, "fma"),
    "q row 4113 bytes (the tail case)": (X, _at((64, 4113), I8),
                                         _at((64, 4), F32), "fma"),
    "scale base +16 bytes": (X, Q, _at((64, 4), F32, 4), "wgmma"),
    "scale base +4 bytes": (X, Q, _at((64, 4), F32, 1), "fma"),
    "scale row 8 bytes (bs 64)": (X, Q, _at((64, 2), F32), "fma"),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_qmm_plan_names_the_body(name):
    x, q, scale, body = PLAN_CASES[name]
    assert tqm._qmm_plan(x, q, scale) == body


CONDITIONS = ["x_dtype", "x_base", "x_row", "q_base", "q_row", "scale_base",
              "scale_row"]


def _c_body_for(drop=None):
    """The library's ``body_for`` rule written out in Python, with the
    condition ``drop`` left out (a mutant of the table)."""
    def qmm_body(xdt, x, k, q, n, scale, nb):
        conds = {"x_dtype": xdt == 1, "x_base": x % 16 == 0,
                 "x_row": k * 2 % 16 == 0, "q_base": q % 16 == 0,
                 "q_row": n % 16 == 0, "scale_base": scale % 16 == 0,
                 "scale_row": nb * 4 % 16 == 0}
        conds.pop(drop, None)
        if drop == "wgmma_to_fma":
            return 0
        return 1 if all(conds.values()) else 0
    return types.SimpleNamespace(qmm_body=qmm_body)


def test_body_table_check_passes_the_library_rule():
    tqm._check_body_table(_c_body_for())


@pytest.mark.parametrize("drop", CONDITIONS + ["wgmma_to_fma"])
def test_body_table_check_refuses_a_library_that_disagrees(drop):
    """Each condition of the rule matters for some case of
    ``_plan_cases``: a table without it is refused before any launch."""
    with pytest.raises(RuntimeError, match="_qmm_plan names"):
        tqm._check_body_table(_c_body_for(drop))


def test_plan_cases_take_both_bodies():
    bodies = {tqm._qmm_plan(*case) for case in tqm._plan_cases()}
    assert bodies == {"fma", "wgmma"}


def test_split_misses_each_weight_by_at_most_2_to_the_minus_16():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(np.concatenate([
        rng.standard_normal(20000) * 0.02,
        rng.integers(-127, 128, 20000) * rng.uniform(1e-4, 1e-2, 20000),
    ]).astype(np.float32))
    got = tqm.split_bf16(w)
    hi = w.to(BF)
    lo = (w - hi.float()).to(BF)
    # hi + lo is exact in fp32, so the split is the sum of its two parts
    assert torch.equal(got, hi.float() + lo.float())
    assert bool(((got - w).abs() <= 2.0 ** -16 * w.abs()).all())
    # bf16 values split into themselves
    assert torch.equal(tqm.split_bf16(hi.float()), hi.float())


# llama-debug's standard-form widths at the engine's bs = 32 (wq / wo, wk /
# wv, gate / up, down, the untied head), bs 128, bs 24 and a short last block
SPLIT_CASES = [("wq", 64, 64, 32), ("wk", 64, 32, 32), ("gate", 64, 128, 32),
               ("down", 128, 64, 32), ("head", 64, 512, 32),
               ("gate-bs128", 64, 256, 128), ("wq-bs24", 64, 64, 24),
               ("short-block", 64, 33, 32)]


@pytest.mark.parametrize("name,k,n,bs", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_split_reference_matches_jax_xla_and_pallas_interpret(name, k, n, bs):
    rng = np.random.default_rng(k * 1000 + n + bs)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    jq = jquantize(jnp.asarray(w), block_size=bs)
    tq = Quantized(q=torch.from_numpy(np.array(jq.q)),
                   scale=torch.from_numpy(np.array(jq.scale)))
    # bf16 activations, as the engine's (exact in either package)
    x = torch.from_numpy(rng.standard_normal((8, k)).astype(np.float32)
                         ).to(BF)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    want_xla = np.asarray(jqm.quantized_matmul(xj, jq, impl="xla"))
    want_k7 = np.asarray(jqm.quantized_matmul(xj, jq, impl="pallas",
                                              interpret=True))
    got = tqm.quantized_matmul_reference(x, tq.q, tq.scale, split_w=True)
    assert got.dtype == F32 and got.shape == (8, n)
    for want in (want_xla, want_k7):
        err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert err <= 1e-5, (name, err)
    # the split is not exact: it differs from the fp32 plain version
    plain = tqm.quantized_matmul_reference(x, tq.q, tq.scale)
    assert not torch.equal(got, plain)
