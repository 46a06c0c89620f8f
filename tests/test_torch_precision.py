"""The port's precision policies against the JAX package's on the CPU: the
block-wise int8 quantization (payload and scales bitwise equal, linear and
sqrt domain, ragged trailing axes), one wrapped AdamW step under
``bf16-master`` (within 1 bf16 ulp) and ``adam8bit`` (params within 1e-6
fp32 relative, the moments' int8 payloads within one step and their
scales within 1e-6), and the ``+`` compositions. Inputs are made with
numpy from a seed. The wrapped AdamW steps against JAX and the tp-sharded
adam8bit gang are in ``tests/test_torch_precision_runs.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.train import precision as jprec
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train import precision as tprec
import torch_threads  # noqa: F401  (one torch thread a test process)

# (shape, block): ragged trailing axes (200 / 128 -> 2 blocks of 100, 7 in
# one block, 130 / 64 -> 3 blocks of 44 with a short last block) and exact
# tilings, 1-d to 3-d
QUANT_CASES = [((4, 200), 128), ((3, 7), 128), ((2, 3, 130), 64),
               ((256,), 128), ((5, 128), 32)]


@pytest.mark.parametrize("shape,block", QUANT_CASES,
                         ids=lambda c: str(c).replace(" ", ""))
@pytest.mark.parametrize("sqrt_domain", [False, True], ids=["linear", "sqrt"])
def test_quantize_blockwise_bitwise_equal_to_jax(shape, block, sqrt_domain):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if sqrt_domain:
        x = x * x                       # nu is non-negative
    x[..., 0] = 0.0                     # an all-zero block's scale is 1/127
    jq = jprec.quantize_blockwise(jnp.asarray(x), block,
                                  sqrt_domain=sqrt_domain)
    tq = tprec.quantize_blockwise(torch.from_numpy(x), block,
                                  sqrt_domain=sqrt_domain)
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    assert np.array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert np.array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert np.array_equal(
        tprec.dequantize_blockwise(tq, sqrt_domain=sqrt_domain).numpy(),
        np.asarray(jprec.dequantize_blockwise(jq, sqrt_domain=sqrt_domain)))
    assert tprec.block_geometry(shape[-1], block) == jprec.block_geometry(
        shape[-1], block)


def test_scalar_passes_through_quantization():
    out = tprec.quantize_blockwise(torch.tensor(2.5))
    assert not isinstance(out, tprec.Quantized) and float(out) == 2.5


@pytest.mark.parametrize("spec", [
    None, "fp32", "bf16-master", "adam8bit", "bf16-master+adam8bit",
    "adam8bit+bf16-master", "fp32+adam8bit"])
def test_compositions_resolve_as_jax(spec):
    names = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
             None: None}
    j = jprec.resolve_policy(spec)
    t = tprec.resolve_policy(spec)
    assert t.name == j.name
    assert t.param_dtype == names[j.param_dtype]
    assert t.moment_dtype == names[j.moment_dtype]
    assert t.accum_dtype == names[j.accum_dtype]
    assert (t.quantize_moments, t.block_size, t.is_noop) == (
        j.quantize_moments, j.block_size, j.is_noop)


@pytest.mark.parametrize("spec", ["fp16", "bf16-master+nope", ""])
def test_unknown_policies_raise_in_both(spec):
    with pytest.raises(ValueError):
        jprec.resolve_policy(spec)
    with pytest.raises(ValueError, match="unknown precision policy"):
        tprec.resolve_policy(spec)


def test_store_and_load_opt_state_round_trip():
    pol = tprec.resolve_policy("bf16-master+adam8bit")
    kinds = {"exp_avg": tprec.ADAM_MU, "exp_avg_sq": tprec.ADAM_NU,
             "mu": tprec.OTHER}
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 40)).astype(np.float32))
    state = {"w": {"exp_avg": g, "exp_avg_sq": g * g, "mu": g}}
    stored = pol.store_opt_state(state, kinds)
    assert isinstance(stored["w"]["exp_avg"], tprec.Quantized)
    assert isinstance(stored["w"]["exp_avg_sq"], tprec.Quantized)
    assert stored["w"]["mu"].dtype == torch.bfloat16  # bf16-master's dtype
    back = pol.load_opt_state(stored, kinds)
    for k in kinds:
        assert back["w"][k].dtype == torch.float32
    # one int8 step of the block's absmax / 127 (sqrt domain: of sqrt(nu))
    assert torch.allclose(back["w"]["exp_avg"], g, rtol=0,
                          atol=float(g.abs().max()) / 127)


def test_bf16_master_keeps_every_store_bf16():
    tpol = tprec.resolve_policy("bf16-master")
    params = tpol.cast_params({"w": torch.ones(4, 8)})
    ost = topt.adamw_cosine(1e-3).init(list(params.values()), tpol)
    params["w"].grad = torch.full((4, 8), 0.5, dtype=torch.bfloat16)
    ost.step()
    assert params["w"].dtype == torch.bfloat16
    assert all(v.dtype == torch.bfloat16
               for v in ost.optimizer.state[params["w"]].values())
