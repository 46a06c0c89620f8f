"""The flash backward's plain version at the bf16 kernels' arithmetic
(``round_p_ds=True``) against the JAX Pallas kernels in interpret mode,
within the card tests' bf16 bound, relative L2 1e-2, over the cases of
``tests/test_torch_flash_bwd.py`` (its helpers and cases). Split from
that file, whose test count puts it early in pytest-xdist's loadfile
queue: a file of few tests runs late, after the JAX package's
``tests/test_pipeline.py``, whose start bounds the tier-1 run."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_bwd import (BF16_REL_L2, BLOCK, CASES, _inputs, _plain,
                                  _stats, _torch_kw)

from distributed_training_guide_tpu.ops import flash_attention as jfa
import torch_threads  # noqa: F401  (one torch thread a test process)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_arithmetic_matches_jax_interpret_in_bf16(name):
    case = CASES[name]
    sq, sk, hq, hkv, causal, window, softcap, scale, offs = case
    q, k, v, do = _inputs(sq, sk, hq, hkv, seed=3)
    kw = _torch_kw(case)
    lse, delta = _stats(q, k, v, do, kw)
    band = None if offs is None else jfa._pack_band(window, *offs)

    def bhsd(x):
        return jnp.asarray(x, dtype=jnp.bfloat16).transpose(0, 2, 1, 3)

    jgrads = jfa.flash_bwd_with_stats(
        bhsd(q), bhsd(k), bhsd(v), bhsd(do), jnp.asarray(lse),
        jnp.asarray(delta), causal=causal,
        window=None if band is not None else window, block_q=BLOCK,
        block_k=BLOCK, interpret=True, scale=scale, softcap=softcap,
        band=band)
    tgrads = _plain(q, k, v, do, lse, delta, torch.bfloat16, kw, True)
    for label, jg, tg in zip(("dq", "dk", "dv"), jgrads, tgrads):
        assert tg.dtype == torch.bfloat16
        want = np.asarray(jg.transpose(0, 2, 1, 3).astype(jnp.float32))
        got = tg.float().numpy()
        assert np.isfinite(got).all(), label
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_REL_L2, (label, err)
