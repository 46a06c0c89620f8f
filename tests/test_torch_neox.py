"""The port's neox family against the JAX package's on the CPU, at
neox-debug size (2 layers, E 64, 4 heads of 16, partial rotary over 4 of
them, the parallel residual): the checks of ``tests/test_torch_gpt2.py``
on this family's fixtures, plus the sequential-residual wiring, the
partial rope at pythia's widths and the exact GELU. Bounds as there."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import neox as jneox
from distributed_training_guide_tpu_torch.models import neox as tneox

from test_torch_gpt2 import (  # noqa: F401  (fixtures and shared checks)
    LOGIT_TOL, KV_TOL, bridged, test_apply_matches_jax,
    test_cli_trajectory_follows_the_jax_cli, test_decode_step_matches_jax,
    test_init_layout_and_axes_match_jax, test_paged_decode_step_matches_jax,
    test_prefill_logits_and_cache_match_jax,
    test_prefill_pad_rows_stay_inside_the_table)
import torch_threads  # noqa: F401  (one torch thread a test process)


@pytest.fixture(scope="module")
def model_name():
    return "neox-debug"


@pytest.mark.parametrize("act_fn", ["gelu", "gelu_tanh"])
def test_sequential_residual_and_activations_match_jax(bridged, act_fn):
    """``use_parallel_residual=False`` (gpt2-shaped wiring) under both
    activations: logits against JAX within ``LOGIT_TOL``; the exact and
    tanh GELU differ by more than that on these inputs."""
    jb, jparams, tb, tparams = bridged
    jcfg = dataclasses.replace(jb.config, use_parallel_residual=False,
                               act_fn=act_fn)
    tcfg = dataclasses.replace(tb.config, use_parallel_residual=False,
                               act_fn=act_fn)
    ids = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(np.int32)
    jlog = np.asarray(jneox.apply(jcfg, jparams, jnp.asarray(ids)))
    tlog = tneox.apply(tcfg, tparams, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("name,dims", [("pythia-410m", 16),
                                       ("pythia-1.4b", 32)])
def test_partial_rope_matches_jax_at_pythia_widths(name, dims):
    """The rotary width (16 of 64, 32 of 128) and its frequencies over
    that width: q rotated by the port and by JAX's ``_rope_partial`` agree
    within ``KV_TOL`` at positions up to 2047."""
    tcfg = tneox.PRESETS[name]
    assert tcfg.rotary_ndims == dims
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 9, 2, tcfg.head_size)).astype(np.float32)
    pos = np.array([[0, 1, 2, 100, 511, 1000, 1500, 2000, 2047]])
    want = np.asarray(jneox._rope_partial(jnp.asarray(x), jnp.asarray(pos),
                                          jneox.PRESETS[name]))
    got = tneox.rope_partial(torch.from_numpy(x),
                             tneox.layer_rope(tcfg, torch.from_numpy(pos)),
                             tcfg.rotary_ndims).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=KV_TOL)
    np.testing.assert_array_equal(got[..., dims:], x[..., dims:])
