"""The port's sampler (``models/sample.py``) and the contiguous-cache
``decode_step`` of the llama and moe families against the JAX package's
on the CPU, with weights carried across by the weight bridge (fp32).

- ``decode_step``: a prefill, then three steps fed JAX's greedy tokens;
  logits within 1e-4 and the cache within 1e-5 (the bounds of
  ``tests/test_torch_llama.py``; gpt2 and neox are held in their own
  files).
- The sampler: greedy tokens identical to JAX's ``make_sampler`` in the
  recompute and the ``kv_cache`` modes, for gpt2-debug and neox-debug
  (one prompt per family runs to the learned table's last row on gpt2).
- At temperature > 0 the two modes of the port draw from one stream of
  (seed, position), so they give the same tokens; the length guard
  refuses a generation past the position table."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.models import sample as jsample
from distributed_training_guide_tpu.models.registry import \
    family_module as jfamily
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.models import sample as tsample
from distributed_training_guide_tpu_torch.models.registry import \
    family_module
import torch_threads  # noqa: F401  (one torch thread a test process)

LOGIT_TOL = 1e-4
KV_TOL = 1e-5


def _bridge(name):
    jb = jget_model(name, dtype=jnp.float32)
    jparams = jb.init(jb.config, jax.random.key(0))
    tb = get_model(name, dtype=torch.float32)
    tparams = from_jax.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, tb, tparams


@pytest.fixture(scope="module")
def bridges():
    return {name: _bridge(name) for name in
            ("llama-debug", "moe-debug", "gpt2-debug", "neox-debug")}


@pytest.mark.parametrize("name", ["llama-debug", "moe-debug"])
def test_decode_step_matches_jax(bridges, name):
    jb, jparams, tb, tparams = bridges[name]
    jmod, tmod = jfamily(jb.family), family_module(tb.family)
    ids = np.random.default_rng(4).integers(0, 512, (2, 9)).astype(np.int32)
    jlogit, jcache = jmod.prefill(jb.config, jparams, jnp.asarray(ids),
                                  jmod.init_cache(jb.config, 2, 16))
    _, tcache = tmod.prefill(tb.config, tparams, torch.from_numpy(ids),
                             tmod.init_cache(tb.config, 2, 16, device="cpu"))
    for pos in range(9, 12):
        tok = np.array(jnp.argmax(jlogit, -1), np.int32)[:, None]
        jlogit, jcache = jmod.decode_step(jb.config, jparams,
                                          jnp.asarray(tok), pos, jcache)
        tlogit, tcache = tmod.decode_step(tb.config, tparams,
                                          torch.from_numpy(tok), pos, tcache)
        np.testing.assert_allclose(tlogit.numpy(), np.asarray(jlogit),
                                   rtol=0, atol=LOGIT_TOL, err_msg=str(pos))
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), rtol=0,
                                       atol=KV_TOL)


CASES = [("gpt2-debug", 5, 12), ("gpt2-debug", 248, 8),
         ("neox-debug", 5, 12)]


@pytest.mark.parametrize("kv_cache", [False, True], ids=["recompute",
                                                         "kv_cache"])
@pytest.mark.parametrize("name,n,steps", CASES,
                         ids=["gpt2", "gpt2-table-end", "neox"])
def test_greedy_tokens_equal_jax_make_sampler(bridges, name, n, steps,
                                              kv_cache):
    jb, jparams, tb, tparams = bridges[name]
    prompt = [int(x) for x in np.random.default_rng(n).integers(3, 500, n)]
    want = jsample.make_sampler(jb, kv_cache=kv_cache)(jparams, prompt,
                                                       steps)
    got = tsample.make_sampler(tb, kv_cache=kv_cache, device="cpu")(
        tparams, prompt, steps)
    assert got == [int(x) for x in want]
    assert len(got) == n + steps and got[:n] == prompt


def test_sampled_tokens_agree_between_modes_and_length_guard(bridges):
    _, _, tb, tparams = bridges["gpt2-debug"]
    prompt = [7, 8, 9]
    hot = [tsample.make_sampler(tb, temperature=0.9, kv_cache=kv,
                                device="cpu")(tparams, prompt, 10, rng=3)
           for kv in (False, True)]
    assert hot[0] == hot[1]
    cold = tsample.make_sampler(tb, device="cpu")(tparams, prompt, 10)
    assert hot[0] != cold
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tsample.make_sampler(tb, device="cpu")(tparams, [1] * 250, 7)


def test_cli_prints_prompt_and_tokens(capsys):
    tsample.main(["-m", "gpt2-debug", "--prompt-ids", "3,17,42",
                  "--steps", "4", "--kv-cache", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert len(out) == 7 and out[:3] == ["3", "17", "42"]
