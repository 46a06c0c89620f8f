"""The port's gpt2 family against the JAX package's on the CPU, at
gpt2-debug size (2 layers, E 64, 4 heads of 64) with weights carried
across by the weight bridge (fp32) and inputs from a numpy seed: the init
layout, ``apply`` (einsum and flash attention, remat, hidden states),
the bucketed ``prefill`` (logits and the k/v cache; one prompt ends at the
learned position table's last row), ``paged_decode_step`` at T = 1 and at
a padded prefill chunk (the JAX side through its gather path, the Pallas
kernel's plain reference), the contiguous-cache ``decode_step``, and a
3-step ``run_training`` trajectory against the JAX CLI's.

The helpers take the family's fixtures, so ``tests/test_torch_neox.py``
runs the same checks on neox-debug. Bounds: logits 1e-4 (two layers of
fp32 matmuls and norms in another reduction order, on logits of size ~1),
k/v 1e-5 (one projection, plus the partial rope for neox), the CLI
trajectory 1e-3 relative (bf16 compute in two frameworks, as
``tests/test_torch_train.py`` holds llama's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.serve import kv_pages as jkv
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.models import gpt2 as tgpt2
from distributed_training_guide_tpu_torch.models.registry import \
    family_module
from distributed_training_guide_tpu_torch.ops import flash_attention as tfa
from distributed_training_guide_tpu_torch.serve import kv_pages as tkv
from distributed_training_guide_tpu_torch.train import cli as tcli
import torch_threads  # noqa: F401  (one torch thread a test process)

LOGIT_TOL = 1e-4
KV_TOL = 1e-5
CLI_LOSS_RTOL = 1e-3


@pytest.fixture(scope="module")
def model_name():
    return "gpt2-debug"


@pytest.fixture(scope="module")
def bridged(model_name):
    jb = jget_model(model_name, dtype=jnp.float32)
    jparams = jb.init(jb.config, jax.random.key(0))
    tb = get_model(model_name, dtype=torch.float32)
    tparams = from_jax.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, tb, tparams


def _jmod(jb):
    from distributed_training_guide_tpu.models.registry import \
        family_module as jfamily

    return jfamily(jb.family)


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_init_layout_and_axes_match_jax(bridged):
    """The port's init draws the JAX tree (paths, shapes, dtypes), with
    the same param count and logical axes."""
    jb, jparams, tb, _ = bridged
    mine = tb.init(tb.config, 0, device="cpu")
    want = {p: (tuple(x.shape), str(x.dtype)) for p, x in
            _leaves_with_paths(jax.tree.map(np.asarray, jparams))}
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in _leaves_with_paths(mine)}
    assert got == want
    assert tb.config.num_params() == jb.config.num_params()
    tmod = family_module(tb.family)
    assert tmod.param_logical_axes(tb.config) == \
        _jmod(jb).param_logical_axes(jb.config)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_apply_matches_jax(bridged, attn_impl):
    jb, jparams, tb, tparams = bridged
    ids = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32)
    jlog = jb.apply(jb.config, jparams, jnp.asarray(ids), attn_impl=attn_impl)
    tids = torch.from_numpy(ids)
    before = tfa.FWD_LAUNCHES
    tlog = tb.apply(tb.config, tparams, tids, attn_impl=attn_impl)
    assert tfa.FWD_LAUNCHES == before          # CPU: the plain versions
    assert tlog.dtype == torch.float32 and tlog.shape == (2, 16, 512)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=LOGIT_TOL)
    for policy in ("all", "attn_mlp"):
        remat = tb.apply(tb.config, tparams, tids, attn_impl=attn_impl,
                         remat=True, remat_policy=policy)
        assert torch.equal(remat, tlog), policy
    jhid = jb.apply(jb.config, jparams, jnp.asarray(ids),
                    attn_impl=attn_impl, return_hidden=True)
    thid = tb.apply(tb.config, tparams, tids, attn_impl=attn_impl,
                    return_hidden=True)
    np.testing.assert_allclose(thid.numpy(), np.asarray(jhid), rtol=0,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("prompt", [11, 256], ids=["short", "table_end"])
def test_prefill_logits_and_cache_match_jax(bridged, prompt):
    """A short prompt read at an inner position, and one of 256 tokens
    that ends at the position table's last row (gpt2-debug's 256)."""
    jb, jparams, tb, tparams = bridged
    jmod, tmod = _jmod(jb), family_module(tb.family)
    ids = np.random.default_rng(prompt).integers(0, 512, (2, prompt)
                                                 ).astype(np.int32)
    last = 7 if prompt == 11 else None
    jcache = jmod.init_cache(jb.config, 2, prompt)
    jlogit, jcache = jmod.prefill(jb.config, jparams, jnp.asarray(ids),
                                  jcache, last_pos=last)
    tcache = tmod.init_cache(tb.config, 2, prompt, device="cpu")
    tlogit, tcache = tmod.prefill(tb.config, tparams, torch.from_numpy(ids),
                                  tcache, last_pos=last)
    assert np.isfinite(np.asarray(jlogit)).all()
    np.testing.assert_allclose(tlogit.numpy(), np.asarray(jlogit), rtol=0,
                               atol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=0,
                                   atol=KV_TOL)


def test_prefill_pad_rows_stay_inside_the_table(bridged):
    """A bucket longer than the learned table (pad rows past row 255) runs,
    and its real rows equal the unpadded prefill's."""
    _, _, tb, tparams = bridged
    tmod = family_module(tb.family)
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (1, 300)))
    n = 250
    pad = tmod.prefill(tb.config, tparams, ids,
                       tmod.init_cache(tb.config, 1, 300, device="cpu"),
                       last_pos=n - 1)
    real = tmod.prefill(tb.config, tparams, ids[:, :n],
                        tmod.init_cache(tb.config, 1, n, device="cpu"))
    torch.testing.assert_close(pad[0], real[0], rtol=0, atol=KV_TOL)
    torch.testing.assert_close(pad[1]["k"][:, :, :n], real[1]["k"], rtol=0,
                               atol=KV_TOL)


def _pools(rng, config, n_pages, page):
    shape = (config.num_layers, n_pages, page, config.num_heads,
             config.head_size)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


@pytest.mark.parametrize("t", [1, 4])
def test_paged_decode_step_matches_jax(bridged, t):
    """T = 1: three slots (one idle on the trash page) decode one token
    over shuffled tables. T = 4: one slot runs a prefill chunk whose last
    token is padding. Logits and the updated pools (but the trash page)
    against the JAX step through its gather path."""
    jb, jparams, tb, tparams = bridged
    jmod, tmod = _jmod(jb), family_module(tb.family)
    rng = np.random.default_rng(10 * t)
    page, n_pages, m = 4, 16, 4
    if t == 1:
        s = 3
        tables = np.zeros((s, m), np.int32)
        phys = rng.permutation(np.arange(1, n_pages))
        tables[0, :3] = phys[:3]
        tables[1, :2] = phys[3:5]
        lengths = np.array([9, 5, 0], np.int32)
        n_valid, last_index = None, None
    else:
        s = 1
        tables = np.zeros((s, m), np.int32)
        tables[0, :3] = rng.permutation(np.arange(1, n_pages))[:3]
        lengths = np.array([6], np.int32)
        n_valid, last_index = np.array([3], np.int32), 2
    ids = rng.integers(0, 512, (s, t)).astype(np.int32)
    jpools, tpools = _pools(rng, tb.config, n_pages, page)
    tout, tcache = tmod.paged_decode_step(
        tb.config, tparams, torch.from_numpy(ids), torch.from_numpy(lengths),
        tpools, tkv.make_attend(
            torch.from_numpy(tables), torch.from_numpy(lengths),
            n_valid=None if n_valid is None else torch.from_numpy(n_valid)),
        last_index=last_index)
    jout, jcache = jmod.paged_decode_step(
        jb.config, jparams, jnp.asarray(ids), jnp.asarray(lengths), jpools,
        jkv.make_attend(jnp.asarray(tables), jnp.asarray(lengths),
                        impl="xla",
                        n_valid=None if n_valid is None
                        else jnp.asarray(n_valid)),
        last_index=last_index)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy()[:, 1:],
                                   np.asarray(jcache[name])[:, 1:], rtol=0,
                                   atol=KV_TOL)


def test_decode_step_matches_jax(bridged):
    """The contiguous cache: a 9-token prefill, then three decode steps
    fed JAX's greedy tokens; logits and the cache after each step."""
    jb, jparams, tb, tparams = bridged
    jmod, tmod = _jmod(jb), family_module(tb.family)
    ids = np.random.default_rng(5).integers(0, 512, (2, 9)).astype(np.int32)
    jlogit, jcache = jmod.prefill(jb.config, jparams, jnp.asarray(ids),
                                  jmod.init_cache(jb.config, 2, 16))
    tlogit, tcache = tmod.prefill(
        tb.config, tparams, torch.from_numpy(ids),
        tmod.init_cache(tb.config, 2, 16, device="cpu"))
    for pos in range(9, 12):
        tok = np.array(jnp.argmax(jlogit, -1), np.int32)[:, None]
        jlogit, jcache = jmod.decode_step(jb.config, jparams,
                                          jnp.asarray(tok), pos, jcache)
        tlogit, tcache = tmod.decode_step(tb.config, tparams,
                                          torch.from_numpy(tok), pos, tcache)
        np.testing.assert_allclose(tlogit.numpy(), np.asarray(jlogit),
                                   rtol=0, atol=LOGIT_TOL, err_msg=str(pos))
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), rtol=0,
                                       atol=KV_TOL)


def test_cli_trajectory_follows_the_jax_cli(model_name, monkeypatch):
    """Both CLIs, 3 steps on the same synthetic batches from the JAX CLI's
    own init (carried across): the running losses agree within
    ``CLI_LOSS_RTOL``."""
    from distributed_training_guide_tpu.parallel import make_mesh, make_plan
    from distributed_training_guide_tpu.train import cli as jcli

    argv = ["-m", model_name, "-d", "synthetic:20000", "-s", "64", "-b", "2",
            "--max-steps", "3", "--log-freq", "1", "--lr", "1e-2"]
    jinfos = []
    real_info = jcli.LOGGER.info

    def capture(msg, *a, **kw):
        if isinstance(msg, dict) and "running_loss" in msg:
            jinfos.append(msg)
        return real_info(msg, *a, **kw)

    monkeypatch.setattr(jcli.LOGGER, "info", capture)
    jcli.run_training(jcli.get_parser().parse_args(argv),
                      lambda: make_plan("single",
                                        make_mesh(devices=jax.devices()[:1])))
    jb = jget_model(model_name)
    init_rng, _ = jax.random.split(jax.random.key(0))
    jparams = jax.tree.map(np.asarray, jb.init(jb.config, init_rng))

    def bridged_init(config, rng, *, device=None):
        return from_jax.params_from_numpy(jparams, device=device)

    tb = get_model(model_name)
    monkeypatch.setattr(family_module(tb.family), "init", bridged_init)
    out = tcli.run_training(tcli.get_parser().parse_args(
        argv + ["--device", "cpu"]))
    tlosses = [i["running_loss"] for i in out["infos"]]
    jlosses = [i["running_loss"] for i in jinfos]
    assert len(tlosses) == len(jlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=CLI_LOSS_RTOL)


def test_apply_refuses_a_sequence_past_the_table(bridged):
    _, _, tb, tparams = bridged
    with pytest.raises(ValueError, match="position table"):
        tgpt2.apply(tb.config, tparams, torch.zeros(1, 257, dtype=torch.long))


def test_registry_lists_the_jax_models_and_aliases():
    """Every family's presets, in the JAX package's order, and its HF hub
    aliases resolving to the same presets."""
    from distributed_training_guide_tpu.models import list_models as jlist
    from distributed_training_guide_tpu.models.registry import _HF_ALIASES
    from distributed_training_guide_tpu_torch.models import list_models

    assert list_models() == jlist()
    for alias, preset in _HF_ALIASES.items():
        assert get_model(alias).name == preset == jget_model(alias).name
