"""The port's llama forwards against the JAX package's on the CPU, with
llama-debug weights carried across by the weight bridge (fp32): the
bucketed ``prefill`` (logits and the k/v cache) and ``paged_decode_step``
at T = 1 (a decode step over several slots) and T = chunk (a prefill
chunk with a pad tail), including the updated page pools; the JAX side
runs both its paged paths, the Pallas kernel in interpret mode and the
gather path. Bounds: logits 1e-4 (two layers of fp32 matmuls, softmax
and norms in another reduction order, on logits of size ~1), k/v 1e-5
(one projection plus rope on O(1) values)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.models import llama as jllama
from distributed_training_guide_tpu.serve import kv_pages as jkv
from distributed_training_guide_tpu_torch.models import from_jax
from distributed_training_guide_tpu_torch.models import get_model
from distributed_training_guide_tpu_torch.models import llama as tllama
from distributed_training_guide_tpu_torch.serve import kv_pages as tkv
import torch_threads  # noqa: F401  (one torch thread a test process)

LOGIT_TOL = 1e-4
KV_TOL = 1e-5


@pytest.fixture(scope="module")
def bridged():
    jb = jget_model("llama-debug", dtype=jnp.float32)
    jparams = jb.init(jb.config, jax.random.key(0))
    tb = get_model("llama-debug", dtype=torch.float32)
    tparams = from_jax.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, tb, tparams


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_every_leaf_bitwise(bridged, dtype):
    jb, jparams, _, _ = bridged
    tree = jax.tree.map(lambda x: np.asarray(x.astype(dtype)), jparams)
    back = from_jax.params_to_numpy(
        from_jax.params_from_numpy(tree, device="cpu"))
    src = dict(_leaves_with_paths(tree))
    got = dict(_leaves_with_paths(back))
    assert src.keys() == got.keys()
    for path, leaf in src.items():
        assert got[path].dtype == leaf.dtype, path
        assert got[path].shape == leaf.shape, path
        assert np.array_equal(got[path].view(np.uint8),
                              leaf.view(np.uint8)), path


def test_init_layout_matches_jax(bridged):
    """The port's init draws the same tree: every leaf path, shape and
    dtype of the JAX params."""
    jb, jparams, tb, tparams = bridged
    mine = tb.init(tb.config, 0, device="cpu")
    want = {p: (tuple(x.shape), str(x.dtype))
            for p, x in _leaves_with_paths(
                jax.tree.map(np.asarray, jparams))}
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in _leaves_with_paths(mine)}
    assert got == want
    assert tb.config.num_params() == jb.config.num_params()


def test_prefill_logits_and_cache_match_jax(bridged):
    jb, jparams, tb, tparams = bridged
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 11)).astype(np.int32)
    jcache = jllama.init_cache(jb.config, 2, 16)
    jlogit, jcache = jllama.prefill(jb.config, jparams, jnp.asarray(ids),
                                    jcache, last_pos=7)
    tcache = tllama.init_cache(tb.config, 2, 16, device="cpu")
    tlogit, tcache = tllama.prefill(tb.config, tparams, torch.from_numpy(ids),
                                    tcache, last_pos=7)
    np.testing.assert_allclose(tlogit.numpy(), np.asarray(jlogit), rtol=0,
                               atol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=0,
                                   atol=KV_TOL)


def _pools(rng, config, n_pages, page, kv_dtype):
    shape = (config.num_layers, n_pages, page, config.num_kv_heads,
             config.head_size)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if kv_dtype == "int8":
        jk, jv = jkv.quantize_kv(jnp.asarray(k)), jkv.quantize_kv(
            jnp.asarray(v))
        tk, tv = (tkv.Quantized(q=torch.from_numpy(np.array(p.q)),
                                scale=torch.from_numpy(np.array(p.scale)))
                  for p in (jk, jv))
        return {"k": jk, "v": jv}, {"k": tk, "v": tv}
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


def _assert_pools(tpools, jpools):
    for name in ("k", "v"):
        got, want = tpools[name], jpools[name]
        pairs = (zip(got, want) if isinstance(got, tkv.Quantized)
                 else [(got, want)])
        for g, w in pairs:        # page 0 is the trash page: skip it
            np.testing.assert_allclose(g.numpy()[:, 1:],
                                       np.asarray(w)[:, 1:], rtol=0,
                                       atol=KV_TOL)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("t", [1, 4])
def test_paged_decode_step_matches_jax(bridged, t, kv_dtype):
    """T = 1: three slots (one idle on the trash page) decode one token
    each over shuffled tables. T = 4: one slot runs a prefill chunk whose
    last token is padding (n_valid = 3, last_index = 2). Logits and the
    updated pools are held against JAX's kernel and gather paths. Under
    int8 the pools compare as dequantizable payload + scales at KV_TOL:
    a k/v 1e-7 apart can round to a different int8 step only at an exact
    .5 tie, which these random inputs do not hit."""
    jb, jparams, tb, tparams = bridged
    rng = np.random.default_rng(10 * t + (kv_dtype == "int8"))
    page, n_pages, m = 4, 16, 4
    if t == 1:
        s = 3
        tables = np.zeros((s, m), np.int32)
        phys = rng.permutation(np.arange(1, n_pages))
        tables[0, :3] = phys[:3]
        tables[1, :2] = phys[3:5]
        lengths = np.array([9, 5, 0], np.int32)          # slot 2 idle
        n_valid, last_index = None, None
    else:
        s = 1
        tables = np.zeros((s, m), np.int32)
        tables[0, :3] = rng.permutation(np.arange(1, n_pages))[:3]
        lengths = np.array([6], np.int32)
        n_valid, last_index = np.array([3], np.int32), 2
    ids = rng.integers(0, 512, (s, t)).astype(np.int32)
    # the same pool contents on both sides; the port writes into its
    # tensors in place, the JAX arrays keep the starting contents
    jpools, tpools = _pools(rng, tb.config, n_pages, page, kv_dtype)
    tout, tcache = tllama.paged_decode_step(
        tb.config, tparams, torch.from_numpy(ids),
        torch.from_numpy(lengths), tpools,
        tkv.make_attend(torch.from_numpy(tables), torch.from_numpy(lengths),
                        n_valid=(None if n_valid is None
                                 else torch.from_numpy(n_valid))),
        last_index=last_index)
    for impl in ("flash", "xla"):
        jout, jcache = jllama.paged_decode_step(
            jb.config, jparams, jnp.asarray(ids), jnp.asarray(lengths),
            jpools, jkv.make_attend(
                jnp.asarray(tables), jnp.asarray(lengths), impl=impl,
                n_valid=None if n_valid is None else jnp.asarray(n_valid)),
            last_index=last_index)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                                   atol=LOGIT_TOL, err_msg=impl)
        _assert_pools(tcache, jcache)
