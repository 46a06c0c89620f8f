"""The port's int8 serve weights (``weight_dtype="int8"``) against the JAX
package's on the CPU: leaf selection and storage (``serve/weights.py``),
the byte tables, the stacked-leaf slicing of ``Quantized`` containers,
the int8 forward over the JAX llama feature grid, and the engine and CLI.

Bounds: the stored payloads and scales bitwise (both round half to even
on the same fp32 arithmetic); int8 ``prefill`` logits against the JAX
``prefill`` on the same stored params 1e-5 (the same fp32 products in
another summation order, two layers, logits of size ~1); int8 against the
snapped fp params (each quantized leaf replaced by its dequantized copy)
1e-4, the JAX tests' ``MECHANISM_ATOL``; greedy tokens identical to the
JAX engine's."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.models import llama as jllama
from distributed_training_guide_tpu.serve import Request as JRequest
from distributed_training_guide_tpu.serve import ServeEngine as JEngine
from distributed_training_guide_tpu.serve import weights as jw
from distributed_training_guide_tpu.serve.api import \
    generate_many as jgenerate
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.models import llama as tllama
from distributed_training_guide_tpu_torch.serve import (Request, ServeEngine,
                                                        generate_many)
from distributed_training_guide_tpu_torch.serve import weights as tw
from distributed_training_guide_tpu_torch.serve.engine import fp_layout
from distributed_training_guide_tpu_torch.serve.__main__ import main as cli
from distributed_training_guide_tpu_torch.train.precision import (
    Quantized, dequantize_blockwise, quantize_blockwise)
import torch_threads  # noqa: F401  (one torch thread a test process)

PARITY_TOL = 1e-5
MECHANISM_ATOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict; a Quantized leaf stays whole."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@pytest.fixture(scope="module")
def models():
    jb = jget_model("llama-debug", dtype=jnp.float32)
    jparams = jb.init(jb.config, jax.random.key(0))
    tb = get_model("llama-debug", dtype=torch.float32)
    tparams = from_jax.params_from_numpy(_np(jparams), device="cpu")
    return jb, jparams, tb, tparams


def _assert_stored_equal(tstored, jstored_np):
    """The port's stored tree equals the JAX one carried across, leaf for
    leaf and bit for bit."""
    carried = _flat(from_jax.params_from_numpy(jstored_np, device="cpu"))
    mine = _flat(tstored)
    assert mine.keys() == carried.keys()
    for path, leaf in mine.items():
        other = carried[path]
        assert isinstance(leaf, Quantized) == isinstance(other, Quantized), \
            path
        for a, b in (zip(leaf, other) if isinstance(leaf, Quantized)
                     else ((leaf, other),)):
            assert a.dtype == b.dtype and torch.equal(a, b), path


def test_names_block_sizes_and_leaf_selection_match_jax(models):
    jb, _, tb, _ = models
    for wd in (None, "float32", "bfloat16", "int8", "fp32"):
        assert tw.weight_dtype_name(tb.config, wd) == jw.weight_dtype_name(
            jb.config, wd)
    with pytest.raises(ValueError, match="weight_dtype"):
        tw.weight_dtype_name(tb.config, "fp8")
    for d in (512, 64, 63, 48, 3, 1):
        assert tw.weight_block_size(d) == jw.weight_block_size(d)
    for path in ("layers/attn/wq", "layers/attn/wo", "layers/mlp/down",
                 "embed/embedding", "lm_head", "layers/input_norm",
                 "final_norm", "layers/attn/bq", "layers/attn/q_norm"):
        assert tw.is_quantizable_path(path) == jw.is_quantizable_path(path)
    assert tw.is_quantizable_path(("layers", "mlp", "gate"))
    with pytest.raises(ValueError, match="llama family only"):
        tw.store_weights({"w": torch.ones(4, 4)}, "int8", family="gpt2")
    with pytest.raises(ValueError, match="llama family only"):
        tw.weight_tree_bytes({"w": torch.empty(4, 4, device="meta")},
                             "int8", "moe")


@pytest.mark.parametrize("name", ["int8", "bf16", "fp32"])
def test_store_weights_is_bitwise_jax(models, name):
    _, jparams, _, tparams = models
    tstored = tw.store_weights(tparams, name, family="llama")
    jstored = jw.store_weights(jparams, name, family="llama")
    _assert_stored_equal(tstored, _np(jstored))
    if name == "int8":
        flat = _flat(tstored)
        quantized = {p for p, leaf in flat.items()
                     if isinstance(leaf, Quantized)}
        assert quantized == {"embed/embedding", "lm_head",
                             *(f"layers/attn/{w}" for w in
                               ("wq", "wk", "wv", "wo")),
                             *(f"layers/mlp/{w}" for w in
                               ("gate", "up", "down"))}
        for norm in ("layers/input_norm", "layers/post_attn_norm",
                     "final_norm"):
            assert flat[norm].dtype == _flat(tparams)[norm].dtype
        gate = flat["layers/mlp/gate"]
        assert gate.q.shape == (2, 64, 128) and gate.scale.shape == (2, 64, 4)


def test_bridge_carries_quantized_leaves_both_ways(models):
    """A JAX ``Quantized`` (as numpy) arrives as the port's, and
    ``params_to_numpy`` returns the (q, scale) pair, bit for bit."""
    _, jparams, _, _ = models
    jstored = _np(jw.store_weights(jparams, "int8", family="llama"))
    tstored = from_jax.params_from_numpy(jstored, device="cpu",
                                         dtype=torch.bfloat16)
    wq = tstored["layers"]["attn"]["wq"]
    assert isinstance(wq, Quantized)
    assert wq.q.dtype == torch.int8 and wq.scale.dtype == torch.float32
    assert tstored["final_norm"].dtype == torch.bfloat16
    back = from_jax.params_to_numpy(
        from_jax.params_from_numpy(jstored, device="cpu"))
    for path, leaf in _flat(back).items():
        want = _flat(jstored)[path]
        for a, b in (zip(leaf, want) if isinstance(leaf, tuple)
                     else ((leaf, want),)):
            assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_layer_at_a_time_quantization_equals_whole_leaf(models):
    _, _, _, tparams = models
    leaf = tparams["layers"]["mlp"]["down"]              # [2, 128, 64]
    stored = tw.store_weights(tparams, "int8", family="llama")
    whole = quantize_blockwise(leaf, block_size=tw.weight_block_size(64))
    got = stored["layers"]["mlp"]["down"]
    assert torch.equal(got.q, whole.q) and torch.equal(got.scale,
                                                       whole.scale)


def _meta(jshapes):
    """The JAX eval_shape tree as the port's shapes tree (meta tensors)."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}
    return jax.tree.map(lambda s: torch.empty(s.shape, dtype=dt[str(s.dtype)],
                                              device="meta"), jshapes)


@pytest.mark.parametrize("model", ["llama-debug", "llama-3.1-8b"])
def test_byte_tables_match_jax(model):
    jb = jget_model(model, dtype=jnp.float32)
    jshapes = jax.eval_shape(lambda: jb.init(jb.config, jax.random.key(0)))
    shapes = _meta(jshapes)
    table = tw.weight_bytes_by_dtype(shapes, "llama")
    assert table == jw.weight_bytes_by_dtype(jshapes, "llama")
    for name in ("fp32", "bf16", "int8"):
        assert (tw.weight_tree_bytes(shapes, name, "llama")
                == jw.weight_tree_bytes(jshapes, name, "llama") == table[name])
    assert "int8" not in tw.weight_bytes_by_dtype(shapes, "moe")
    if model == "llama-3.1-8b":
        assert 8.5e9 < table["int8"] < 9.5e9    # ~1.125 bytes per param


def test_params_nbytes_of_stored_trees_equal_the_table(models):
    _, _, tb, tparams = models
    shapes = fp_layout(tparams)
    table = tw.weight_bytes_by_dtype(shapes, "llama")
    for name in ("fp32", "bf16", "int8"):
        stored = tw.store_weights(tparams, name, family="llama")
        assert tw.params_nbytes(stored) == table[name], name
    assert table["int8"] / table["fp32"] <= 0.53


def test_stacked_quantized_leaf_slices_per_layer(models):
    """``layer_params`` and ``_unbind_layers`` give layer i's (q[i],
    scale[i]); indexing the NamedTuple itself would pick a field."""
    _, _, tb, tparams = models
    stored = tw.store_weights(tparams, "int8", family="llama")
    leaf = stored["layers"]["attn"]["wq"]
    unbound = tllama._unbind_layers(stored["layers"], 2)
    for i in range(2):
        for got in (tllama.layer_params(stored, i)["attn"]["wq"],
                    unbound[i]["attn"]["wq"]):
            assert isinstance(got, Quantized)
            assert torch.equal(got.q, leaf.q[i])
            assert torch.equal(got.scale, leaf.scale[i])
        assert torch.equal(tllama.layer_params(stored, i)["input_norm"],
                           stored["layers"]["input_norm"][i])


def _variant(jax_side: bool, **kw):
    base = dict(vocab_size=96, hidden_size=64, intermediate_size=96,
                num_layers=2, num_heads=4, num_kv_heads=2,
                max_position_embeddings=32)
    base.update(kw)
    if jax_side:
        return jllama.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                                  **base)
    return tllama.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32,
                              **base)


FORWARD_GRID = {
    "gqa4-2": {},
    "gqa8-1": dict(num_heads=8, num_kv_heads=1),
    "window": dict(sliding_window=5),
    "softcap": dict(attn_logit_softcap=20.0, final_logit_softcap=30.0,
                    query_pre_attn_scalar=16.0),
    "tied": dict(tie_word_embeddings=True),
}


def _snapped(stored):
    """Each quantized leaf replaced by its dequantized fp32 copy."""
    if isinstance(stored, dict):
        return {k: _snapped(v) for k, v in stored.items()}
    if isinstance(stored, Quantized):
        return dequantize_blockwise(stored)
    return stored


@pytest.mark.parametrize("name", sorted(FORWARD_GRID))
def test_int8_prefill_matches_jax_over_the_feature_grid(name):
    jcfg = _variant(True, **FORWARD_GRID[name])
    tcfg = _variant(False, **FORWARD_GRID[name])
    jparams = jllama.init(jcfg, jax.random.key(2))
    jstored = jw.store_weights(jparams, "int8", family="llama")
    tstored = tw.store_weights(
        from_jax.params_from_numpy(_np(jparams), device="cpu"), "int8",
        family="llama")
    _assert_stored_equal(tstored, _np(jstored))
    ids = np.array([[5, 11, 3, 60, 8, 1, 44, 9], [7, 2, 90, 4, 4, 0, 13, 5]],
                   np.int32)
    jlogit, _ = jllama.prefill(jcfg, jstored, jnp.asarray(ids),
                               jllama.init_cache(jcfg, 2, 8), last_pos=6)

    def port(params):
        cache = tllama.init_cache(tcfg, 2, 8, device="cpu")
        return tllama.prefill(tcfg, params, torch.from_numpy(ids), cache,
                              last_pos=6)[0]

    q8 = port(tstored)
    np.testing.assert_allclose(q8.numpy(), np.asarray(jlogit), rtol=0,
                               atol=PARITY_TOL)
    snap = port(_snapped(tstored))
    assert float((q8 - snap).abs().max()) < MECHANISM_ATOL


SPECS = [dict(prompt_ids=[3 + i, 17, 42, 9, 5][:2 + i % 4],
              max_new_tokens=6 + i % 3, seed=i) for i in range(5)]


@pytest.mark.parametrize("chunk", [None, 4])
def test_int8_engine_greedy_tokens_identical_to_jax(models, chunk):
    jb, jparams, tb, tparams = models
    kw = dict(n_slots=3, page_size=4, max_len=32, prefill_chunk=chunk,
              weight_dtype="int8")
    jeng = JEngine(jb, jparams, **kw)
    teng = ServeEngine(tb, tparams, device="cpu", **kw)
    _assert_stored_equal(teng.params, _np(jeng.programs.params))
    want = jgenerate(jeng, [JRequest(**s) for s in SPECS])
    got = generate_many(teng, [Request(**s) for s in SPECS])
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    # a request served alone gives the tokens it got co-batched
    alone = ServeEngine(tb, tparams, device="cpu", **{**kw, "n_slots": 1})
    for r, spec in zip(got, SPECS):
        solo = generate_many(alone, [Request(**spec)])
        assert solo[0].token_ids == r.token_ids
    assert teng.weight_report() == jeng.weight_report()
    assert teng.weight_bytes() == jeng.weight_bytes()


def test_int8_refuses_moe_and_fp_modes_report(models):
    _, _, tb, tparams = models
    mb = get_model("moe-debug", dtype=torch.float32)
    mparams = mb.init(mb.config, 0, device="cpu")
    with pytest.raises(ValueError, match="llama family only"):
        ServeEngine(mb, mparams, device="cpu", max_len=16,
                    weight_dtype="int8")
    fp = ServeEngine(tb, tparams, device="cpu", max_len=16)
    assert fp.weight_report()["weight_dtype"] == "fp32"
    assert fp.params["lm_head"] is not None
    bf = ServeEngine(tb, tparams, device="cpu", max_len=16,
                     weight_dtype="bf16")
    assert bf.params["lm_head"].dtype == torch.bfloat16
    assert fp.weight_bytes() / bf.weight_bytes() == 2


def test_cli_prints_the_weight_report(capsys):
    cli(["-m", "llama-debug", "--weight-dtype", "int8", "--device", "cpu",
         "--prompt-ids", "3,17,42", "--steps", "4"])
    first = json.loads(capsys.readouterr().out.splitlines()[0])
    rep = first["weight_report"]
    assert rep["weight_dtype"] == "int8" and rep["bytes_vs_fp32"] <= 0.53
