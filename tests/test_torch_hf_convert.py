"""HF checkpoints into the port: ``models/auto.py`` (``hf:<dir>``) and
``models/hf_convert.py`` (stream-convert, sharded load), on the CPU.

For each llama-, moe-, gpt2- and neox-family architecture: a
``transformers`` model built
from an in-code config with a few layers and narrow widths (nothing
downloaded), random weights from a seed, ``save_pretrained``, the port's
convert and load, and the port's fp32 logits against ``transformers``'
within 1e-4 of the largest logit (as ``test_torch_hf_parity.py``: the same
fp32 math summed in another order). Also: a checkpoint in many safetensors
shards, the converted directory byte-equal to the JAX converter's, the
``hf:`` config equal field by field to the JAX ``config_from_hf``, the
classification heads of gpt2 and neox refused with the supported list.
The converter's streaming memory bound and the sharded load on 4 gloo
ranks are in ``tests/test_torch_hf_convert_runs.py``."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

transformers = pytest.importorskip("transformers")
pytest.importorskip("safetensors")

from distributed_training_guide_tpu.models import auto as jax_auto  # noqa: E402
from distributed_training_guide_tpu.models.hf_convert import (  # noqa: E402
    convert_hf_checkpoint as jax_convert)
from distributed_training_guide_tpu.models.registry import (  # noqa: E402
    get_model as jax_get_model)
from distributed_training_guide_tpu_torch.models import get_model  # noqa: E402
from distributed_training_guide_tpu_torch.models.auto import (  # noqa: E402
    config_from_hf)
from distributed_training_guide_tpu_torch.models.hf_convert import (  # noqa: E402
    convert_hf_checkpoint, load_pretrained)

LOGIT_TOL = 1e-4     # fp32 through 2 layers, sums in another order
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=256,
             rope_theta=10000.0, rms_norm_eps=1e-5)


def _randomize(model, names) -> None:
    """Move weights HF inits to constants (norm scales, biases) off them,
    so the variant's path is exercised."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if any(n in name for n in names):
                p.normal_(1.0 if "norm" in name else 0.0, 0.3)


def _llama():
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **SMALL, tie_word_embeddings=False)), 24


def _llama3_tied():
    cfg = transformers.LlamaConfig(
        **{**SMALL, "rope_theta": 500000.0}, tie_word_embeddings=True,
        rope_scaling={"rope_type": "llama3", "factor": 32.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64})
    return transformers.LlamaForCausalLM(cfg), 96


def _mistral():
    return transformers.MistralForCausalLM(transformers.MistralConfig(
        **SMALL, sliding_window=16, attn_implementation="eager",
        tie_word_embeddings=False)), 48


def _qwen2():
    m = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        **SMALL, sliding_window=16, use_sliding_window=True,
        max_window_layers=1, attn_implementation="eager",
        tie_word_embeddings=False))
    _randomize(m, ("q_proj.bias", "k_proj.bias", "v_proj.bias"))
    return m, 48


def _qwen3():
    m = transformers.Qwen3ForCausalLM(transformers.Qwen3Config(
        **SMALL, head_dim=32, tie_word_embeddings=False))
    _randomize(m, ("q_norm", "k_norm"))
    return m, 24


def _gemma():
    return transformers.GemmaForCausalLM(transformers.GemmaConfig(
        **{**SMALL, "num_key_value_heads": 1, "rms_norm_eps": 1e-6},
        head_dim=32, hidden_act="gelu_pytorch_tanh",
        tie_word_embeddings=True)), 24


def _gemma2():
    m = transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        **{**SMALL, "rms_norm_eps": 1e-6}, head_dim=32,
        query_pre_attn_scalar=24.0, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, sliding_window=16,
        attn_implementation="eager", hidden_activation="gelu_pytorch_tanh",
        tie_word_embeddings=True))
    _randomize(m, ("post_attention_layernorm", "pre_feedforward_layernorm",
                   "post_feedforward_layernorm"))
    return m, 48


def _phi3():
    return transformers.Phi3ForCausalLM(transformers.Phi3Config(
        **SMALL, sliding_window=None, tie_word_embeddings=False,
        pad_token_id=0, bos_token_id=1, eos_token_id=2)), 24


def _olmo2():
    m = transformers.Olmo2ForCausalLM(transformers.Olmo2Config(
        **SMALL, tie_word_embeddings=False))
    _randomize(m, ("q_norm", "k_norm", "post_attention_layernorm",
                   "post_feedforward_layernorm"))
    return m, 24


def _mixtral():
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(
        **SMALL, num_local_experts=4, num_experts_per_tok=2,
        sliding_window=None, tie_word_embeddings=False)), 24


def _qwen2_moe():
    m = transformers.Qwen2MoeForCausalLM(transformers.Qwen2MoeConfig(
        **SMALL, moe_intermediate_size=96,
        shared_expert_intermediate_size=112, num_experts=4,
        num_experts_per_tok=2, norm_topk_prob=False, decoder_sparse_step=1,
        mlp_only_layers=[], tie_word_embeddings=False))
    _randomize(m, ("q_proj.bias", "k_proj.bias", "v_proj.bias",
                   "shared_expert_gate"))
    return m, 24


def _qwen3_moe():
    m = transformers.Qwen3MoeForCausalLM(transformers.Qwen3MoeConfig(
        **SMALL, moe_intermediate_size=96, head_dim=32, num_experts=4,
        num_experts_per_tok=2, norm_topk_prob=False, decoder_sparse_step=1,
        mlp_only_layers=[], tie_word_embeddings=False))
    _randomize(m, ("q_norm", "k_norm"))
    return m, 24


def _gpt2():
    m = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=256,
        attn_implementation="eager"))
    _randomize(m, ("ln_", "c_attn.bias", "c_proj.bias", "c_fc.bias"))
    return m, 24


def _gpt_neox():
    m = transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=256, attn_implementation="eager",
        tie_word_embeddings=False))
    _randomize(m, ("layernorm", "query_key_value.bias", "dense.bias",
                   "dense_h_to_4h.bias", "dense_4h_to_h.bias"))
    return m, 24


# architecture -> (HF model maker, family)
ARCHS = {"llama": (_llama, "llama"), "llama3-tied": (_llama3_tied, "llama"),
         "mistral": (_mistral, "llama"), "qwen2": (_qwen2, "llama"),
         "qwen3": (_qwen3, "llama"), "gemma": (_gemma, "llama"),
         "gemma2": (_gemma2, "llama"), "phi3": (_phi3, "llama"),
         "olmo2": (_olmo2, "llama"), "mixtral": (_mixtral, "moe"),
         "qwen2_moe": (_qwen2_moe, "moe"), "qwen3_moe": (_qwen3_moe, "moe"),
         "gpt2": (_gpt2, "gpt2"), "gpt_neox": (_gpt_neox, "neox")}


def _saved(tmp_path, arch: str, **save_kw):
    torch.manual_seed(0)
    model, seq = ARCHS[arch][0]()
    model = model.eval()
    model.save_pretrained(tmp_path / "hf", safe_serialization=True,
                          **save_kw)
    return model, seq


def _bundle(tmp_path):
    """The port's bundle of the saved checkpoint, fp32 compute; the moe
    family with dropless (ragged) dispatch, as HF's."""
    family, _ = config_from_hf(tmp_path / "hf")
    kw = {"moe_dispatch": "ragged"} if family == "moe" else {}
    return get_model(f"hf:{tmp_path / 'hf'}", dtype=torch.float32, **kw)


def _assert_logits(model, bundle, params, seq: int) -> None:
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128,
                                                             (2, seq)))
    with torch.no_grad():
        theirs = model(ids).logits.float()
        ours = bundle.apply(bundle.config, params, ids)
    scale = float(theirs.abs().max())
    assert ours.shape == theirs.shape
    err = float((ours - theirs).abs().max())
    assert err <= LOGIT_TOL * scale, f"max err {err} over max logit {scale}"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_convert_load_matches_transformers(tmp_path, arch):
    model, seq = _saved(tmp_path, arch)
    bundle = _bundle(tmp_path)
    assert bundle.family == ARCHS[arch][1]
    convert_hf_checkpoint(tmp_path / "hf", tmp_path / "conv", bundle=bundle)
    params = load_pretrained(bundle, None, tmp_path / "conv", device="cpu")
    _assert_logits(model, bundle, params, seq)


def test_multi_shard_checkpoint(tmp_path):
    """A checkpoint in many safetensors files (each layer's tensors spread
    over several) converts to the same directory as one file."""
    model, seq = _saved(tmp_path, "llama", max_shard_size="40KB")
    files = sorted(p.name for p in (tmp_path / "hf").glob("*.safetensors"))
    assert len(files) >= 3, files
    bundle = _bundle(tmp_path)
    convert_hf_checkpoint(tmp_path / "hf", tmp_path / "conv", bundle=bundle)
    params = load_pretrained(bundle, None, tmp_path / "conv", device="cpu")
    _assert_logits(model, bundle, params, seq)
    model.save_pretrained(tmp_path / "one", safe_serialization=True)
    convert_hf_checkpoint(tmp_path / "one", tmp_path / "conv1",
                          bundle=bundle)
    for leaf in json.loads((tmp_path / "conv" / "manifest.json")
                           .read_text())["leaves"]:
        assert ((tmp_path / "conv" / f"{leaf}.npy").read_bytes()
                == (tmp_path / "conv1" / f"{leaf}.npy").read_bytes()), leaf


@pytest.mark.parametrize("arch", ["llama3-tied", "mixtral", "gpt2",
                                  "gpt_neox"])
def test_converted_dir_is_byte_equal_to_jax(tmp_path, arch):
    """One conversion serves both packages: every file the port writes is
    byte for byte the JAX converter's, manifest included."""
    _saved(tmp_path, arch)
    name = f"hf:{tmp_path / 'hf'}"
    convert_hf_checkpoint(tmp_path / "hf", tmp_path / "port", name)
    jax_convert(tmp_path / "hf", tmp_path / "jax", bundle=jax_get_model(name))
    port = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(port) > 5
    for f in port:
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f


def _fields(config) -> dict:
    out = {}
    for f in dataclasses.fields(config):
        v = getattr(config, f.name)
        if f.name in ("dtype", "param_dtype"):
            v = str(v).rsplit(".", 1)[-1].rstrip("'>")
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_hf_config_equals_jax_config_from_hf(tmp_path, arch):
    _saved(tmp_path, arch)
    fam, ours = config_from_hf(tmp_path / "hf")
    jfam, theirs = jax_auto.config_from_hf(tmp_path / "hf")
    assert fam == jfam
    ours, theirs = _fields(ours), _fields(theirs)
    # the JAX moe config has fields of its own (expert parallelism,
    # dispatch internals) that the port's does not carry
    assert set(ours) <= set(theirs)
    assert ours == {k: theirs[k] for k in ours}


@pytest.mark.parametrize("cfg,item", [
    (transformers.GPT2Config(vocab_size=64, n_embd=32, n_layer=2,
                             n_head=2), "GPT2ForSequenceClassification"),
    (transformers.GPTNeoXConfig(vocab_size=64, hidden_size=32,
                                intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2),
     "GPTNeoXForSequenceClassification")],
    ids=["gpt2", "neox"])
def test_unported_families_name_their_item(tmp_path, cfg, item):
    """Both families are ported; a head of theirs that is not a causal LM
    is refused naming the architecture and the supported list."""
    cfg.architectures = [item]
    cfg.save_pretrained(tmp_path)
    with pytest.raises(ValueError, match=f"{item}.*GPT2LMHeadModel"):
        get_model(f"hf:{tmp_path}")


def test_chapter05_pretrained_starts_from_the_converted_weights(tmp_path):
    """``c05_llama405b --pretrained`` (fsdp at world 1, through the CLI's
    load) starts from exactly the converted weights: with ``--lr 0`` one
    step leaves them as loaded, and its loss is HF's on the same batch
    within 1e-4 relative (fp32 compute here)."""
    from distributed_training_guide_tpu_torch.chapters import c05_llama405b
    from distributed_training_guide_tpu_torch.data import (
        BatchLoader, get_tokenizer, load_and_preprocess_data)
    from distributed_training_guide_tpu_torch.train.state import (
        named_leaves)

    cfg = transformers.LlamaConfig(**{**SMALL, "vocab_size": 512},
                                   tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    model.save_pretrained(tmp_path / "hf", safe_serialization=True)
    name = f"hf:{tmp_path / 'hf'}"
    from distributed_training_guide_tpu_torch.chapters import (
        c05_convert_llama)

    c05_convert_llama.main([str(tmp_path / "hf"), str(tmp_path / "conv"),
                            name])
    out = c05_llama405b.main(
        ["-m", name, "--pretrained", str(tmp_path / "conv"), "-d",
         "synthetic:20000", "-s", "64", "-b", "2", "--lr", "0",
         "--max-steps", "1", "--log-freq", "1", "--device", "cpu",
         "--no-checkpoint-activations"],
        model_overrides={"dtype": torch.float32})
    bundle = get_model(name)
    want = load_pretrained(bundle, None, tmp_path / "conv", device="cpu")
    got = dict(named_leaves(out["state"].params))
    for path, t in named_leaves(want):
        assert torch.equal(got[path], t), path
    data = load_and_preprocess_data("synthetic:20000", get_tokenizer(name),
                                    64, max_position_embeddings=256, seed=0)
    ids = next(BatchLoader(data, 2, device="cpu").epoch_batches())
    with torch.no_grad():
        ref = float(model(ids["input_ids"], labels=ids["labels"]).loss)
    assert out["infos"][0]["running_loss"] == pytest.approx(ref, rel=1e-4)


def test_transformers_5_rope_parameters_read_as_rope_theta_and_scaling(
        tmp_path):
    """transformers 5 writes ``rope_theta`` and the scaling into one
    ``rope_parameters`` dict (the card's machine has 5.x); the config is
    the one the 4.x spelling gives, and a default rope_type adds no
    scaling."""
    _saved(tmp_path, "llama3-tied")
    v4 = json.loads((tmp_path / "hf" / "config.json").read_text())
    v5 = {k: v for k, v in v4.items() if k not in ("rope_theta",
                                                   "rope_scaling")}
    v5["rope_parameters"] = {**v4["rope_scaling"],
                             "rope_theta": v4["rope_theta"]}
    (tmp_path / "v5").mkdir()
    (tmp_path / "v5" / "config.json").write_text(json.dumps(v5))
    assert config_from_hf(tmp_path / "v5") == config_from_hf(tmp_path / "hf")
    v5["rope_parameters"] = {"full_attention": {"rope_type": "default",
                                                "rope_theta": 1e6}}
    (tmp_path / "v5" / "config.json").write_text(json.dumps(v5))
    _, cfg = config_from_hf(tmp_path / "v5")
    assert cfg.rope_theta == 1e6 and cfg.rope_scaling is None
