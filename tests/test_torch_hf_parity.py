"""The port's ``models/llama.py:apply`` against ``transformers``'
``LlamaForCausalLM`` on the CPU: a model built from an in-code config
(nothing downloaded) with random weights from a seed, the same weights
moved into the port's stacked ``[in, out]`` layout, fp32 logits within
1e-4 of the largest logit, untied and tied heads, grouped-query and
full-head attention, the einsum and the flash attention. ``transformers``
is needed here only; the port never imports it."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

transformers = pytest.importorskip("transformers")

from distributed_training_guide_tpu_torch.models import get_model  # noqa: E402
from distributed_training_guide_tpu_torch.models import llama  # noqa: E402

LOGIT_TOL = 1e-4    # two fp32 layers, sums in another order


def _hf_model(tie: bool, kv_heads: int):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=kv_heads, max_position_embeddings=256,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=tie,
        attention_bias=False, mlp_bias=False)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _port_params(model, tie: bool) -> dict:
    """HF's per-layer ``Linear`` weights ([out, in]) as the port's stacked
    ``[L, in, out]`` leaves."""
    sd = {k: v.detach().float() for k, v in model.state_dict().items()}
    layers = model.config.num_hidden_layers

    def stack(name, transpose=True):
        ws = [sd[f"model.layers.{i}.{name}"] for i in range(layers)]
        return torch.stack([w.T.contiguous() if transpose else w
                            for w in ws])

    params = {
        "embed": {"embedding": sd["model.embed_tokens.weight"]},
        "layers": {
            "attn": {k: stack(f"self_attn.{p}_proj.weight")
                     for k, p in (("wq", "q"), ("wk", "k"), ("wv", "v"),
                                  ("wo", "o"))},
            "mlp": {k: stack(f"mlp.{k}_proj.weight")
                    for k in ("gate", "up", "down")},
            "input_norm": stack("input_layernorm.weight", False),
            "post_attn_norm": stack("post_attention_layernorm.weight",
                                    False),
        },
        "final_norm": sd["model.norm.weight"],
    }
    if not tie:
        params["lm_head"] = sd["lm_head.weight"].T.contiguous()
    return params


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("tie,kv_heads", [(False, 2), (True, 4)],
                         ids=["untied-gqa", "tied-mha"])
def test_apply_matches_transformers(tie, kv_heads, attn_impl):
    model = _hf_model(tie, kv_heads)
    bundle = get_model("llama-debug", vocab_size=128, num_layers=2,
                       num_heads=4, num_kv_heads=kv_heads,
                       tie_word_embeddings=tie, dtype=torch.float32)
    params = _port_params(model, tie)
    assert set(llama.init(bundle.config, 0, device="cpu")) == set(params)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128,
                                                             (2, 24)))
    with torch.no_grad():
        theirs = model(ids).logits.float()
        ours = llama.apply(bundle.config, params, ids, attn_impl=attn_impl)
    scale = float(theirs.abs().max())
    assert ours.shape == theirs.shape
    assert float((ours - theirs).abs().max()) <= LOGIT_TOL * scale
