"""Publish a trained checkpoint back to HF format: the inverse of
``models/hf_convert.py``.

Counterpart of ``distributed_training_guide_tpu/models/hf_export.py``: the
same family emitters and ``config.json`` emitters, so for the same params
the two packages write the same tensors and the same config.
``export_hf_checkpoint`` writes a ``model.safetensors`` + ``config.json``
that ``transformers.AutoModelForCausalLM.from_pretrained`` loads. The
layout inversions mirror the convert maps: torch ``Linear`` is ``[out,
in]``, so 2-D weights transpose; stacked ``[L, ...]`` leaves unstack into
per-layer tensors; the Qwen2 QKV bias rows and Qwen3 q / k norms export when
present; a tied head omits ``lm_head``; the moe family's ``[L, E, ...]``
expert stacks unstack into Mixtral's ``w1 / w2 / w3`` (or the Qwen
spellings); GPT-2's ``Conv1D`` tensors keep ``[in, out]`` (the ``[E, 3,
E]`` QKV flattens back to ``[E, 3E]``, and the tied ``lm_head`` is
written out so ``from_pretrained`` finds it); GPT-NeoX's ``[E, 3, H*D]``
QKV re-interleaves per head into HF's ``query_key_value``.

Export gathers the whole model to host memory (~2x the param bytes at the
peak: the gathered leaves and the per-tensor copies) and writes one
safetensors file, as the JAX exporter does.

The ``main`` CLI restores a run's newest checkpoint through
``checkpoint/orbax_io.py`` under the optimizer and precision policy the run
trained with, on one device, and exports its params::

    python -m distributed_training_guide_tpu_torch.models.hf_export \\
        -m llama-3.2-1b -e outputs/my-run -o /ckpts/my-run-hf
"""
from __future__ import annotations

import json
from pathlib import Path

import torch


# ---------------------------------------------------------------------------
# family emitters: (config, flat leaves) -> {hf_name: tensor}
# ---------------------------------------------------------------------------

def _emit_llama(config, leaves: dict) -> dict:
    out = {"model.embed_tokens.weight": leaves["embed.embedding"],
           "model.norm.weight": leaves["final_norm"]}
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = leaves["lm_head"].T
    per_layer = {
        "layers.attn.wq": ("self_attn.q_proj.weight", True),
        "layers.attn.wk": ("self_attn.k_proj.weight", True),
        "layers.attn.wv": ("self_attn.v_proj.weight", True),
        "layers.attn.wo": ("self_attn.o_proj.weight", True),
        "layers.mlp.gate": ("mlp.gate_proj.weight", True),
        "layers.mlp.up": ("mlp.up_proj.weight", True),
        "layers.mlp.down": ("mlp.down_proj.weight", True),
        "layers.input_norm": ("input_layernorm.weight", False),
        "layers.post_attn_norm": ("post_attention_layernorm.weight", False),
        "layers.attn.bq": ("self_attn.q_proj.bias", False),
        "layers.attn.bk": ("self_attn.k_proj.bias", False),
        "layers.attn.bv": ("self_attn.v_proj.bias", False),
        "layers.attn.q_norm": ("self_attn.q_norm.weight", False),
        "layers.attn.k_norm": ("self_attn.k_norm.weight", False),
        # OLMo-2 post-norm wiring (note: HF reuses the
        # post_attention_layernorm NAME for the attn-OUTPUT norm)
        "layers.attn_out_norm": ("post_attention_layernorm.weight", False),
        "layers.mlp_out_norm": ("post_feedforward_layernorm.weight", False),
    }
    if getattr(config, "sandwich_norm", False):
        # Gemma-2: the post_attn_norm leaf is the PRE-FFN norm
        per_layer["layers.post_attn_norm"] = ("pre_feedforward_layernorm.weight",
                                              False)
    for leaf, (hf, transpose) in per_layer.items():
        if leaf not in leaves:
            continue   # e.g. biases on a no-attn_bias config
        stack = leaves[leaf]
        for i in range(config.num_layers):
            t = stack[i]
            out[f"model.layers.{i}.{hf}"] = t.T if transpose else t
    return out


def _emit_moe(config, leaves: dict) -> dict:
    out = {"model.embed_tokens.weight": leaves["embed.embedding"],
           "model.norm.weight": leaves["final_norm"]}
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = leaves["lm_head"].T
    attn = {
        "layers.attn.wq": "self_attn.q_proj.weight",
        "layers.attn.wk": "self_attn.k_proj.weight",
        "layers.attn.wv": "self_attn.v_proj.weight",
        "layers.attn.wo": "self_attn.o_proj.weight",
    }
    # qk_norm (Qwen3-MoE) or a shared expert (Qwen2-MoE) selects the qwen
    # spelling (mlp.experts.N.gate_proj...); plain configs keep Mixtral's
    # (block_sparse_moe.experts.N.w1...)
    qwen = bool(getattr(config, "qk_norm", False)
                or getattr(config, "shared_expert_intermediate", None))
    expert_names = ({"gate": "gate_proj", "up": "up_proj", "down": "down_proj"}
                    if qwen else {"gate": "w1", "up": "w3", "down": "w2"})
    for i in range(config.num_layers):
        for leaf, hf in attn.items():
            out[f"model.layers.{i}.{hf}"] = leaves[leaf][i].T
        if "layers.attn.bq" in leaves:   # Qwen2-MoE QKV biases
            for b, hf in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
                out[f"model.layers.{i}.self_attn.{hf}.bias"] = \
                    leaves[f"layers.attn.{b}"][i]
        if getattr(config, "qk_norm", False):
            out[f"model.layers.{i}.self_attn.q_norm.weight"] = \
                leaves["layers.attn.q_norm"][i]
            out[f"model.layers.{i}.self_attn.k_norm.weight"] = \
                leaves["layers.attn.k_norm"][i]
        out[f"model.layers.{i}.input_layernorm.weight"] = \
            leaves["layers.input_norm"][i]
        out[f"model.layers.{i}.post_attention_layernorm.weight"] = \
            leaves["layers.post_attn_norm"][i]
        moe_prefix = (f"model.layers.{i}.mlp" if qwen
                      else f"model.layers.{i}.block_sparse_moe")
        out[f"{moe_prefix}.gate.weight"] = leaves["layers.moe.router"][i].T
        for x in range(config.num_experts):
            for ours, theirs in expert_names.items():
                out[f"{moe_prefix}.experts.{x}.{theirs}.weight"] = \
                    leaves[f"layers.moe.{ours}"][i, x].T
        if "layers.moe.shared_gate" in leaves:   # Qwen2-MoE shared expert
            for ours, theirs in (("shared_gate_proj", "gate_proj"),
                                 ("shared_up", "up_proj"),
                                 ("shared_down", "down_proj")):
                out[f"{moe_prefix}.shared_expert.{theirs}.weight"] = \
                    leaves[f"layers.moe.{ours}"][i].T
            out[f"{moe_prefix}.shared_expert_gate.weight"] = \
                leaves["layers.moe.shared_gate"][i][None, :]
    return out


def _emit_gpt2(config, leaves: dict) -> dict:
    e = config.hidden_size
    out = {"transformer.wte.weight": leaves["wte"],
           "transformer.wpe.weight": leaves["wpe"],
           "transformer.ln_f.weight": leaves["lnf.scale"],
           "transformer.ln_f.bias": leaves["lnf.bias"],
           # HF ties lm_head to wte; written out (a copy: safetensors
           # refuses two names on one storage) so from_pretrained never
           # reports it missing
           "lm_head.weight": leaves["wte"].clone()}
    per_layer = {   # Conv1D stores [in, out]: no transposes anywhere
        "layers.ln1.scale": "ln_1.weight", "layers.ln1.bias": "ln_1.bias",
        "layers.attn.wqkv": "attn.c_attn.weight",
        "layers.attn.bqkv": "attn.c_attn.bias",
        "layers.attn.wo": "attn.c_proj.weight",
        "layers.attn.bo": "attn.c_proj.bias",
        "layers.ln2.scale": "ln_2.weight", "layers.ln2.bias": "ln_2.bias",
        "layers.mlp.wi": "mlp.c_fc.weight", "layers.mlp.bi": "mlp.c_fc.bias",
        "layers.mlp.wo": "mlp.c_proj.weight",
        "layers.mlp.bo": "mlp.c_proj.bias",
    }
    for leaf, hf in per_layer.items():
        for i in range(config.num_layers):
            t = leaves[leaf][i]
            if leaf == "layers.attn.wqkv":     # [e, 3, e] -> Conv1D [e, 3e]
                t = t.reshape(e, 3 * e)
            elif leaf == "layers.attn.bqkv":   # [3, e] -> [3e]
                t = t.reshape(3 * e)
            out[f"transformer.h.{i}.{hf}"] = t
    return out


def _emit_neox(config, leaves: dict) -> dict:
    h, d = config.num_heads, config.head_size
    out = {"gpt_neox.embed_in.weight": leaves["embed_in"],
           "gpt_neox.final_layer_norm.weight": leaves["lnf.scale"],
           "gpt_neox.final_layer_norm.bias": leaves["lnf.bias"],
           "embed_out.weight": leaves["embed_out"].T}
    per_layer = {
        "layers.ln1.scale": "input_layernorm.weight",
        "layers.ln1.bias": "input_layernorm.bias",
        "layers.ln2.scale": "post_attention_layernorm.weight",
        "layers.ln2.bias": "post_attention_layernorm.bias",
        "layers.attn.wo": "attention.dense.weight",
        "layers.attn.bo": "attention.dense.bias",
        "layers.mlp.wi": "mlp.dense_h_to_4h.weight",
        "layers.mlp.bi": "mlp.dense_h_to_4h.bias",
        "layers.mlp.wo": "mlp.dense_4h_to_h.weight",
        "layers.mlp.bo": "mlp.dense_4h_to_h.bias",
    }
    transposed = {"layers.attn.wo", "layers.mlp.wi", "layers.mlp.wo"}
    for leaf, hf in per_layer.items():
        for i in range(config.num_layers):
            t = leaves[leaf][i]
            out[f"gpt_neox.layers.{i}.{hf}"] = (t.T if leaf in transposed
                                                else t)
    for i in range(config.num_layers):
        # the inverse of the converter's de-interleave: [e, 3, h*d] -> HF's
        # per-head-interleaved Linear [3e (out = (h, 3, d)), e]
        w = leaves["layers.attn.wqkv"][i]
        e = w.shape[0]
        w = w.reshape(e, 3, h, d).permute(2, 1, 3, 0).reshape(3 * h * d, e)
        b = leaves["layers.attn.bqkv"][i]
        b = b.reshape(3, h, d).permute(1, 0, 2).reshape(3 * h * d)
        out[f"gpt_neox.layers.{i}.attention.query_key_value.weight"] = w
        out[f"gpt_neox.layers.{i}.attention.query_key_value.bias"] = b
    return out


_EMITTERS = {"llama": _emit_llama, "gpt2": _emit_gpt2, "neox": _emit_neox,
             "moe": _emit_moe}


def _emitter(family: str):
    if family not in _EMITTERS:
        raise KeyError(f"no HF export for the {family!r} family (families: "
                       f"{sorted(_EMITTERS)})")
    return _EMITTERS[family]


# ---------------------------------------------------------------------------
# config.json emitters (inverse of models/auto.py's builders)
# ---------------------------------------------------------------------------

def _qwen_window_out(c) -> dict:
    """Qwen2/3 (dense and MoE) sliding-window keys for export. A uniform
    window maps to use_sliding_window; a full-then-sliding ``layer_windows``
    pattern (ingested from max_window_layers) maps back to that key —
    dropping either would reload as full attention: silent divergence."""
    lw = getattr(c, "layer_windows", None)
    if lw:
        mwl = next((i for i, w in enumerate(lw) if w), len(lw))
        w = max(lw)
        if lw != tuple(0 if i < mwl else w for i in range(len(lw))):
            # anything but leading-zeros-then-constant (e.g. a Gemma-style
            # alternating pattern forced onto a qwen config) is not
            # expressible as max_window_layers — refuse rather than export
            # a config that reloads with different attention
            raise ValueError(
                f"layer_windows {lw} is not a full-then-sliding "
                f"(max_window_layers) pattern and cannot be exported as a "
                f"Qwen config")
        return {"sliding_window": w, "use_sliding_window": True,
                "max_window_layers": mwl}
    if getattr(c, "sliding_window", None):
        return {"sliding_window": c.sliding_window, "use_sliding_window": True}
    return {}


def _rope_scaling_out(c) -> dict:
    """Round-trip the frozen rope_scaling tuple back to HF's dict form —
    dropping it would reload as plain RoPE: silently divergent long-context
    logits (the exact failure the frozen field exists to prevent)."""
    rs = getattr(c, "rope_scaling", None)
    if not rs:
        return {}
    d = {k: list(v) if isinstance(v, tuple) else v for k, v in dict(rs).items()}
    out = {"rope_scaling": d}
    rope_type = d.get("rope_type") or d.get("type")
    if rope_type == "longrope" and "original_max_position_embeddings" in d:
        # HF's longrope init reads original_max from the CONFIG TOP LEVEL
        # (Phi-3 style); leaving it only in-dict makes the exported config
        # crash on reload (factor stays None in _compute_longrope_parameters)
        out["original_max_position_embeddings"] = (
            d["original_max_position_embeddings"])
    return out


def _hf_config(bundle) -> dict:
    c = bundle.config
    _emitter(bundle.family)
    if bundle.family == "gpt2":
        return {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
                "vocab_size": c.vocab_size, "n_embd": c.hidden_size,
                "n_layer": c.num_layers, "n_head": c.num_heads,
                "n_positions": c.max_position_embeddings,
                "n_ctx": c.max_position_embeddings,
                "layer_norm_epsilon": c.layer_norm_eps}
    if bundle.family == "neox":
        return {"architectures": ["GPTNeoXForCausalLM"],
                "model_type": "gpt_neox",
                "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
                "intermediate_size": c.intermediate_size,
                "num_hidden_layers": c.num_layers,
                "num_attention_heads": c.num_heads,
                "max_position_embeddings": c.max_position_embeddings,
                "rotary_pct": c.rotary_pct, "rotary_emb_base": c.rope_theta,
                "layer_norm_eps": c.layer_norm_eps,
                "use_parallel_residual": c.use_parallel_residual,
                "hidden_act": {"gelu": "gelu",
                               "gelu_tanh": "gelu_new"}[c.act_fn],
                "tie_word_embeddings": False,
                **_rope_scaling_out(c)}
    base = {"vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
            "intermediate_size": c.intermediate_size,
            "num_hidden_layers": c.num_layers,
            "num_attention_heads": c.num_heads,
            "num_key_value_heads": c.num_kv_heads,
            "max_position_embeddings": c.max_position_embeddings,
            "rope_theta": c.rope_theta, "rms_norm_eps": c.rms_norm_eps,
            "tie_word_embeddings": c.tie_word_embeddings,
            **_rope_scaling_out(c)}
    if bundle.family == "moe":
        if getattr(c, "shared_expert_intermediate", None):
            # Qwen gates SWA on use_sliding_window (_qwen_window_out); a
            # bare sliding_window key would reload as FULL attention
            return {**base, "architectures": ["Qwen2MoeForCausalLM"],
                    "model_type": "qwen2_moe",
                    "num_experts": c.num_experts,
                    "num_experts_per_tok": c.experts_per_token,
                    "moe_intermediate_size": c.intermediate_size,
                    "shared_expert_intermediate_size":
                        c.shared_expert_intermediate,
                    "norm_topk_prob": c.norm_topk_prob,
                    "router_aux_loss_coef": c.router_aux_coef,
                    "decoder_sparse_step": 1, "mlp_only_layers": [],
                    **_qwen_window_out(c)}
        if getattr(c, "qk_norm", False):
            return {**base, "architectures": ["Qwen3MoeForCausalLM"],
                    "model_type": "qwen3_moe",
                    "num_experts": c.num_experts,
                    "num_experts_per_tok": c.experts_per_token,
                    "moe_intermediate_size": c.intermediate_size,
                    "norm_topk_prob": c.norm_topk_prob,
                    "router_aux_loss_coef": c.router_aux_coef,
                    "head_dim": c.head_size,
                    "decoder_sparse_step": 1, "mlp_only_layers": [],
                    **_qwen_window_out(c)}
        out = {**base, "architectures": ["MixtralForCausalLM"],
               "model_type": "mixtral",
               "num_local_experts": c.num_experts,
               "num_experts_per_tok": c.experts_per_token,
               "router_aux_loss_coef": c.router_aux_coef}
        if getattr(c, "sliding_window", None):  # Mixtral's key is always live
            out["sliding_window"] = c.sliding_window
        return out
    # llama family: the config knobs decide which architecture this is
    if getattr(c, "sandwich_norm", False):
        base.update(architectures=["Gemma2ForCausalLM"], model_type="gemma2",
                    head_dim=c.head_size,
                    hidden_act="gelu_pytorch_tanh",
                    hidden_activation="gelu_pytorch_tanh",
                    query_pre_attn_scalar=c.query_pre_attn_scalar,
                    attn_logit_softcapping=c.attn_logit_softcap,
                    final_logit_softcapping=c.final_logit_softcap)
        if getattr(c, "layer_windows", None):
            base["sliding_window"] = max(c.layer_windows)
            base["layer_types"] = ["sliding_attention" if w else
                                   "full_attention" for w in c.layer_windows]
    elif getattr(c, "post_norm", False):
        base.update(architectures=["Olmo2ForCausalLM"], model_type="olmo2",
                    attention_bias=False)
    elif getattr(c, "qk_norm", False):
        base.update(architectures=["Qwen3ForCausalLM"], model_type="qwen3",
                    head_dim=c.head_size, attention_bias=False)
        base.update(_qwen_window_out(c))
    elif getattr(c, "norm_plus_one", False):
        base.update(architectures=["GemmaForCausalLM"], model_type="gemma",
                    head_dim=c.head_size,
                    hidden_act="gelu_pytorch_tanh",
                    hidden_activation="gelu_pytorch_tanh")
    elif getattr(c, "attn_bias", False):
        base.update(architectures=["Qwen2ForCausalLM"], model_type="qwen2")
        if c.head_dim:  # same silent-divergence risk as the llama branch:
            base["head_dim"] = c.head_dim  # default is hidden/heads on reload
        base.update(_qwen_window_out(c))
    elif getattr(c, "sliding_window", None):
        # plain-llama math + a live window == Mistral (HF LlamaConfig has no
        # sliding_window; exporting it as llama would silently drop the band)
        base.update(architectures=["MistralForCausalLM"], model_type="mistral",
                    sliding_window=c.sliding_window)
        if c.head_dim:
            base["head_dim"] = c.head_dim
    else:
        base.update(architectures=["LlamaForCausalLM"], model_type="llama",
                    attention_bias=False)
        if c.head_dim:
            base["head_dim"] = c.head_dim
    # without this a gelu-gated llama-family model reloads with transformers'
    # default silu MLP — silently divergent logits
    if "hidden_act" not in base:
        base["hidden_act"] = {"silu": "silu",
                              "gelu_tanh": "gelu_pytorch_tanh"}[
                                  getattr(c, "act_fn", "silu")]
    return base


def export_hf_checkpoint(bundle, params, out_dir: str | Path,
                         dtype: str = "float32") -> Path:
    """Write ``params`` (a params tree, whole leaves, on any device) as an
    HF checkpoint (``model.safetensors`` + ``config.json``) that
    ``AutoModelForCausalLM.from_pretrained`` loads."""
    from safetensors.torch import save_file

    from ..train.state import named_leaves

    emit = _emitter(bundle.family)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tdtype = getattr(torch, dtype)
    leaves = {path.replace("/", "."): t.detach().to("cpu", tdtype)
              for path, t in named_leaves(params)}
    tensors = emit(bundle.config, leaves)
    # views from transposes / slices must be contiguous for safetensors
    tensors = {k: v.contiguous() for k, v in tensors.items()}
    save_file(tensors, str(out_dir / "model.safetensors"),
              metadata={"format": "pt"})
    with open(out_dir / "config.json", "w") as fp:
        json.dump(_hf_config(bundle), fp, indent=2)
    return out_dir


def main(argv=None) -> None:
    """CLI: restore a training experiment's newest checkpoint and publish
    its params as an HF checkpoint. ``--optimizer`` and
    ``--precision-policy`` must be the run's: the checkpoint holds the
    optimizer state in the policy's layout, and restore needs it."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m distributed_training_guide_tpu_torch.models.hf_export",
        description=main.__doc__)
    parser.add_argument("-m", "--model-name", required=True)
    parser.add_argument("-e", "--exp-dir", required=True,
                        help="experiment dir holding checkpoint-*/ + "
                             "state.json")
    parser.add_argument("-o", "--out-dir", required=True)
    parser.add_argument("--optimizer", default="adamw",
                        choices=["adamw", "adafactor", "lion"],
                        help="optimizer the run used")
    parser.add_argument("--precision-policy", default="fp32",
                        help="precision policy the run trained with")
    parser.add_argument("--param-dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="param storage dtype the run trained with")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16", "float16"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from ..checkpoint import CheckpointIO, restore_train_state
    from ..train.optimizer import OPTIMIZERS
    from ..train.step import Trainer
    from .registry import get_model

    overrides = ({"param_dtype": torch.bfloat16}
                 if args.param_dtype == "bfloat16" else {})
    bundle = get_model(args.model_name, **overrides)
    # one device, whatever plan wrote the checkpoint: DCP reshards the
    # stored shards into whole tensors
    trainer = Trainer(bundle=bundle,
                      optimizer=OPTIMIZERS[args.optimizer](1e-4),
                      precision=args.precision_policy, device=args.device)
    io = CheckpointIO(args.exp_dir)
    try:
        state, host_state = restore_train_state(io, trainer)
    finally:
        io.close()
    out = export_hf_checkpoint(bundle, state.params, args.out_dir,
                               dtype=args.dtype)
    print(f"exported step-{host_state.get('global_step', '?')} params of "
          f"{args.model_name} -> {out}")


if __name__ == "__main__":
    main()
