"""AutoModel-style config ingestion: HF ``config.json`` -> a native bundle.

Counterpart of ``distributed_training_guide_tpu/models/auto.py``, for the
four families (gpt2, llama, moe, neox). ``-m hf:<dir>`` (or
``get_model("hf:<dir>")``) reads the checkpoint's own ``config.json``,
recognizes the architecture, and builds the family config, field for field
the JAX function's, so any Llama / Mistral / Qwen2 / Qwen3 / Gemma /
Gemma-2 / Phi-3 / OLMo-2 / GPT-2 / Mixtral / Qwen2-MoE / Qwen3-MoE /
GPT-NeoX checkpoint trains (and converts, ``models/hf_convert.py``)
without a registry preset:

    python -m distributed_training_guide_tpu_torch.chapters.c05_convert_llama \
        <hf-dir> <conv> hf:<hf-dir>
    python -m distributed_training_guide_tpu_torch.chapters.c05_llama405b \
        -m hf:<hf-dir> --pretrained <conv> ...

Any other architecture fails with the supported list.
"""
from __future__ import annotations

import json
from pathlib import Path


def _sliding_window_kw(cfg: dict, arch: str) -> dict:
    """``sliding_window`` from an HF config dict. Qwen2-style configs gate
    it behind ``use_sliding_window`` (default False — the key is present on
    every Qwen2 config but usually inert); everywhere else a non-null value
    is live. Values >= max_position are dropped (the band never binds).

    Qwen2/Qwen3 additionally keep the FIRST ``max_window_layers`` layers on
    FULL attention (sliding only afterwards): that mixed pattern maps onto
    ``layer_windows`` — the per-layer window column Gemma-2's alternating
    scheme rides — instead of the uniform ``sliding_window``."""
    window = cfg.get("sliding_window")
    if not window:
        return {}
    if window >= cfg.get("max_position_embeddings", 4096):
        return {}
    if arch in ("Qwen2ForCausalLM", "Qwen3ForCausalLM",
                "Qwen2MoeForCausalLM", "Qwen3MoeForCausalLM"):
        # the MoE flavors gate identically — HF Qwen2MoeConfig ships
        # sliding_window=4096 with use_sliding_window=False by default, and
        # treating that inert key as live would band every layer silently
        if not cfg.get("use_sliding_window"):
            return {}
        n = cfg["num_hidden_layers"]
        mwl = cfg.get("max_window_layers", n)
        if mwl and mwl < n:
            return {"layer_windows": tuple(
                0 if i < mwl else int(window) for i in range(n))}
    return {"sliding_window": int(window)}


def _rope_parameters(cfg: dict) -> dict:
    """transformers 5 writes ``rope_theta`` and the scaling into one
    ``rope_parameters`` dict (per layer type for some models: the full
    attention layers' is the one these families share); 4.x spells them
    ``rope_theta`` and ``rope_scaling``."""
    rp = cfg.get("rope_parameters") or {}
    if rp and all(isinstance(v, dict) for v in rp.values()):
        rp = rp.get("full_attention") or next(iter(rp.values()))
    return rp


def _rope_scaling_kw(cfg: dict, arch: str) -> dict:
    """Frozen ``rope_scaling`` kwargs from an HF config dict, validated at
    ingestion (an unsupported rope type must fail HERE, loudly, not produce
    silently-divergent logits). All six HF rope types are implemented
    (``ops/rope.py``); Phi-3-style configs keep
    ``original_max_position_embeddings`` at the top level, so fold it into
    the dict where longrope's short/long switch needs it."""
    from ..ops.rope import ROPE_TYPES, freeze_rope_scaling, rope_type_of

    scaling = cfg.get("rope_scaling")
    if not scaling:
        rp = _rope_parameters(cfg)
        if rp.get("rope_type", rp.get("type", "default")) == "default":
            return {}
        scaling = {k: v for k, v in rp.items() if k != "rope_theta"}
    rope_type = rope_type_of(scaling)
    if rope_type not in ROPE_TYPES:
        raise ValueError(f"{arch}: unsupported rope_scaling type "
                         f"{rope_type!r} (supported: {ROPE_TYPES})")
    scaling = dict(scaling)
    if ("original_max_position_embeddings" not in scaling
            and cfg.get("original_max_position_embeddings")):
        scaling["original_max_position_embeddings"] = (
            cfg["original_max_position_embeddings"])
    return {"rope_scaling": freeze_rope_scaling(scaling)}


def _llama_kwargs(cfg: dict) -> dict:
    kw = dict(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads",
                             cfg["num_attention_heads"]),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        rope_theta=cfg.get("rope_theta",
                           _rope_parameters(cfg).get("rope_theta", 10000.0)),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
    )
    if cfg.get("head_dim"):
        kw["head_dim"] = cfg["head_dim"]
    kw.update(_rope_scaling_kw(cfg, cfg.get("architectures", ["?"])[0]))
    return kw


_HF_ACTS = {"silu": "silu", "gelu_pytorch_tanh": "gelu_tanh",
            "gelu_tanh": "gelu_tanh"}   # exact 'gelu' is NOT implemented


def _build_llama(cfg: dict, arch: str):
    from .llama import LlamaConfig

    kw = _llama_kwargs(cfg)
    kw.update(_sliding_window_kw(cfg, arch))
    if arch == "Qwen2ForCausalLM":
        # default True: older Qwen2 configs omit the key because bias was
        # unconditional
        kw["attn_bias"] = cfg.get("attention_bias", True)
    else:
        kw["attn_bias"] = cfg.get("attention_bias", False)
    if arch == "Qwen3ForCausalLM":  # per-head q/k RMSNorm, always on
        kw["qk_norm"] = True
    if arch == "Olmo2ForCausalLM":
        # OLMo-2: post-norm block wiring (norms on sublayer OUTPUTS) and
        # FULL-WIDTH q/k RMSNorm applied before the head reshape
        kw.update(post_norm=True, qk_norm="flat")
    act = cfg.get("hidden_act", "silu")
    if arch == "GemmaForCausalLM":
        kw.update(norm_plus_one=True, scale_embed=True,
                  tie_word_embeddings=True)
        act = "gelu_pytorch_tanh"   # HF applies tanh-gelu whatever the key says
    if arch == "Gemma2ForCausalLM":
        # Gemma-2 = Gemma + sandwich norms (both sides of each sublayer),
        # tanh softcapping of attention scores and final logits, a score
        # scale from query_pre_attn_scalar, and an ALTERNATING per-layer
        # sliding-window pattern — the global sliding_window key is replaced
        # by layer_windows (0 = full attention on that layer)
        kw.pop("sliding_window", None)
        kw.update(norm_plus_one=True, scale_embed=True, sandwich_norm=True,
                  tie_word_embeddings=True,
                  attn_logit_softcap=cfg.get("attn_logit_softcapping"),
                  final_logit_softcap=cfg.get("final_logit_softcapping"),
                  query_pre_attn_scalar=cfg.get("query_pre_attn_scalar"))
        act = "gelu_pytorch_tanh"
        w = cfg.get("sliding_window")
        if w and w < cfg.get("max_position_embeddings", 8192):
            lt = cfg.get("layer_types")
            if lt:
                pattern = tuple(w if t == "sliding_attention" else 0
                                for t in lt)
            else:  # pre-layer_types configs: sliding on even layers
                pattern = tuple(w if i % 2 == 0 else 0
                                for i in range(cfg["num_hidden_layers"]))
            if any(pattern):
                kw["layer_windows"] = pattern
    if act not in _HF_ACTS:
        raise ValueError(f"{arch}: unsupported hidden_act {act!r} "
                         f"(supported: {sorted(_HF_ACTS)})")
    kw["act_fn"] = _HF_ACTS[act]
    return LlamaConfig(**kw)


def _build_gpt2(cfg: dict, arch: str):
    from .gpt2 import GPT2Config

    return GPT2Config(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["n_embd"],
        num_layers=cfg["n_layer"],
        num_heads=cfg["n_head"],
        max_position_embeddings=cfg.get("n_positions", 1024),
        layer_norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
    )


def _build_neox(cfg: dict, arch: str):
    from .neox import NeoXConfig

    if cfg.get("tie_word_embeddings"):
        # the family keeps embed_in / embed_out untied (every public
        # NeoX / Pythia card unties them)
        raise ValueError(
            f"{arch}: tie_word_embeddings=true is not supported by the "
            f"NeoX family (embed_out is a separate tensor here); untie the "
            f"checkpoint or export embed_out explicitly")
    act = cfg.get("hidden_act", "gelu")
    acts = {"gelu": "gelu", "gelu_new": "gelu_tanh",
            "gelu_pytorch_tanh": "gelu_tanh"}
    if act not in acts:
        raise ValueError(f"{arch}: unsupported hidden_act {act!r} "
                         f"(supported: {sorted(acts)})")
    rp = _rope_parameters(cfg)
    # transformers 5 spells rotary_pct / rotary_emb_base as
    # partial_rotary_factor / rope_theta (top level or rope_parameters)
    pct = cfg.get("rotary_pct", cfg.get("partial_rotary_factor",
                                        rp.get("partial_rotary_factor",
                                               0.25)))
    theta = cfg.get("rotary_emb_base", cfg.get("rope_theta",
                                               rp.get("rope_theta",
                                                      10000.0)))
    return NeoXConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        max_position_embeddings=cfg.get("max_position_embeddings", 2048),
        rotary_pct=pct,
        rope_theta=theta,
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        use_parallel_residual=cfg.get("use_parallel_residual", True),
        act_fn=acts[act],
        **_rope_scaling_kw(cfg, arch),
    )


def _build_mixtral(cfg: dict, arch: str):
    from .moe import MoELlamaConfig

    kw = dict(
        num_experts=cfg["num_local_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        **_llama_kwargs(cfg),
        **_sliding_window_kw(cfg, arch),
    )
    _reject_moe_layer_windows(kw, arch)
    if "router_aux_loss_coef" in cfg:   # HF Mixtral ships 0.02, not our 0.01
        kw["router_aux_coef"] = cfg["router_aux_loss_coef"]
    return MoELlamaConfig(**kw)


def _reject_moe_layer_windows(kw: dict, arch: str) -> None:
    if kw.pop("layer_windows", None) is not None:
        # the moe family's layer scan doesn't thread the per-layer window
        # column (dense llama does) — refuse rather than band every layer
        raise ValueError(
            f"{arch}: mixed full/sliding layer patterns (max_window_layers) "
            f"are not implemented for the MoE family; use a uniform-window "
            f"or windowless checkpoint")


def _build_qwen2_moe(cfg: dict, arch: str):
    from .moe import MoELlamaConfig

    if cfg.get("mlp_only_layers") or cfg.get("decoder_sparse_step", 1) != 1:
        raise ValueError(
            f"{arch}: mlp_only_layers={cfg.get('mlp_only_layers')} / "
            f"decoder_sparse_step={cfg.get('decoder_sparse_step')} mixes "
            f"dense and MoE layers, which this family does not implement "
            f"(uniform MoE blocks only)")
    kw = dict(
        num_experts=cfg["num_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        **_llama_kwargs(cfg),
        **_sliding_window_kw(cfg, arch),
    )
    _reject_moe_layer_windows(kw, arch)
    kw["intermediate_size"] = cfg["moe_intermediate_size"]
    kw["shared_expert_intermediate"] = cfg["shared_expert_intermediate_size"]
    kw["attn_bias"] = True                    # Qwen2 attention (QKV biases)
    kw["norm_topk_prob"] = cfg.get("norm_topk_prob", False)
    if "router_aux_loss_coef" in cfg:
        kw["router_aux_coef"] = cfg["router_aux_loss_coef"]
    return MoELlamaConfig(**kw)


def _build_qwen3_moe(cfg: dict, arch: str):
    from .moe import MoELlamaConfig

    if cfg.get("mlp_only_layers") or cfg.get("decoder_sparse_step", 1) != 1:
        # dense layers interleaved among MoE layers break the uniform
        # scan-over-layers block — fail loudly, don't silently route
        # everything through experts
        raise ValueError(
            f"{arch}: mlp_only_layers={cfg.get('mlp_only_layers')} / "
            f"decoder_sparse_step={cfg.get('decoder_sparse_step')} mixes "
            f"dense and MoE layers, which this family does not implement "
            f"(uniform MoE blocks only)")
    kw = dict(
        num_experts=cfg["num_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        **_llama_kwargs(cfg),
        **_sliding_window_kw(cfg, arch),
    )
    _reject_moe_layer_windows(kw, arch)
    # the per-expert FFN width is moe_intermediate_size (plain
    # intermediate_size is the dense-MLP width of the mlp_only_layers we
    # just rejected)
    kw["intermediate_size"] = cfg["moe_intermediate_size"]
    kw["qk_norm"] = True                      # Qwen3 attention
    kw["norm_topk_prob"] = cfg.get("norm_topk_prob", False)
    if "router_aux_loss_coef" in cfg:
        kw["router_aux_coef"] = cfg["router_aux_loss_coef"]
    return MoELlamaConfig(**kw)


_ARCH_BUILDERS = {
    "LlamaForCausalLM": ("llama", _build_llama),
    "MistralForCausalLM": ("llama", _build_llama),
    "Qwen2ForCausalLM": ("llama", _build_llama),
    "Qwen3ForCausalLM": ("llama", _build_llama),
    "Olmo2ForCausalLM": ("llama", _build_llama),
    "GemmaForCausalLM": ("llama", _build_llama),
    "Gemma2ForCausalLM": ("llama", _build_llama),
    "GPT2LMHeadModel": ("gpt2", _build_gpt2),
    "MixtralForCausalLM": ("moe", _build_mixtral),
    "Qwen2MoeForCausalLM": ("moe", _build_qwen2_moe),
    "Qwen3MoeForCausalLM": ("moe", _build_qwen3_moe),
    "GPTNeoXForCausalLM": ("neox", _build_neox),
    # Phi-3 is llama-math with fused checkpoint tensors (qkv_proj,
    # gate_up_proj) — the conversion splits them (hf_convert._make_map_llama);
    # its longrope rope_scaling and sliding_window both map onto the native
    # config fields (ops/rope.py; flash kernel SWA)
    "Phi3ForCausalLM": ("llama", _build_llama),
}


def config_from_hf(config_path: str | Path):
    """(family, config) from an HF checkpoint dir or config.json path."""
    path = Path(config_path)
    if path.is_dir():
        path = path / "config.json"
    with open(path) as fp:
        cfg = json.load(fp)
    archs = cfg.get("architectures") or []
    arch = archs[0] if archs else cfg.get("model_type", "?")
    # accept model_type ONLY when architectures is absent (config-only
    # exports) — a present-but-unsupported arch (e.g. a classification
    # head) must hit the loud failure, not get remapped to causal LM
    by_type = {"llama": "LlamaForCausalLM", "mistral": "MistralForCausalLM",
               "qwen2": "Qwen2ForCausalLM", "qwen3": "Qwen3ForCausalLM",
               "gemma": "GemmaForCausalLM", "gemma2": "Gemma2ForCausalLM",
               "olmo2": "Olmo2ForCausalLM",
               "gpt2": "GPT2LMHeadModel", "mixtral": "MixtralForCausalLM",
               "qwen2_moe": "Qwen2MoeForCausalLM",
               "qwen3_moe": "Qwen3MoeForCausalLM",
               "gpt_neox": "GPTNeoXForCausalLM", "phi3": "Phi3ForCausalLM"}
    if not archs and cfg.get("model_type") in by_type:
        arch = by_type[cfg["model_type"]]
    if arch not in _ARCH_BUILDERS:
        raise ValueError(
            f"unsupported architecture {arch!r} in {path}; supported: "
            f"{', '.join(sorted(_ARCH_BUILDERS))}")
    family, build = _ARCH_BUILDERS[arch]
    return family, build(cfg, arch)
