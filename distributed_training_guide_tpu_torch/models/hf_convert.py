"""Pretrained-weight logistics: HF safetensors -> stream-convert -> sharded
load.

Counterpart of ``distributed_training_guide_tpu/models/hf_convert.py``,
whose converted format it writes and reads, so one conversion serves both
packages. The reference's 405B recipe loads the whole state dict on rank
0's CPU and broadcasts it (``05-training-llama-405b/train_llm.py:74-146``);
here neither happens:

1. ``convert_hf_checkpoint`` streams tensor by tensor out of the
   safetensors shards into one ``.npy`` memmap per parameter leaf
   (``<leaf path joined by ".">.npy``; the stacked ``[L, ...]`` layer
   arrays are filled slice by slice) plus a ``manifest.json``, so peak
   anonymous host memory is a few tensors, never the model.
2. ``load_pretrained`` memmaps each leaf and reads only this rank's slice
   of it under the sharding plan's spec (``parallel/plans.py``), straight
   into a tensor on the rank's device. No rank-0 load, no broadcast.

The name maps are the JAX module's, for the llama family (Llama, Mistral,
Qwen2, Qwen3, Gemma, Gemma-2, OLMo-2 and Phi-3, whose fused ``qkv_proj``
and ``gate_up_proj`` split into several leaves), the moe family
(Mixtral, Qwen2-MoE with its shared expert, Qwen3-MoE), GPT-2 and
GPT-NeoX. torch's ``Linear`` stores ``[out, in]``, so the weights
transpose into the port's ``[in, out]`` leaves; GPT-2's ``Conv1D`` is
already ``[in, out]`` (its fused ``c_attn`` ``[E, 3E]`` re-factors into
the ``[E, 3, E]`` leaf, ``_write_leaf``), and GPT-NeoX's per-head
interleaved ``query_key_value`` is de-interleaved here, at conversion.
"""
from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

LOGGER = logging.getLogger(__name__)

LEAF_SEP = "."


# ---------------------------------------------------------------------------
# family name maps: HF tensor name -> (leaf_path, layer_idx|None, transpose)
# ---------------------------------------------------------------------------

def _map_llama(name: str):
    name = name.removeprefix("model.")
    m = re.match(r"layers\.(\d+)\.(.+)", name)
    if m:
        idx, rest = int(m.group(1)), m.group(2)
        table = {
            "self_attn.q_proj.weight": ("layers.attn.wq", True),
            "self_attn.k_proj.weight": ("layers.attn.wk", True),
            "self_attn.v_proj.weight": ("layers.attn.wv", True),
            "self_attn.o_proj.weight": ("layers.attn.wo", True),
            "mlp.gate_proj.weight": ("layers.mlp.gate", True),
            "mlp.up_proj.weight": ("layers.mlp.up", True),
            "mlp.down_proj.weight": ("layers.mlp.down", True),
            "input_layernorm.weight": ("layers.input_norm", False),
            "post_attention_layernorm.weight": ("layers.post_attn_norm", False),
            # Qwen2-style QKV biases (absent in Llama/Mistral checkpoints)
            "self_attn.q_proj.bias": ("layers.attn.bq", False),
            "self_attn.k_proj.bias": ("layers.attn.bk", False),
            "self_attn.v_proj.bias": ("layers.attn.bv", False),
            # Qwen3-style per-head q/k RMSNorm scales ([head_dim] vectors)
            "self_attn.q_norm.weight": ("layers.attn.q_norm", False),
            "self_attn.k_norm.weight": ("layers.attn.k_norm", False),
        }
        if rest in table:
            leaf, t = table[rest]
            return leaf, idx, t
        return None
    table = {
        "embed_tokens.weight": ("embed.embedding", False),
        "norm.weight": ("final_norm", False),
        "lm_head.weight": ("lm_head", True),
    }
    if name in table:
        leaf, t = table[name]
        return leaf, None, t
    return None


def _map_gpt2(name: str):
    """HF ``GPT2LMHeadModel`` -> the gpt2 layout (``models/gpt2.py``):
    ``Conv1D`` stores ``[in, out]``, so nothing transposes; the tied
    ``lm_head`` maps to nothing."""
    name = name.removeprefix("transformer.")
    m = re.match(r"h\.(\d+)\.(.+)", name)
    if m:
        idx, rest = int(m.group(1)), m.group(2)
        table = {
            "ln_1.weight": "layers.ln1.scale", "ln_1.bias": "layers.ln1.bias",
            "attn.c_attn.weight": "layers.attn.wqkv",
            "attn.c_attn.bias": "layers.attn.bqkv",
            "attn.c_proj.weight": "layers.attn.wo",
            "attn.c_proj.bias": "layers.attn.bo",
            "ln_2.weight": "layers.ln2.scale", "ln_2.bias": "layers.ln2.bias",
            "mlp.c_fc.weight": "layers.mlp.wi", "mlp.c_fc.bias": "layers.mlp.bi",
            "mlp.c_proj.weight": "layers.mlp.wo",
            "mlp.c_proj.bias": "layers.mlp.bo",
        }
        return (table[rest], idx, False) if rest in table else None
    table = {"wte.weight": "wte", "wpe.weight": "wpe",
             "ln_f.weight": "lnf.scale", "ln_f.bias": "lnf.bias"}
    return (table[name], None, False) if name in table else None


def _make_map_neox(config):
    """HF ``GPTNeoXForCausalLM`` -> the neox layout (``models/neox.py``).
    The fused ``query_key_value`` Linear interleaves PER HEAD on its out
    dim (``[heads, 3, head_dim]`` flattened), the port's leaf is ``[E, 3,
    heads*head_dim]``: its transform de-interleaves (needing the head
    shape, hence the factory)."""
    h, d = config.num_heads, config.head_size

    def deinterleave_qkv_w(w):   # [3e, e] Linear [out, in], out = (h, 3, d)
        e = w.shape[1]
        return w.reshape(h, 3, d, e).transpose(3, 1, 0, 2).reshape(e, 3, h * d)

    def deinterleave_qkv_b(b):   # [3e] = (h, 3, d)
        return b.reshape(h, 3, d).transpose(1, 0, 2).reshape(3, h * d)

    def mapper(name: str):
        if name == "embed_out.weight":   # untied head, outside gpt_neox.*
            return "embed_out", None, True
        name = name.removeprefix("gpt_neox.")
        m = re.match(r"layers\.(\d+)\.(.+)", name)
        if m:
            idx, rest = int(m.group(1)), m.group(2)
            table = {
                "input_layernorm.weight": ("layers.ln1.scale", False),
                "input_layernorm.bias": ("layers.ln1.bias", False),
                "post_attention_layernorm.weight": ("layers.ln2.scale", False),
                "post_attention_layernorm.bias": ("layers.ln2.bias", False),
                "attention.query_key_value.weight":
                    ("layers.attn.wqkv", deinterleave_qkv_w),
                "attention.query_key_value.bias":
                    ("layers.attn.bqkv", deinterleave_qkv_b),
                "attention.dense.weight": ("layers.attn.wo", True),
                "attention.dense.bias": ("layers.attn.bo", False),
                "mlp.dense_h_to_4h.weight": ("layers.mlp.wi", True),
                "mlp.dense_h_to_4h.bias": ("layers.mlp.bi", False),
                "mlp.dense_4h_to_h.weight": ("layers.mlp.wo", True),
                "mlp.dense_4h_to_h.bias": ("layers.mlp.bo", False),
            }
            if rest in table:
                leaf, t = table[rest]
                return leaf, idx, t
            return None   # attention.bias mask buffers, rotary inv_freq
        table = {"embed_in.weight": "embed_in",
                 "final_layer_norm.weight": "lnf.scale",
                 "final_layer_norm.bias": "lnf.bias"}
        return (table[name], None, False) if name in table else None

    return mapper


def _map_mixtral(name: str):
    """HF ``MixtralForCausalLM`` (and the Qwen MoE spellings) -> the moe
    family layout (``models/moe.py``): per-expert Linears stack onto the
    ``[L, E, ...]`` expert dim via a (layer, expert) index pair (w1=gate,
    w3=up, w2=down in HF's SwiGLU naming), plus the router Linear;
    everything else shares Llama's names and delegates to ``_map_llama``."""
    m = re.match(r"model\.layers\.(\d+)\.block_sparse_moe\.(.+)", name)
    if m:
        idx, rest = int(m.group(1)), m.group(2)
        e = re.match(r"experts\.(\d+)\.(w[123])\.weight", rest)
        if e:
            leaf = {"w1": "layers.moe.gate", "w2": "layers.moe.down",
                    "w3": "layers.moe.up"}[e.group(2)]
            return leaf, (idx, int(e.group(1))), True
        if rest == "gate.weight":
            return "layers.moe.router", idx, True
        return None
    # Qwen2/3-MoE spell the same block `mlp.` with llama-style expert names
    # and `mlp.gate` as the router; Qwen2-MoE adds the shared expert and
    # its scalar gate
    m = re.match(r"model\.layers\.(\d+)\.mlp\.(.+)", name)
    if m:
        idx, rest = int(m.group(1)), m.group(2)
        e = re.match(r"experts\.(\d+)\.(gate_proj|up_proj|down_proj)\.weight",
                     rest)
        if e:
            leaf = {"gate_proj": "layers.moe.gate",
                    "up_proj": "layers.moe.up",
                    "down_proj": "layers.moe.down"}[e.group(2)]
            return leaf, (idx, int(e.group(1))), True
        if rest == "gate.weight":
            return "layers.moe.router", idx, True
        shared = {"shared_expert.gate_proj.weight": "layers.moe.shared_gate_proj",
                  "shared_expert.up_proj.weight": "layers.moe.shared_up",
                  "shared_expert.down_proj.weight": "layers.moe.shared_down"}
        if rest in shared:
            return shared[rest], idx, True
        if rest == "shared_expert_gate.weight":   # [1, E] Linear -> [E]
            return "layers.moe.shared_gate", idx, lambda w: w[0]
        return None
    return _map_llama(name)


def _make_map_llama(config):
    """Llama-family mapper with the Phi-3 fused layouts (``qkv_proj`` rows
    [hq + 2 hkv, E], ``gate_up_proj`` [2F, E]): a mapper may return a LIST
    of (leaf, layer, transform), one source tensor filling several leaves;
    and the OLMo-2 / Gemma-2 norms that reuse llama's names for other
    slots."""
    d = config.head_size
    hq, hkv = config.num_heads * d, config.num_kv_heads * d
    f = config.intermediate_size

    post_norm = getattr(config, "post_norm", False)
    sandwich = getattr(config, "sandwich_norm", False)

    def mapper(name: str):
        m = re.match(r"model\.layers\.(\d+)\.(.+)", name)
        if m:
            idx, rest = int(m.group(1)), m.group(2)
            if rest == "self_attn.qkv_proj.weight":
                return [("layers.attn.wq", idx, lambda w: w[:hq].T),
                        ("layers.attn.wk", idx, lambda w: w[hq:hq + hkv].T),
                        ("layers.attn.wv", idx, lambda w: w[hq + hkv:].T)]
            if rest == "mlp.gate_up_proj.weight":
                return [("layers.mlp.gate", idx, lambda w: w[:f].T),
                        ("layers.mlp.up", idx, lambda w: w[f:].T)]
            if post_norm or sandwich:
                # OLMo-2 / Gemma-2 apply post_attention_layernorm to the
                # attention OUTPUT; plus a norm on the MLP output
                if rest == "post_attention_layernorm.weight":
                    return "layers.attn_out_norm", idx, False
                if rest == "post_feedforward_layernorm.weight":
                    return "layers.mlp_out_norm", idx, False
            if sandwich and rest == "pre_feedforward_layernorm.weight":
                # Gemma-2's pre-FFN norm fills llama's post_attn_norm slot
                return "layers.post_attn_norm", idx, False
        return _map_llama(name)

    return mapper


def family_mapper(family: str, config) -> Callable:
    """The HF-name mapper of a family."""
    if family == "llama":
        return _make_map_llama(config)
    if family == "moe":
        return _map_mixtral
    if family == "gpt2":
        return _map_gpt2
    if family == "neox":
        return _make_map_neox(config)
    raise KeyError(f"no HF name map for the {family!r} family")


# ---------------------------------------------------------------------------
# conversion (streaming)
# ---------------------------------------------------------------------------

def leaf_shapes(bundle) -> dict:
    """{leaf path joined by ".": (shape, torch dtype)} of the bundle's
    params, from an init on the meta device (nothing allocated)."""
    from ..train.state import named_leaves

    tree = bundle.init(bundle.config, 0, device="meta")
    return {path.replace("/", LEAF_SEP): (tuple(t.shape), t.dtype)
            for path, t in named_leaves(tree)}


def convert_hf_checkpoint(hf_dir: str | Path, out_dir: str | Path,
                          model_name: Optional[str] = None, *, bundle=None,
                          dtype: str = "float32") -> Path:
    """Stream every safetensors shard in ``hf_dir`` into per-leaf ``.npy``
    memmaps under ``out_dir`` (the JAX package's format, byte for byte).
    Peak anonymous memory is a few tensors. Pass either a registry
    ``model_name`` (``hf:<dir>`` too) or a ``bundle``."""
    from safetensors import safe_open

    from .registry import get_model

    if bundle is None:
        bundle = get_model(model_name)
    model_name = model_name or bundle.name
    mapper = family_mapper(bundle.family, bundle.config)
    shapes = leaf_shapes(bundle)
    hf_dir, out_dir = Path(hf_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    memmaps: dict[str, np.memmap] = {}

    def leaf_mm(leaf: str) -> np.memmap:
        if leaf not in memmaps:
            memmaps[leaf] = np.lib.format.open_memmap(
                out_dir / f"{leaf}.npy", mode="w+", dtype=np.dtype(dtype),
                shape=shapes[leaf][0])
        return memmaps[leaf]

    seen = set()
    files = sorted(hf_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {hf_dir}")
    for f in files:
        with safe_open(str(f), framework="pt") as sf:
            for name in sf.keys():
                mapped = mapper(name)
                if mapped is None:
                    LOGGER.info(f"skipping unmapped tensor {name}")
                    continue
                entries = mapped if isinstance(mapped, list) else [mapped]
                # bf16 widens to fp32 exactly, as the JAX converter's
                # bit shift does
                source = sf.get_tensor(name).float().numpy()
                for leaf, layer, transpose in entries:
                    if leaf not in shapes:
                        continue  # e.g. lm_head when tied
                    tensor = source
                    if callable(transpose):
                        tensor = transpose(tensor)
                    elif transpose:
                        tensor = tensor.T
                    _write_leaf(name, tensor, leaf, layer, leaf_mm, seen)
                del source
    for mm in memmaps.values():
        mm.flush()
    missing = sorted(set(shapes) - set(memmaps))
    if missing:
        LOGGER.warning(f"no tensor of {hf_dir} filled {missing}")
    with open(out_dir / "manifest.json", "w") as fp:
        json.dump({"model_name": model_name, "dtype": dtype,
                   "leaves": sorted(memmaps)}, fp, indent=2)
    LOGGER.info(f"converted {len(seen)} tensors -> {out_dir}")
    return out_dir


def _write_leaf(name: str, tensor: np.ndarray, leaf: str, layer,
                leaf_mm, seen: set) -> None:
    """Place one (possibly transformed) tensor into its leaf memmap slot:
    the whole leaf (``layer`` None), one layer of a stacked leaf (an int),
    or one (layer, expert) cell of an ``[L, E, ...]`` stack (a tuple)."""
    mm = leaf_mm(leaf)
    if layer is not None and not isinstance(layer, tuple):
        layer = (layer,)
    target = mm.shape if layer is None else mm.shape[len(layer):]
    if tensor.shape != tuple(target):
        # only trailing dims may be re-factored; a leading-dim mismatch
        # (a transposed source) must stay loud
        if tensor.ndim > 1 and tensor.shape[:1] != tuple(target[:1]):
            raise ValueError(
                f"{name}: shape {tensor.shape} does not match "
                f"target {tuple(target)} for leaf {leaf!r} "
                f"(transposed source layout?)")
        tensor = tensor.reshape(target)
    if layer is None:
        mm[...] = tensor
    else:
        mm[layer] = tensor
    seen.add((leaf, layer))


# ---------------------------------------------------------------------------
# sharded load
# ---------------------------------------------------------------------------

def _rank_slices(plan, spec: tuple, shape: tuple) -> tuple:
    """The index of this rank's shard of a ``shape`` leaf laid out by
    ``spec`` (``ShardingPlan.shard``'s narrowing, as slices)."""
    from ..parallel.plans import entry_axes

    out = []
    for d, n in enumerate(shape):
        axes = entry_axes(spec[d]) if d < len(spec) else ()
        if not axes:
            out.append(slice(None))
            continue
        size = n // int(np.prod([plan.sizes[a] for a in axes]))
        lo = plan.rank_over(axes) * size
        out.append(slice(lo, lo + size))
    return tuple(out)


def load_pretrained(bundle, plan, out_dir: str | Path, *,
                    param_dtype: Optional[torch.dtype] = None,
                    device=None) -> dict:
    """A converted checkpoint as the params tree on ``device`` (default
    cuda). With a sharding ``plan`` every leaf is this rank's shard of it
    (its spec from the plan's rules, ``plan.param_specs``), read from the
    memmap as that slice only; with ``plan`` None the whole leaves. Leaves
    are cast to ``param_dtype`` (default: the config's)."""
    from .._device import resolve_device
    from ..train.state import named_leaves

    device = resolve_device(device)
    out_dir = Path(out_dir)
    shapes = leaf_shapes(bundle)
    specs = {}
    if plan is not None:
        specs = {path.replace("/", LEAF_SEP): spec for path, spec in
                 named_leaves(plan.param_specs(bundle.logical_axes(),
                                               bundle.shapes()))}
    leaves = {}
    for leaf, (shape, dt) in shapes.items():
        path = out_dir / f"{leaf}.npy"
        if not path.exists():
            raise FileNotFoundError(f"missing converted leaf {path}")
        mm = np.load(path, mmap_mode="r")
        if tuple(mm.shape) != shape:
            raise ValueError(f"{leaf}: converted shape {mm.shape} != model "
                             f"{shape}")
        idx = (_rank_slices(plan, specs[leaf], shape) if plan is not None
               else (slice(None),) * len(shape))
        # a copy of this slice only: no other page of the file is read
        host = torch.from_numpy(np.array(mm[idx]))
        leaves[leaf] = host.to(param_dtype or dt).to(device)
        del mm
    tree: dict = {}
    for leaf, t in leaves.items():
        node = tree
        *head, last = leaf.split(LEAF_SEP)
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree
