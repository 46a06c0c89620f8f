"""Llama-family decoder in PyTorch: the serving forwards.

Counterpart of ``distributed_training_guide_tpu/models/llama.py``. Params
are the same nested dict as the JAX pytree, with every per-layer leaf
stacked on a leading ``[L]`` axis and weights kept 2-D ([in, out], fused
head dims), so ``models/from_jax.py`` maps the two leaf for leaf. The
JAX ``lax.scan`` over layers is a Python loop over the layer index here.

It carries ``init``, the sublayers, the training forward ``apply`` (the
flash kernels on the card, remat policies through ``ops/remat.py``), the
contiguous-cache ``prefill`` (the engine's bucketed prefill) and
``decode_step`` (the sampler's), and the paged forward
``paged_decode_step`` (decode steps and prefill chunks).
The config flags of the Llama variants stay (sliding and per-layer
windows, QKV biases, q/k norms, post- and sandwich norms, softcaps,
``norm_plus_one``, ``scale_embed``, gelu): they are elementwise work
around the attention, and the kernels take window and softcap.

The serving forwards also take the engine's int8 weights
(``serve/weights.py``): a projection, embedding or head leaf may be a
``Quantized`` container (int8 ``q`` plus fp32 ``scale``), and then goes
through ``ops/quantized_matmul.py`` (the block-dequant kernel K7 on the
card) or ``quantized_take``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.attention import NO_WINDOW, multihead_attention
from ..ops.matmul import matmul_f32_out
from ..ops.quantized_matmul import quantized_matmul, quantized_take
from ..ops.remat import checkpoint_name, remat as remat_layer
from ..ops.rope import freeze_rope_scaling, rope_tables, rotate


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: Optional[tuple] = None   # ops.rope.freeze_rope_scaling form
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    sliding_window: Optional[int] = None   # 0 <= i - j < window; None = full
    attn_bias: bool = False                # QKV biases (Qwen2)
    qk_norm: Any = False                   # False | True (per head) | "flat"
    post_norm: bool = False                # OLMo-2: norms on sublayer outputs
    sandwich_norm: bool = False            # Gemma-2: norms on both sides
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    layer_windows: Optional[tuple] = None  # per-layer window, 0 = full
    act_fn: str = "silu"                   # silu | gelu_tanh
    norm_plus_one: bool = False            # RMSNorm scales by (1 + w)
    scale_embed: bool = False              # embeddings times sqrt(hidden)
    dtype: Any = torch.bfloat16            # activation / compute dtype
    param_dtype: Any = torch.float32       # storage dtype

    @property
    def head_size(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def num_params(self) -> int:
        e, f, v = self.hidden_size, self.intermediate_size, self.vocab_size
        hq = self.num_heads * self.head_size
        hkv = self.num_kv_heads * self.head_size
        per_layer = e * hq + 2 * e * hkv + hq * e + 3 * e * f + 2 * e
        if self.attn_bias:
            per_layer += hq + 2 * hkv
        if self.qk_norm == "flat":
            per_layer += hq + hkv
        elif self.qk_norm:
            per_layer += 2 * self.head_size
        head = 0 if self.tie_word_embeddings else e * v
        return v * e + self.num_layers * per_layer + e + head


def _generator(rng, device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        if device is not None and torch.device(device) != rng.device:
            raise ValueError(f"generator lives on {rng.device}, device "
                             f"{device} was asked for")
        return rng
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(rng))
    return gen


def init_target(rng, device) -> tuple:
    """(generator, device) an init draws with: on ``device="meta"``
    (shapes only, nothing drawn) a CPU generator the meta draws ignore."""
    if device is not None and torch.device(device).type == "meta":
        return torch.Generator(), torch.device("meta")
    gen = _generator(rng, device)
    return gen, gen.device


def init(config: LlamaConfig, rng, *, device=None) -> dict:
    """Random init, normal(0.02) (HF from_config scale), from ``rng`` — a
    ``torch.Generator`` or an int seed for one on ``device`` (default
    cuda; ``"meta"`` gives the leaves' shapes and dtypes, nothing
    allocated). Leaves are drawn in the JAX package's order, so one seed
    gives one set of params on a given device; the bits differ from
    jax's."""
    return _init_on(config, *init_target(rng, device))


def param_shapes(config: LlamaConfig) -> dict:
    """Every leaf's shape, as ``init`` makes it (drawn on the meta device:
    nothing is allocated)."""
    tree = init(config, 0, device="meta")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)
    return shapes(tree)


def _init_on(config: LlamaConfig, gen: torch.Generator, dev) -> dict:
    e, f, v, l = (config.hidden_size, config.intermediate_size,
                  config.vocab_size, config.num_layers)
    d = config.head_size
    hq, hkv = config.num_heads * d, config.num_kv_heads * d
    pdt = config.param_dtype

    def dense(shape):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(0.02).to(pdt)

    def const(shape, value):
        return torch.full(shape, value, device=dev, dtype=pdt)

    attn = {"wq": dense((l, e, hq)), "wk": dense((l, e, hkv)),
            "wv": dense((l, e, hkv)), "wo": dense((l, hq, e))}
    if config.attn_bias:
        attn.update(bq=const((l, hq), 0.0), bk=const((l, hkv), 0.0),
                    bv=const((l, hkv), 0.0))
    if config.qk_norm == "flat":
        attn.update(q_norm=const((l, hq), 1.0), k_norm=const((l, hkv), 1.0))
    elif config.qk_norm:
        attn.update(q_norm=const((l, d), 1.0), k_norm=const((l, d), 1.0))
    embed = dense((v, e))
    layers = {"attn": attn,
              "mlp": {"gate": dense((l, e, f)), "up": dense((l, e, f)),
                      "down": dense((l, f, e))}}
    if config.post_norm:
        norms = ("attn_out_norm", "mlp_out_norm")
    elif config.sandwich_norm:
        norms = ("input_norm", "attn_out_norm", "post_attn_norm",
                 "mlp_out_norm")
    else:
        norms = ("input_norm", "post_attn_norm")
    layers.update({n: const((l, e), 1.0) for n in norms})
    params = {"embed": {"embedding": embed}, "layers": layers,
              "final_norm": const((e,), 1.0)}
    if not config.tie_word_embeddings:
        params["lm_head"] = dense((e, v))
    return params


def param_logical_axes(config: LlamaConfig) -> dict:
    """Logical axis names for every leaf, mirroring ``init``'s structure
    (the JAX package's, leaf for leaf): vocab, embed, heads (fused q-heads
    x head_dim), kv (fused kv-heads), mlp, layers (the stacked axis);
    ``*_vector`` names a 1-d scale or bias. ``parallel/plans.py`` maps them
    to mesh axes."""
    attn_axes = {
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv"),
        "wv": ("layers", "embed", "kv"),
        "wo": ("layers", "heads", "embed"),
    }
    if config.attn_bias:  # biases shard with the head dim they add onto
        attn_axes.update(bq=("layers", "heads"), bk=("layers", "kv"),
                         bv=("layers", "kv"))
    if config.qk_norm == "flat":  # full-width scales shard with their heads
        attn_axes.update(q_norm=("layers", "heads_vector"),
                         k_norm=("layers", "kv_vector"))
    elif config.qk_norm:  # one [head_dim] scale shared by every head: never
        attn_axes.update(q_norm=("layers", "head_dim_vector"),  # sharded
                         k_norm=("layers", "head_dim_vector"))
    layer_axes = {
        "attn": attn_axes,
        "mlp": {
            "gate": ("layers", "embed", "mlp"),
            "up": ("layers", "embed", "mlp"),
            "down": ("layers", "mlp", "embed"),
        },
    }
    if config.post_norm:
        layer_axes.update(attn_out_norm=("layers", "embed_vector"),
                          mlp_out_norm=("layers", "embed_vector"))
    elif config.sandwich_norm:
        layer_axes.update(input_norm=("layers", "embed_vector"),
                          attn_out_norm=("layers", "embed_vector"),
                          post_attn_norm=("layers", "embed_vector"),
                          mlp_out_norm=("layers", "embed_vector"))
    else:
        layer_axes.update(input_norm=("layers", "embed_vector"),
                          post_attn_norm=("layers", "embed_vector"))
    axes = {
        "embed": {"embedding": ("vocab", "embed")},
        "layers": layer_axes,
        "final_norm": ("embed_vector",),
    }
    if not config.tie_word_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


# the param paths a sharding plan's ``LocalLayout`` reads: the token table,
# the untied head (absent where it is tied to the table) and the MLP's
# input projection
LAYOUT_PATHS = {"table": "embed/embedding", "head": "lm_head",
                "mlp_in": "layers/mlp/gate"}


def _is_qt(w) -> bool:
    """Duck-typed ``train/precision.py`` ``Quantized`` check (int8 payload
    plus per-block fp32 scales: the engine's ``weight_dtype='int8'``)."""
    return hasattr(w, "q") and hasattr(w, "scale")


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``params["layers"]`` (views); a
    quantized leaf slices its payload and scales together (indexing the
    NamedTuple itself would pick a field)."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        if _is_qt(tree):
            return type(tree)(q=tree.q[i], scale=tree.scale[i])
        return tree[i]
    return take(params["layers"])


ACT_FNS = {
    "silu": F.silu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def _wmat(h: torch.Tensor, w, cdt) -> torch.Tensor:
    """``h @ w`` in compute dtype; for a quantized weight the block-dequant
    product, summed in fp32 and rounded once to the compute dtype."""
    if _is_qt(w):
        return quantized_matmul(h, w, out_dtype=cdt)
    return h @ w.to(cdt)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = scale.to(torch.float32)
    if plus_one:
        scale = scale + 1.0
    return (x * scale).to(dtype)


def attention_extras(config) -> tuple:
    """(score scale, logit softcap): Gemma-2's query_pre_attn_scalar**-0.5
    and attention softcap, None / None for every other family."""
    qpas = getattr(config, "query_pre_attn_scalar", None)
    return ((qpas ** -0.5) if qpas else None,
            getattr(config, "attn_logit_softcap", None))


def layer_rope(config, positions: torch.Tensor,
               seq_len: Optional[int] = None) -> tuple:
    """The (cos, sin) RoPE tables for ``positions``, computed once per
    forward and shared by every layer (``ops/rope.rope_tables``;
    ``seq_len``: the whole sequence's length where ``positions`` are one
    context-parallel shard)."""
    return rope_tables(config.head_size, positions, config.rope_theta,
                       getattr(config, "rope_scaling", None),
                       config.max_position_embeddings, seq_len)


def attention_sublayer(config, x: torch.Tensor, attn_params: dict,
                       norm_scale, positions: torch.Tensor, attn_impl,
                       rope: tuple, return_kv: bool = False,
                       window_override=None, attend_override=None,
                       standard_layout: bool = True, kv_hook=None,
                       wmat=None):
    """norm -> rope'd GQA attention -> output projection (the caller adds
    the residual). ``rope`` is ``layer_rope(config, positions)``.
    ``kv_hook`` (tensor parallelism, ``parallel/plans.py``) maps the k and
    v projections, fused heads last, to the kv heads this rank's q heads
    read.
    ``wmat`` (the multi-LoRA serving hook, ``_lora_wmat``) is a callable
    ``(name, h, w) -> out`` replacing each projection's ``_wmat``.
    ``return_kv`` also returns the (rope'd) k/v. ``standard_layout``:
    positions are ``arange`` (what lets "auto" pick the flash kernels).
    ``attend_override`` (the serving engine's paged-KV hook) is a callable
    ``(q, k, v, *, window, scale, softcap) -> (attn, aux)`` that replaces
    the attend; ``aux`` comes back in place of (k, v) under
    ``return_kv``."""
    b, s, _ = x.shape
    d = config.head_size
    cdt = config.dtype
    if wmat is None:
        def wmat(name, hh, ww):
            return _wmat(hh, ww, cdt)
    if norm_scale is None:      # post-norm wiring (OLMo-2)
        h = x
    else:
        h = _rmsnorm(x, norm_scale, config.rms_norm_eps,
                     getattr(config, "norm_plus_one", False))
    q, k, v = (wmat(w, h, attn_params[w]) for w in ("wq", "wk", "wv"))
    if "bq" in attn_params:
        q = q + attn_params["bq"].to(cdt)
        k = k + attn_params["bk"].to(cdt)
        v = v + attn_params["bv"].to(cdt)
    if kv_hook is not None:
        k, v = kv_hook(k), kv_hook(v)
    qk_mode = getattr(config, "qk_norm", False)
    if qk_mode == "flat":       # OLMo-2: full-width norm before the reshape
        q = _rmsnorm(q, attn_params["q_norm"], config.rms_norm_eps)
        k = _rmsnorm(k, attn_params["k_norm"], config.rms_norm_eps)
    q = q.reshape(b, s, -1, d)
    k = k.reshape(b, s, -1, d)
    v = v.reshape(b, s, -1, d)
    if qk_mode is True:         # Qwen3: per-head norm before rope
        q = _rmsnorm(q, attn_params["q_norm"], config.rms_norm_eps)
        k = _rmsnorm(k, attn_params["k_norm"], config.rms_norm_eps)
    q = rotate(q, *rope)
    k = rotate(k, *rope)
    window = getattr(config, "sliding_window", None)
    if window_override is not None:
        window = window_override
    attn_scale, softcap = attention_extras(config)
    if attend_override is not None:
        attn, aux = attend_override(q, k, v, window=window, scale=attn_scale,
                                    softcap=softcap)
        out = wmat("wo", attn.reshape(b, s, -1), attn_params["wo"])
        return (out, aux) if return_kv else out
    attn = multihead_attention(q, k, v, causal=True, positions=positions,
                               kv_positions=positions, impl=attn_impl,
                               standard_layout=standard_layout,
                               window=window, scale=attn_scale,
                               logit_softcap=softcap)
    out = wmat("wo", attn.reshape(b, s, -1), attn_params["wo"])
    return (out, (k, v)) if return_kv else out


def mlp_sublayer(config, h: torch.Tensor, mlp: dict,
                 wmat=None) -> torch.Tensor:
    """Gated MLP on the normed stream ``h`` (``_residuals`` norms it and
    adds the residual); ``wmat`` as in ``attention_sublayer``."""
    cdt = config.dtype
    if wmat is None:
        def wmat(name, hh, ww):
            return _wmat(hh, ww, cdt)
    gate = wmat("gate", h, mlp["gate"])
    up = wmat("up", h, mlp["up"])
    gate = ACT_FNS[getattr(config, "act_fn", "silu")](gate)
    # named for the "attn_mlp" remat policy (ops/remat.py)
    with checkpoint_name("mlp_act"):
        act = gate * up
    return wmat("down", act, mlp["down"])


def embed_tokens(config: LlamaConfig, params: dict,
                 input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup (a quantized table dequantizes only the gathered
    rows). Out-of-range ids raise here, where jax would clamp them: the
    engine's ``check_prompt`` refuses them first."""
    table = params["embed"]["embedding"]
    if _is_qt(table):
        x = quantized_take(table, input_ids).to(config.dtype)
    else:
        x = table[input_ids.long()].to(config.dtype)
    if getattr(config, "scale_embed", False):
        x = x * torch.tensor(config.hidden_size ** 0.5, dtype=config.dtype,
                             device=x.device)
    return x


def output_weights(config: LlamaConfig, params: dict) -> torch.Tensor:
    """[E, V] output projection (tied or dedicated), in compute dtype."""
    if config.tie_word_embeddings:
        return params["embed"]["embedding"].T.to(config.dtype)
    return params["lm_head"].to(config.dtype)


def _output_container(config: LlamaConfig, params: dict) -> tuple:
    """The raw output-projection leaf (tied table or lm_head) and whether
    a quantized product runs in transpose form (tied: the blocks tile the
    contracted embedding axis)."""
    if config.tie_word_embeddings:
        return params["embed"]["embedding"], True
    return params["lm_head"], False


def final_hidden(config: LlamaConfig, params: dict,
                 x: torch.Tensor) -> torch.Tensor:
    return _rmsnorm(x, params["final_norm"], config.rms_norm_eps,
                    getattr(config, "norm_plus_one", False))


def lm_head_logits(config: LlamaConfig, params: dict,
                   x: torch.Tensor) -> torch.Tensor:
    """Final norm + output projection, fp32 logits from the fp32
    accumulator of the compute-dtype product (``matmul_f32_out``), as the
    JAX package computes them, on the serve and training paths alike. A
    quantized head gives fp32 logits from ``quantized_matmul`` in either
    form."""
    return _project_head(config, params, final_hidden(config, params, x))


def _project_head(config: LlamaConfig, params: dict,
                  h: torch.Tensor) -> torch.Tensor:
    """fp32 logits of final-normed hidden states ``h``."""
    w, transpose = _output_container(config, params)
    if _is_qt(w):
        logits = quantized_matmul(h, w, transpose=transpose)
    else:
        logits = matmul_f32_out(h, output_weights(config, params))
    cap = getattr(config, "final_logit_softcap", None)
    if cap:
        logits = torch.tanh(logits / cap) * cap
    return logits


class _Whole:
    """``apply``'s layout without a sharding plan, the identity of
    ``parallel/plans.py:LocalLayout``: whole params and the whole sequence
    on one device, no collective (every family's ``apply`` takes it)."""

    def gather_leaf(self, path, local, layer=False):
        return local

    def gather_layer(self, layer):
        return layer

    def enter(self, h, part=None):
        return h

    def leave(self, out, part=None):
        return out

    def kv_hook(self, config):
        return None

    def token_split(self, h):
        """Every token on this device (``models/moe.py``'s dispatch)."""
        return None

    def embed(self, config, params, input_ids):
        return embed_tokens(config, params, input_ids)

    def embed_rows(self, path, table, input_ids):
        return table[input_ids.long()]

    def seq_local(self, x):
        return x

    def positions(self, seq: int, device) -> tuple:
        """(positions [1, seq] of the residual's rows, the whole sequence's
        length for a sequence-dependent rope or None)."""
        return torch.arange(seq, device=device)[None, :], None

    def logits(self, config, params, hidden):
        return _project_head(config, params, hidden)


_WHOLE = _Whole()


def _residuals(config, x, layer, attn, layout=_WHOLE, wmat=None):
    """Residual wiring shared by the training, prefill and paged bodies
    (pre-, post- and sandwich-norm variants). ``attn`` is the attention
    sublayer's output as ``layout`` holds the residual stream; the MLP's
    normed input is brought to the full sequence by ``layout.enter`` and
    its row-parallel output summed back by ``layout.leave``."""
    eps = config.rms_norm_eps
    plus_one = getattr(config, "norm_plus_one", False)
    out_norms = (getattr(config, "post_norm", False)
                 or getattr(config, "sandwich_norm", False))
    x = x + (_rmsnorm(attn, layer["attn_out_norm"], eps, plus_one)
             if out_norms else attn)
    scale = layer.get("post_attn_norm")      # None: post-norm wiring
    h = x if scale is None else _rmsnorm(x, scale, eps, plus_one)
    mlp = layout.leave(mlp_sublayer(config, layout.enter(h, "mlp"),
                                    layer["mlp"], wmat), "mlp")
    return x + (_rmsnorm(mlp, layer["mlp_out_norm"], eps, plus_one)
                if out_norms else mlp)


def layer_windows(config) -> Optional[list]:
    """Per-layer window list (None when uniform; 0 -> no band), the
    counterpart of the JAX package's ``_layer_window_column``."""
    lw = getattr(config, "layer_windows", None)
    if not lw:
        return None
    bad = [w for w in lw if w < 0]
    if bad:
        raise ValueError(f"layer_windows entries must be >= 0 "
                         f"(0 = full attention); got {bad}")
    return [w if w else NO_WINDOW for w in lw]


def _unbind_layers(tree, n: int) -> list:
    """``params["layers"]`` as ``n`` per-layer dicts of views, one
    ``unbind`` per stacked leaf, so backward stacks each leaf's layer
    grads once instead of adding n full-size select grads. A quantized
    leaf unbinds its payload and scales together."""
    if isinstance(tree, dict):
        per = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    if _is_qt(tree):
        return [type(tree)(q=q, scale=s) for q, s in
                zip(torch.unbind(tree.q, 0), torch.unbind(tree.scale, 0))]
    return list(torch.unbind(tree, 0))


def _num_layers(tree) -> int:
    """The leading [L] size of a stacked layers tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return (tree.q if _is_qt(tree) else tree).shape[0]


def model_positions(input_ids: torch.Tensor, positions, layout) -> tuple:
    """(positions [B, S], the rope's sequence length or None, whether the
    layout is standard) of a training forward: the caller's positions, or
    the layout's (``arange``, offset to the rank's shard under context
    parallelism)."""
    standard_layout = positions is None
    seq_len = None
    if positions is None:
        positions, seq_len = layout.positions(input_ids.shape[1],
                                              input_ids.device)
    return positions.expand(input_ids.shape), seq_len, standard_layout


def embed_input(config: LlamaConfig, params: dict, input_ids: torch.Tensor,
                positions: torch.Tensor, layout=_WHOLE) -> torch.Tensor:
    """The residual stream's input (a pipeline's first stage)."""
    return layout.embed(config, params, input_ids)


def block(config: LlamaConfig, x: torch.Tensor, layer: dict, *,
          positions: torch.Tensor, rope: tuple, attn_impl, window=None,
          standard_layout: bool = True, layout=_WHOLE,
          kv_hook=None) -> torch.Tensor:
    """One decoder layer (the JAX package's ``_block``): ``layout`` gathers
    the layer's fsdp shards, brings each sublayer's normed input to the
    full sequence and sums its row-parallel output back."""
    eps = config.rms_norm_eps
    plus_one = getattr(config, "norm_plus_one", False)
    layer = layout.gather_layer(layer)
    h = (x if config.post_norm
         else _rmsnorm(x, layer["input_norm"], eps, plus_one))
    attn = layout.leave(attention_sublayer(
        config, layout.enter(h, "attn"), layer["attn"], None, positions,
        attn_impl, rope, window_override=window,
        standard_layout=standard_layout, kv_hook=kv_hook), "attn")
    return _residuals(config, x, layer, attn, layout)


def run_blocks(config: LlamaConfig, layers: dict, x: torch.Tensor,
               positions: torch.Tensor, *, attn_impl="auto", layout=_WHOLE,
               remat: bool = False, remat_policy=None,
               standard_layout: bool = True, first_layer: int = 0,
               seq_len: Optional[int] = None,
               layer_schedule=None) -> torch.Tensor:
    """The layers of the stacked ``layers`` in order, from global layer
    ``first_layer`` (a pipeline stage runs its slice; ``apply`` all of
    them); each under ``torch.utils.checkpoint`` with ``remat``, or run by
    ``layer_schedule`` (``ops/overlap.py``: it gathers each layer's fsdp
    shards ahead of the layer and owns the remat)."""
    wins = layer_windows(config)
    rope = layer_rope(config, positions, seq_len)
    kv_hook = layout.kv_hook(config)
    lay = (layout if layer_schedule is None
           else layer_schedule.layout_for(layout))

    def one(x, layer, window):
        return block(config, x, layer, positions=positions, rope=rope,
                     attn_impl=attn_impl, window=window,
                     standard_layout=standard_layout, layout=lay,
                     kv_hook=kv_hook)

    if layer_schedule is not None:
        n = _num_layers(layers)
        return layer_schedule(one, x, layers, None if wins is None
                              else wins[first_layer:first_layer + n])
    for i, layer in enumerate(_unbind_layers(layers, _num_layers(layers))):
        window = None if wins is None else wins[first_layer + i]
        if remat:
            x = remat_layer(one, x, layer, window, policy=remat_policy)
        else:
            x = one(x, layer, window)
    return x


def final_layer(config: LlamaConfig, params: dict, x: torch.Tensor,
                layout=_WHOLE) -> torch.Tensor:
    """The final norm (a pipeline's last stage, before the head)."""
    return final_hidden(config, {"final_norm": layout.gather_leaf(
        "final_norm", params["final_norm"])}, x)


def logits_of_hidden(config: LlamaConfig, params: dict, hidden: torch.Tensor,
                     layout=_WHOLE) -> torch.Tensor:
    """fp32 logits of final-normed hidden states, as ``layout`` holds
    them."""
    return layout.logits(config, params, hidden)


def apply(config: LlamaConfig, params: dict, input_ids: torch.Tensor,
          positions: Optional[torch.Tensor] = None, *, remat: bool = False,
          remat_policy=None, attn_impl="auto",
          activation_sharding=None, return_hidden: bool = False,
          layer_schedule=None) -> torch.Tensor:
    """Training forward -> fp32 logits [B, S, V] (or the final-normed
    hidden states [B, S, E] when ``return_hidden``, for chunked losses):
    ``embed_input``, ``run_blocks`` over every layer, ``final_layer`` and
    the head.

    The JAX layer ``lax.scan`` is a Python loop; per-layer windows ride
    ``layer_windows``. ``remat=True`` wraps each layer in
    ``torch.utils.checkpoint`` (non-reentrant) under ``remat_policy``
    (``ops/remat.py``: "all" / None saves nothing, so backward reruns the
    layer's forward, K1 included; "dots", "attn" and "attn_mlp" keep what
    they name). ``positions`` given means a non-standard layout: "auto"
    then takes the einsum attention, as in the JAX package. ``attn_impl``
    may be a callable (``ops/attention.multihead_attention``): the ring or
    Ulysses attention of context parallelism. ``layer_schedule``
    (``ops/overlap.py:LayerSchedule``) runs the layers in place of the
    loop, with the next layer's fsdp gathers issued ahead of each layer
    and its own remat per layer (``remat`` / ``remat_policy`` are then
    its).

    ``activation_sharding`` is a sharding plan's ``LocalLayout``
    (``parallel/plans.py``), where the JAX package takes a NamedSharding:
    ``params`` are then this rank's shards and ``input_ids`` its rows of
    the batch (its sequence shard under context parallelism, whose global
    positions the layout gives). The layout gathers each layer's fsdp
    shards just before the layer (inside the remat scope, so the recompute
    gathers again), brings each sublayer's normed input to the full
    sequence and sums its row-parallel output back onto the residual as it
    holds it (its sequence shard under sequence parallelism), and runs the
    embedding and head on the vocab shards; attention (K1-K3 on the card)
    runs on the rank's own heads. Without a plan the layout is the
    identity."""
    layout = _WHOLE if activation_sharding is None else activation_sharding
    positions, seq_len, standard_layout = model_positions(input_ids,
                                                          positions, layout)
    x = embed_input(config, params, input_ids, positions, layout)
    x = run_blocks(config, params["layers"], x, positions,
                   attn_impl=attn_impl, layout=layout, remat=remat,
                   remat_policy=remat_policy,
                   standard_layout=standard_layout, seq_len=seq_len,
                   layer_schedule=layer_schedule)
    x = final_layer(config, params, x, layout)
    if return_hidden:
        return x
    return logits_of_hidden(config, params, x, layout)


# ---------------------------------------------------------------------------
# Batched multi-LoRA (serve/adapters.py): the low-rank delta
# ``scale * (x @ A_g) @ B_g`` added per target projection as a RAGGED
# GROUPED GEMM (K5) over rows sorted by adapter (S-LoRA arXiv:2311.03285 /
# Punica arXiv:2310.18547: the MoE dispatch applied to the serving batch).
# The base projection is never merged with the delta: over an int8 base
# the base runs through K7 and the delta through K5, and a per-adapter
# merge would materialize [G, in, out] copies of every target.
# ---------------------------------------------------------------------------

def _lora_sort(lora: dict, t: int) -> tuple:
    """The dispatch triplet for the ``[S]`` per-slot adapter vector: the
    stable sort order (``jnp.argsort`` is stable), its inverse, and the
    per-group sorted-row counts (slots per adapter x the T tokens each
    slot contributes) as int32."""
    ids = lora["adapters"].to(torch.int64)
    g = next(iter(lora["stacks"].values()))["a"].shape[1]
    order = torch.argsort(ids, stable=True)
    inv = torch.argsort(order)
    sizes = torch.bincount(ids, minlength=g).to(torch.int32) * t
    return order, inv, sizes


def _lora_wmat(config, lora: dict, i: int, sort: tuple, cut=None):
    """Layer ``i``'s projection hook: the base ``_wmat`` plus the
    grouped-GEMM adapter delta for the targets in ``lora["stacks"]``
    (their layer-``i`` slices, ``a [G, in, r]`` / ``b [G, r, out]``). Slot
    0's rows are zeros, so base-only requests add an exact +0: the cast
    order ``base + (scale * d).to(base.dtype)`` keeps the adapter-0 ==
    base-engine bitwise identity. ``cut`` (serving under a plan,
    ``serve/sharding.py:ServeLayout.lora_cut``): ``cut(name)`` gives a
    function taking (a, b) to the rows and columns the rank's shard of
    the base product holds, or None."""
    from ..ops.grouped_matmul import grouped_matmul

    order, inv, sizes = sort
    cdt = config.dtype
    scale = float(lora["scale"])
    impl = lora.get("impl", "auto")
    stacks = lora["stacks"]

    def wmat(name, h, w):
        base = _wmat(h, w, cdt)
        pair = stacks.get(name)
        if pair is None:
            return base
        s, t, k = h.shape
        a, b = pair["a"][i], pair["b"][i]
        shard = None if cut is None else cut(name)
        if shard is not None:
            a, b = shard(a, b)
        hs = h[order].reshape(s * t, k).to(torch.float32)
        d = grouped_matmul(hs, a, sizes, impl=impl)
        d = grouped_matmul(d, b, sizes, impl=impl)
        d = d.reshape(s, t, -1)[inv]
        return base + (scale * d).to(base.dtype)

    return wmat


def init_cache(config: LlamaConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed per-layer KV cache, [L, B, max_len, kv_heads, head_dim]."""
    shape = (config.num_layers, batch, max_len, config.num_kv_heads,
             config.head_size)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=config.dtype, device=dev),
            "v": torch.zeros(shape, dtype=config.dtype, device=dev)}


def serve_head(layout, lm_head=None, final=None):
    """A family's ``lm_head`` (llama's by default) as a serving ``layout``
    holds the params: its final norm (``final``, the family's
    ``final_layer``) gathered, the whole vocabulary's logits on every rank
    (``serve/sharding.py:ServeLayout``); ``lm_head`` itself without a
    layout. Shared by every family's serve forwards."""
    if layout is None:
        return lm_head or lm_head_logits
    final = final or final_layer

    def head(config, params, x):
        return layout.logits(config, params, final(config, params, x,
                                                   layout))
    return head


@torch.no_grad()
def prefill(config: LlamaConfig, params: dict, input_ids: torch.Tensor,
            cache: dict, last_pos: Optional[int] = None, lora=None,
            layout=None):
    """Causal forward over the prompt through the plain einsum attention,
    writing each layer's rope'd k/v into ``cache[:, :, :prompt_len]`` in
    place. Returns (logits [B, V] at ``last_pos`` — default the final
    position — and the cache).

    ``lora`` (multi-LoRA serving): ``{"scale", "adapters" [B] int,
    "stacks" {t: {"a" [L, G, in, r], "b" [L, G, r, out]}}, "impl"}``:
    each example's adapter delta is added per target projection through
    the grouped GEMM, as in ``paged_decode_step`` (rows = B x P, each
    example's P rows contiguous after the sort). ``layout`` (serving
    under a plan, ``serve/sharding.py:ServeLayout``): ``params`` are this
    rank's shards, the row-parallel outputs summed over tp, the cache
    this rank's kv heads (every one where the pool is whole)."""
    lay = _WHOLE if layout is None else layout
    b, p = input_ids.shape
    positions = torch.arange(p, device=input_ids.device)[None, :].expand(b, -1)
    x = lay.embed(config, params, input_ids)
    wins = layer_windows(config)
    rope = layer_rope(config, positions)
    kv_hook = lay.kv_hook(config)
    cut = getattr(lay, "lora_cut", None)
    sort = None if lora is None else _lora_sort(lora, p)
    for i in range(config.num_layers):
        layer = lay.gather_layer(layer_params(params, i))
        wmat = (None if lora is None
                else _lora_wmat(config, lora, i, sort, cut))
        attn, (k, v) = attention_sublayer(
            config, x, layer["attn"],
            None if config.post_norm else layer["input_norm"], positions,
            "xla", rope, return_kv=True,
            window_override=None if wins is None else wins[i], wmat=wmat,
            kv_hook=kv_hook)
        x = _residuals(config, x, layer, lay.leave(attn, "attn"), lay,
                       wmat=wmat)
        cache["k"][i, :, :p] = k.to(cache["k"].dtype)
        cache["v"][i, :, :p] = v.to(cache["v"].dtype)
    # slice BEFORE the head: one row through the [E, V] projection
    x_last = x[:, -1:] if last_pos is None else x[:, last_pos:last_pos + 1]
    return serve_head(layout)(config, params, x_last)[:, 0], cache


def cache_attend(cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                 positions: torch.Tensor):
    """The contiguous-cache attend of every family's ``decode_step``, as an
    ``attend_override``: the step's k/v go into one layer's cache
    ``[B, max_len, Hkv, D]`` at ``pos`` (in place), then q attends over the
    whole cache through the einsum path; causality masks the positions
    past ``pos``. Returns (attn, None)."""
    def attend(q, k, v, *, window=None, scale=None, softcap=None):
        t = k.shape[1]
        cache_k[:, pos:pos + t] = k.to(cache_k.dtype)
        cache_v[:, pos:pos + t] = v.to(cache_v.dtype)
        kv_pos = torch.arange(cache_k.shape[1], device=q.device)[None, :]
        attn = multihead_attention(
            q, cache_k, cache_v, causal=True, positions=positions,
            kv_positions=kv_pos.expand(q.shape[0], -1), impl="xla",
            standard_layout=False, window=window, scale=scale,
            logit_softcap=softcap)
        return attn, None

    return attend


def step_positions(token_ids: torch.Tensor, pos: int) -> torch.Tensor:
    """[B, 1] positions of a contiguous-cache decode step at ``pos``."""
    return torch.full((token_ids.shape[0], 1), int(pos), dtype=torch.long,
                      device=token_ids.device)


@torch.no_grad()
def decode_step(config: LlamaConfig, params: dict, token_ids: torch.Tensor,
                pos: int, cache: dict):
    """One contiguous-cache decode step (``models/sample.py``):
    ``token_ids`` [B, 1] at position ``pos``, each layer's rope'd k/v
    written into ``cache`` (``init_cache``) in place. Returns (logits
    [B, V], the cache)."""
    positions = step_positions(token_ids, pos)
    x = embed_tokens(config, params, token_ids)
    wins = layer_windows(config)
    rope = layer_rope(config, positions)
    for i in range(config.num_layers):
        layer = layer_params(params, i)
        attn = attention_sublayer(
            config, x, layer["attn"],
            None if config.post_norm else layer["input_norm"], positions,
            "xla", rope, window_override=None if wins is None else wins[i],
            attend_override=cache_attend(cache["k"][i], cache["v"][i], pos,
                                         positions))
        x = _residuals(config, x, layer, attn)
    return lm_head_logits(config, params, x)[:, -1], cache


def paged_positions(token_ids: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """[S, T] absolute positions: slot s's T tokens sit at
    ``positions[s] + 0..T-1``."""
    t = token_ids.shape[1]
    return positions[:, None] + torch.arange(
        t, dtype=positions.dtype, device=positions.device)[None, :]


def paged_logits_at(lm_head, config, params, x, last_index,
                    all_logits=False):
    """The logits the caller wants, sliced BEFORE the head: the last
    position (``last_index`` None) or one given index; ``all_logits``
    keeps every position ([S, T, V]), one target distribution per drafted
    token of a speculative verify forward (T = k + 1 there)."""
    if all_logits:
        return lm_head(config, params, x)
    if last_index is None:
        x_last = x[:, -1:]
    else:
        x_last = x[:, last_index:last_index + 1]
    return lm_head(config, params, x_last)[:, 0]


def _layer_pools(pool, i):
    """Layer ``i`` of a page pool: a [P, page, Hkv, D] view, or a
    Quantized of views (payload and scales)."""
    if hasattr(pool, "scale"):
        return type(pool)(q=pool.q[i], scale=pool.scale[i])
    return pool[i]


@torch.no_grad()
def paged_decode_step(config: LlamaConfig, params: dict,
                      token_ids: torch.Tensor, positions: torch.Tensor,
                      cache: dict, attend, last_index=None,
                      all_logits=False, lora=None, layout=None):
    """One step over a PAGED multi-request cache: ``token_ids`` [S, T] are
    each slot's next T tokens starting at per-slot ``positions`` [S]
    (T == 1 the batched decode step, T > 1 a prefill chunk, where
    ``last_index`` picks the real last token's logits, or a speculative
    verify forward, where ``all_logits`` keeps [S, T, V]). ``lora``
    (multi-LoRA serving, as in ``prefill``, ``adapters`` [S]): per-slot
    adapter deltas as one ragged grouped GEMM per target product per layer,
    the slots sorted by adapter and unsorted after. ``cache`` holds
    the page pools ``{"k", "v"}: [L, n_pages, page, kvh, hd]`` and
    ``attend(q, k, v, kp, vp, *, window, scale, softcap)`` (built by
    ``serve/kv_pages.make_attend``) writes the new k/v into one layer's
    pages IN PLACE and attends each slot over its block table. ``layout``
    as in ``prefill`` (the pages are this rank's). Returns (logits [S, V]
    and the cache)."""
    lay = _WHOLE if layout is None else layout
    pos2d = paged_positions(token_ids, positions)
    x = lay.embed(config, params, token_ids)
    wins = layer_windows(config)
    rope = layer_rope(config, pos2d)
    kv_hook = lay.kv_hook(config)
    cut = getattr(lay, "lora_cut", None)
    sort = None if lora is None else _lora_sort(lora, token_ids.shape[1])
    for i in range(config.num_layers):
        layer = lay.gather_layer(layer_params(params, i))
        wmat = (None if lora is None
                else _lora_wmat(config, lora, i, sort, cut))
        kp, vp = _layer_pools(cache["k"], i), _layer_pools(cache["v"], i)

        def override(q, k, v, *, window, scale, softcap, kp=kp, vp=vp):
            return attend(q, k, v, kp, vp, window=window, scale=scale,
                          softcap=softcap)

        attn = attention_sublayer(
            config, x, layer["attn"],
            None if config.post_norm else layer["input_norm"], pos2d, "xla",
            rope, window_override=None if wins is None else wins[i],
            attend_override=override, wmat=wmat, kv_hook=kv_hook)
        x = _residuals(config, x, layer, lay.leave(attn, "attn"), lay,
                       wmat=wmat)
    return (paged_logits_at(serve_head(layout), config, params, x,
                            last_index, all_logits), cache)


# ---------------------------------------------------------------------------
# Presets: the JAX package's shapes (public model cards).
# ---------------------------------------------------------------------------

_LLAMA3_ROPE_8X = freeze_rope_scaling({
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 8192})
_LLAMA3_ROPE_32X = freeze_rope_scaling({
    "rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 8192})

PRESETS = {
    "llama-debug": LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                               num_layers=2, num_heads=4, num_kv_heads=2,
                               max_position_embeddings=256),
    "tinyllama-1.1b": LlamaConfig(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                                  num_layers=22, num_heads=32, num_kv_heads=4),
    "llama-650m": LlamaConfig(vocab_size=32000, hidden_size=1536, intermediate_size=6144,
                              num_layers=16, num_heads=12, num_kv_heads=4,
                              max_position_embeddings=4096),
    "llama-1b-hd128": LlamaConfig(vocab_size=32000, hidden_size=2048,
                                  intermediate_size=8192, num_layers=16,
                                  num_heads=16, num_kv_heads=4,
                                  max_position_embeddings=4096),
    "llama-3.2-1b": LlamaConfig(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
                                num_layers=16, num_heads=32, num_kv_heads=8,
                                rope_theta=500000.0, max_position_embeddings=131072,
                                rope_scaling=_LLAMA3_ROPE_32X,
                                tie_word_embeddings=True),
    "llama-3.2-3b": LlamaConfig(vocab_size=128256, hidden_size=3072, intermediate_size=8192,
                                num_layers=28, num_heads=24, num_kv_heads=8,
                                rope_theta=500000.0, max_position_embeddings=131072,
                                rope_scaling=_LLAMA3_ROPE_32X,
                                tie_word_embeddings=True),
    "llama-3.1-8b": LlamaConfig(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                                num_layers=32, num_heads=32, num_kv_heads=8,
                                rope_theta=500000.0, max_position_embeddings=131072,
                                rope_scaling=_LLAMA3_ROPE_8X),
    "llama-3.1-70b": LlamaConfig(vocab_size=128256, hidden_size=8192, intermediate_size=28672,
                                 num_layers=80, num_heads=64, num_kv_heads=8,
                                 rope_theta=500000.0, max_position_embeddings=131072,
                                 rope_scaling=_LLAMA3_ROPE_8X),
    "llama-3.1-405b": LlamaConfig(vocab_size=128256, hidden_size=16384, intermediate_size=53248,
                                  num_layers=126, num_heads=128, num_kv_heads=8,
                                  rope_theta=500000.0, max_position_embeddings=131072,
                                  rope_scaling=_LLAMA3_ROPE_8X),
    "mistral-7b": LlamaConfig(vocab_size=32768, hidden_size=4096, intermediate_size=14336,
                              num_layers=32, num_heads=32, num_kv_heads=8,
                              rope_theta=1e6, max_position_embeddings=32768),
    "gemma-2b": LlamaConfig(vocab_size=256000, hidden_size=2048, intermediate_size=16384,
                            num_layers=18, num_heads=8, num_kv_heads=1, head_dim=256,
                            act_fn="gelu_tanh", norm_plus_one=True, scale_embed=True,
                            rms_norm_eps=1e-6, tie_word_embeddings=True,
                            max_position_embeddings=8192),
    "gemma-7b": LlamaConfig(vocab_size=256000, hidden_size=3072, intermediate_size=24576,
                            num_layers=28, num_heads=16, num_kv_heads=16, head_dim=256,
                            act_fn="gelu_tanh", norm_plus_one=True, scale_embed=True,
                            rms_norm_eps=1e-6, tie_word_embeddings=True,
                            max_position_embeddings=8192),
    "gemma2-2b": LlamaConfig(vocab_size=256000, hidden_size=2304, intermediate_size=9216,
                             num_layers=26, num_heads=8, num_kv_heads=4, head_dim=256,
                             act_fn="gelu_tanh", norm_plus_one=True, scale_embed=True,
                             sandwich_norm=True, rms_norm_eps=1e-6,
                             tie_word_embeddings=True, attn_logit_softcap=50.0,
                             final_logit_softcap=30.0, query_pre_attn_scalar=256.0,
                             layer_windows=tuple(4096 if i % 2 == 0 else 0
                                                 for i in range(26)),
                             max_position_embeddings=8192),
    "gemma2-9b": LlamaConfig(vocab_size=256000, hidden_size=3584, intermediate_size=14336,
                             num_layers=42, num_heads=16, num_kv_heads=8, head_dim=256,
                             act_fn="gelu_tanh", norm_plus_one=True, scale_embed=True,
                             sandwich_norm=True, rms_norm_eps=1e-6,
                             tie_word_embeddings=True, attn_logit_softcap=50.0,
                             final_logit_softcap=30.0, query_pre_attn_scalar=256.0,
                             layer_windows=tuple(4096 if i % 2 == 0 else 0
                                                 for i in range(42)),
                             max_position_embeddings=8192),
    "qwen2.5-0.5b": LlamaConfig(vocab_size=151936, hidden_size=896, intermediate_size=4864,
                                num_layers=24, num_heads=14, num_kv_heads=2,
                                rope_theta=1e6, rms_norm_eps=1e-6, attn_bias=True,
                                tie_word_embeddings=True,
                                max_position_embeddings=32768),
    "qwen2.5-7b": LlamaConfig(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                              num_layers=28, num_heads=28, num_kv_heads=4,
                              rope_theta=1e6, rms_norm_eps=1e-6, attn_bias=True,
                              max_position_embeddings=32768),
    "qwen3-0.6b": LlamaConfig(vocab_size=151936, hidden_size=1024, intermediate_size=3072,
                              num_layers=28, num_heads=16, num_kv_heads=8,
                              head_dim=128, qk_norm=True, rope_theta=1e6,
                              rms_norm_eps=1e-6, tie_word_embeddings=True,
                              max_position_embeddings=40960),
    "qwen3-8b": LlamaConfig(vocab_size=151936, hidden_size=4096, intermediate_size=12288,
                            num_layers=36, num_heads=32, num_kv_heads=8,
                            head_dim=128, qk_norm=True, rope_theta=1e6,
                            rms_norm_eps=1e-6,
                            max_position_embeddings=40960),
    "olmo2-7b": LlamaConfig(vocab_size=100352, hidden_size=4096, intermediate_size=11008,
                            num_layers=32, num_heads=32, num_kv_heads=32,
                            post_norm=True, qk_norm="flat",
                            rope_theta=500000.0, rms_norm_eps=1e-6,
                            max_position_embeddings=4096),
}
