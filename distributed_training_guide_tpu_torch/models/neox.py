"""GPT-NeoX / Pythia decoder in PyTorch.

Counterpart of ``distributed_training_guide_tpu/models/neox.py``, leaf for
leaf (``models/from_jax.py``). What sets the family apart:

- the parallel residual (``use_parallel_residual``): ``x + attn(ln1 x) +
  mlp(ln2 x)``, one residual update per layer; under tensor parallelism
  the two row-parallel partial sums are added before ONE reduction, where
  the sequential block needs two;
- partial rotary (``rotary_pct``, 0.25 for Pythia): RoPE turns only the
  first ``rotary_ndims`` dims of each head, with frequencies computed over
  ``rotary_ndims`` (HF's ``GPTNeoXRotaryEmbedding``); the rest pass
  through;
- LayerNorm with bias, the exact (erf) GELU MLP with biases, fused QKV
  ``[L, E, 3, H*D]`` (gpt2's layout; the HF per-head interleave is undone
  at conversion, ``models/hf_convert.py``), multi-head attention, and
  untied ``embed_in`` / ``embed_out``.

q and k come out of the partial rope contiguous; v is a strided slice of
the fused projection, which the flash kernels read through its strides.
gpt-neox-20b's head_dim of 96 is not a flash head_dim: its training
attention takes the einsum path ("auto", as the JAX package's alignment
rule picks). The serving engine's paged attend takes it (K4 at D 96).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..ops.matmul import matmul_f32_out
from ..ops.remat import checkpoint_name, remat as remat_layer
from ..ops.rope import rope_tables, rotate
from .gpt2 import attend_or_override, fused_qkv, layernorm
from .llama import (_WHOLE, _layer_pools, _num_layers, _unbind_layers,
                    serve_head,
                    cache_attend, model_positions,
                    init_cache, init_target, layer_params, paged_logits_at,
                    paged_positions, step_positions)


@dataclasses.dataclass(frozen=True)
class NeoXConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 24
    num_heads: int = 16
    max_position_embeddings: int = 2048
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    rope_scaling: Optional[tuple] = None  # ops.rope.freeze_rope_scaling form
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    act_fn: str = "gelu"            # exact erf gelu (HF hidden_act="gelu")
    dtype: Any = torch.bfloat16     # activation / compute dtype
    param_dtype: Any = torch.float32

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        return self.num_heads          # multi-head attention

    @property
    def rotary_ndims(self) -> int:
        n = int(self.head_size * self.rotary_pct)
        return n - (n % 2)  # the half-rotation needs an even count

    def num_params(self) -> int:
        e, f, v, l = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_layers)
        per_layer = (3 * e * e + 3 * e        # fused qkv
                     + e * e + e              # out proj
                     + e * f + f + f * e + e  # mlp
                     + 4 * e)                 # two layernorms
        return 2 * v * e + l * per_layer + 2 * e  # embed_in/out + final ln


def init(config: NeoXConfig, rng, *, device=None) -> dict:
    """Random init in the JAX package's leaf order (normal(0.02) weights,
    zero biases, unit LayerNorm scales); ``rng`` and ``device`` as
    ``llama.init``."""
    gen, dev = init_target(rng, device)
    e, f, v, l = (config.hidden_size, config.intermediate_size,
                  config.vocab_size, config.num_layers)
    pdt = config.param_dtype

    def dense(shape):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(0.02).to(pdt)

    def const(shape, value):
        return torch.full(shape, value, device=dev, dtype=pdt)

    def ln(shape):
        return {"scale": const(shape, 1.0), "bias": const(shape, 0.0)}

    embed_in = dense((v, e))
    wqkv, wo = dense((l, e, 3, e)), dense((l, e, e))
    wi, wo2 = dense((l, e, f)), dense((l, f, e))
    embed_out = dense((e, v))
    return {
        "embed_in": embed_in,
        "layers": {
            "ln1": ln((l, e)),
            "attn": {"wqkv": wqkv, "bqkv": const((l, 3, e), 0.0),
                     "wo": wo, "bo": const((l, e), 0.0)},
            "ln2": ln((l, e)),
            "mlp": {"wi": wi, "bi": const((l, f), 0.0),
                    "wo": wo2, "bo": const((l, e), 0.0)},
        },
        "lnf": ln((e,)),
        "embed_out": embed_out,
    }


def param_shapes(config: NeoXConfig) -> dict:
    """Every leaf's shape, from an init on the meta device."""
    from .gpt2 import _shapes

    return _shapes(init(config, 0, device="meta"))


def param_logical_axes(config: NeoXConfig) -> dict:
    """The JAX package's logical axes, leaf for leaf."""
    del config
    ln_l = {"scale": ("layers", "embed_vector"),
            "bias": ("layers", "embed_vector")}
    return {
        "embed_in": ("vocab", "embed"),
        "layers": {
            "ln1": ln_l,
            "attn": {
                "wqkv": ("layers", "embed", "qkv", "heads"),
                "bqkv": ("layers", "qkv", "heads_vector"),
                "wo": ("layers", "heads", "embed"),
                "bo": ("layers", "embed_vector"),
            },
            "ln2": ln_l,
            "mlp": {
                "wi": ("layers", "embed", "mlp"),
                "bi": ("layers", "mlp_vector"),
                "wo": ("layers", "mlp", "embed"),
                "bo": ("layers", "embed_vector"),
            },
        },
        "lnf": {"scale": ("embed_vector",), "bias": ("embed_vector",)},
        "embed_out": ("embed", "vocab"),
    }


# the param paths a sharding plan's ``LocalLayout`` reads: the token table,
# the untied head and the MLP's input projection
LAYOUT_PATHS = {"table": "embed_in", "head": "embed_out",
                "mlp_in": "layers/mlp/wi"}


ACT_FNS = {
    "gelu": F.gelu,                                        # HF "gelu" (erf)
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),  # HF gelu_new
}


def layer_rope(config: NeoXConfig, positions: torch.Tensor,
               seq_len: Optional[int] = None) -> tuple:
    """The partial rope's (cos, sin) tables, over ``rotary_ndims`` (any
    rope_scaling computed at that width, HF's partial_rotary_factor),
    once per forward (``seq_len``: the whole sequence's length where
    ``positions`` are one context-parallel shard)."""
    return rope_tables(config.rotary_ndims, positions, config.rope_theta,
                       config.rope_scaling, config.max_position_embeddings,
                       seq_len)


def rope_partial(x: torch.Tensor, rope: tuple, rotary_dim: int):
    """Rotate the first ``rotary_dim`` dims of each head, pass the rest."""
    if rotary_dim >= x.shape[-1]:
        return rotate(x, *rope)
    return torch.cat([rotate(x[..., :rotary_dim], *rope),
                      x[..., rotary_dim:]], dim=-1)


def _attn_branch(config, y, layer, positions, rope, attn_impl,
                 standard_layout=True, return_kv=False,
                 attend_override=None):
    """LayerNormed input -> fused QKV -> partial rope -> attention -> out
    projection (the block adds residual and row bias). ``return_kv`` also
    returns the rope'd k and v."""
    b, s, _ = y.shape
    q, k, v = fused_qkv(config, y, layer["attn"])
    q = rope_partial(q, rope, config.rotary_ndims)
    k = rope_partial(k, rope, config.rotary_ndims)
    attn = attend_or_override(q, k, v, positions, attn_impl,
                              standard_layout, attend_override)
    out = attn.reshape(b, s, -1) @ layer["attn"]["wo"].to(config.dtype)
    return (out, (k, v)) if return_kv else out


def _mlp_branch(config, y, layer):
    """LayerNormed input -> GELU MLP (no residual, no row bias)."""
    cdt = config.dtype
    h = y @ layer["mlp"]["wi"].to(cdt) + layer["mlp"]["bi"].to(cdt)
    # named for the "attn_mlp" remat policy (llama's mlp_act)
    with checkpoint_name("mlp_act"):
        h = ACT_FNS[config.act_fn](h)
    return h @ layer["mlp"]["wo"].to(cdt)


def _block(config, x, layer, positions, rope, attn_impl, standard_layout,
           layout=_WHOLE, attend_override=None, return_kv=False):
    """One parallel-residual block (sequential when the config says so),
    for training (``layout``: a plan's, the two partial sums of the
    parallel residual reduced once) and serving (``attend_override``,
    ``return_kv``). Returns (x, (k, v) or None)."""
    cdt = config.dtype
    eps = config.layer_norm_eps

    def attn_branch(h):
        return _attn_branch(config, layout.enter(h, "attn"), layer,
                            positions, rope, attn_impl, standard_layout,
                            return_kv, attend_override)

    if config.use_parallel_residual:
        out = attn_branch(layernorm(x, layer["ln1"], eps))
        attn, kv = out if return_kv else (out, None)
        mlp = _mlp_branch(config, layout.enter(
            layernorm(x, layer["ln2"], eps), "mlp"), layer)
        biases = layer["attn"]["bo"].to(cdt) + layer["mlp"]["bo"].to(cdt)
        if getattr(layout, "whole_parts", None):
            # a whole part's output is not a partial sum: each reduced
            # (or not) on its own
            summed = layout.leave(attn, "attn") + layout.leave(mlp, "mlp")
        else:
            summed = layout.leave(attn + mlp)
        return x + summed + biases, kv
    out = attn_branch(layernorm(x, layer["ln1"], eps))
    attn, kv = out if return_kv else (out, None)
    x = x + layout.leave(attn, "attn") + layer["attn"]["bo"].to(cdt)
    mlp = _mlp_branch(config, layout.enter(layernorm(x, layer["ln2"], eps),
                                           "mlp"), layer)
    return x + layout.leave(mlp, "mlp") + layer["mlp"]["bo"].to(cdt), kv


def embed_tokens(config: NeoXConfig, params: dict,
                 input_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding (rope happens inside the blocks)."""
    return params["embed_in"][input_ids.long()].to(config.dtype)


def tp_embed(config: NeoXConfig, params: dict, input_ids: torch.Tensor,
             layout) -> torch.Tensor:
    """The embedding as a plan's ``layout`` holds it: vocab parallelism
    over a sharded ``embed_in`` under tp, the residual's sequence shard
    under sequence parallelism."""
    return layout.embed_rows("embed_in", params["embed_in"],
                             input_ids).to(config.dtype)


def output_weights(config: NeoXConfig, params: dict) -> torch.Tensor:
    """[E, V] untied output projection in compute dtype."""
    return params["embed_out"].to(config.dtype)


def final_hidden(config: NeoXConfig, params: dict,
                 x: torch.Tensor) -> torch.Tensor:
    return layernorm(x, params["lnf"], config.layer_norm_eps)


def lm_head_logits(config: NeoXConfig, params: dict,
                   x: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm + untied head, fp32 logits."""
    return matmul_f32_out(final_hidden(config, params, x),
                          output_weights(config, params))


def embed_input(config: NeoXConfig, params: dict, input_ids: torch.Tensor,
                positions: torch.Tensor, layout=_WHOLE) -> torch.Tensor:
    """The residual stream's input (a pipeline's first stage)."""
    return tp_embed(config, params, input_ids, layout)


def run_blocks(config: NeoXConfig, layers: dict, x: torch.Tensor,
               positions: torch.Tensor, *, attn_impl="auto", layout=_WHOLE,
               remat: bool = False, remat_policy=None,
               standard_layout: bool = True, first_layer: int = 0,
               seq_len: Optional[int] = None,
               layer_schedule=None) -> torch.Tensor:
    """``_block`` over each layer of the stacked ``layers`` (a pipeline
    stage's slice, or every layer), the partial rope's tables computed
    once, under ``torch.utils.checkpoint`` with ``remat``, or run by
    ``layer_schedule`` (``ops/overlap.py``)."""
    rope = layer_rope(config, positions, seq_len)
    lay = (layout if layer_schedule is None
           else layer_schedule.layout_for(layout))

    def one(x, layer, window=None):
        return _block(config, x, lay.gather_layer(layer), positions, rope,
                      attn_impl, standard_layout, lay)[0]

    if layer_schedule is not None:
        return layer_schedule(one, x, layers)
    for layer in _unbind_layers(layers, _num_layers(layers)):
        x = (remat_layer(one, x, layer, policy=remat_policy) if remat
             else one(x, layer))
    return x


def final_layer(config: NeoXConfig, params: dict, x: torch.Tensor,
                layout=_WHOLE) -> torch.Tensor:
    """The final LayerNorm (a pipeline's last stage, before the head)."""
    lnf = {k: layout.gather_leaf(f"lnf/{k}", v)
           for k, v in params["lnf"].items()}
    return final_hidden(config, {"lnf": lnf}, x)


def logits_of_hidden(config: NeoXConfig, params: dict, hidden: torch.Tensor,
                     layout=_WHOLE) -> torch.Tensor:
    """fp32 logits of final-normed hidden states: the untied head, or the
    plan's (vocab-parallel under tp)."""
    if layout is _WHOLE:
        return matmul_f32_out(hidden, output_weights(config, params))
    return layout.logits(config, params, hidden)


def apply(config: NeoXConfig, params: dict, input_ids: torch.Tensor,
          positions: Optional[torch.Tensor] = None, *, remat: bool = False,
          remat_policy=None, attn_impl="auto",
          activation_sharding=None, return_hidden: bool = False,
          layer_schedule=None) -> torch.Tensor:
    """Training forward -> fp32 logits [B, S, V] (or the final-normed
    hidden states), the ``llama.apply`` contract."""
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
# Serving: the contiguous cache (prefill, decode_step) and the paged step;
# ``init_cache`` is llama's ([L, B, max_len, H, D])
# ---------------------------------------------------------------------------

def _serve_embed(config, params, input_ids, layout):
    if layout is None:
        return embed_tokens(config, params, input_ids)
    return tp_embed(config, params, input_ids, layout)


@torch.no_grad()
def prefill(config: NeoXConfig, params: dict, input_ids: torch.Tensor,
            cache: dict, last_pos: Optional[int] = None, layout=None):
    """Causal forward over the prompt through the einsum attention,
    writing each layer's rope'd k/v into ``cache[:, :, :prompt_len]`` in
    place. ``layout``: serving under a plan (``llama.prefill``'s). Returns
    (logits [B, V] at ``last_pos``, and the cache)."""
    lay = _WHOLE if layout is None else layout
    b, p = input_ids.shape
    positions = torch.arange(p, device=input_ids.device)[None, :].expand(b, -1)
    x = _serve_embed(config, params, input_ids, layout)
    rope = layer_rope(config, positions)
    for i in range(config.num_layers):
        x, (k, v) = _block(config, x, lay.gather_layer(layer_params(
            params, i)), positions, rope, "xla", False, layout=lay,
            return_kv=True)
        cache["k"][i, :, :p] = k.to(cache["k"].dtype)
        cache["v"][i, :, :p] = v.to(cache["v"].dtype)
    x_last = x[:, -1:] if last_pos is None else x[:, last_pos:last_pos + 1]
    head = serve_head(layout, lm_head_logits, final_layer)
    return head(config, params, x_last)[:, 0], cache


@torch.no_grad()
def decode_step(config: NeoXConfig, params: dict, token_ids: torch.Tensor,
                pos: int, cache: dict):
    """One contiguous-cache decode step at ``pos`` (the sampler's):
    returns (logits [B, V], the cache, updated in place)."""
    positions = step_positions(token_ids, pos)
    x = embed_tokens(config, params, token_ids)
    rope = layer_rope(config, positions)
    for i in range(config.num_layers):
        x, _ = _block(config, x, layer_params(params, i), positions, rope,
                      "xla", False, attend_override=cache_attend(
                          cache["k"][i], cache["v"][i], pos, positions))
    return lm_head_logits(config, params, x)[:, -1], cache


@torch.no_grad()
def paged_decode_step(config: NeoXConfig, params: dict,
                      token_ids: torch.Tensor, positions: torch.Tensor,
                      cache: dict, attend, last_index=None,
                      all_logits=False, layout=None):
    """One step over the paged multi-request cache, the
    ``llama.paged_decode_step`` contract, through the parallel-residual
    block. ``layout`` as in ``prefill``. Returns (logits [S, V], or
    [S, T, V] under ``all_logits``, and the cache)."""
    lay = _WHOLE if layout is None else layout
    pos2d = paged_positions(token_ids, positions)
    x = _serve_embed(config, params, token_ids, layout)
    rope = layer_rope(config, pos2d)
    for i in range(config.num_layers):
        kp, vp = _layer_pools(cache["k"], i), _layer_pools(cache["v"], i)

        def override(q, k, v, *, window, scale, softcap, kp=kp, vp=vp):
            return attend(q, k, v, kp, vp, window=window, scale=scale,
                          softcap=softcap)

        x, _ = _block(config, x, lay.gather_layer(layer_params(params, i)),
                      pos2d, rope, "xla", False, layout=lay,
                      attend_override=override)
    head = serve_head(layout, lm_head_logits, final_layer)
    return (paged_logits_at(head, config, params, x, last_index,
                            all_logits), cache)


# ---------------------------------------------------------------------------
# Presets: the JAX package's (Pythia suite and NeoX-20B model cards)
# ---------------------------------------------------------------------------

PRESETS = {
    "neox-debug": NeoXConfig(vocab_size=512, hidden_size=64,
                             intermediate_size=256, num_layers=2, num_heads=4,
                             max_position_embeddings=256),
    "pythia-70m": NeoXConfig(vocab_size=50304, hidden_size=512,
                             intermediate_size=2048, num_layers=6,
                             num_heads=8),
    "pythia-160m": NeoXConfig(vocab_size=50304, hidden_size=768,
                              intermediate_size=3072, num_layers=12,
                              num_heads=12),
    "pythia-410m": NeoXConfig(vocab_size=50304, hidden_size=1024,
                              intermediate_size=4096, num_layers=24,
                              num_heads=16),
    "pythia-1.4b": NeoXConfig(vocab_size=50304, hidden_size=2048,
                              intermediate_size=8192, num_layers=24,
                              num_heads=16),
    "pythia-6.9b": NeoXConfig(vocab_size=50432, hidden_size=4096,
                              intermediate_size=16384, num_layers=32,
                              num_heads=32),
    "gpt-neox-20b": NeoXConfig(vocab_size=50432, hidden_size=6144,
                               intermediate_size=24576, num_layers=44,
                               num_heads=64),
}
