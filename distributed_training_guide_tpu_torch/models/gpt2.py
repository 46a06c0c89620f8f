"""GPT-2 decoder in PyTorch.

Counterpart of ``distributed_training_guide_tpu/models/gpt2.py``, the
guide's chapter-1 smoke model. Same params tree as the JAX pytree, leaf
for leaf (``models/from_jax.py``), layers stacked on a leading ``[L]``
axis and looped over in Python. The differences from the llama family:
learned position embeddings (``wpe``, read at embed time), LayerNorm with
bias, a fused QKV projection, the tanh GELU MLP with biases, and the head
tied to ``wte``.

The fused QKV is stored ``[L, E, 3, E]`` so its trailing axis is the
heads: tensor parallelism shards that axis alone and each rank holds the
q, k and v columns of its own heads. q, k and v are slices of the one
projection ``[B, S, 3, E]``; the flash kernels read them through their
strides, with no copy (``ops/flash_attention.py``: a stride of ``3E``
elements is on 16 bytes for every preset, so the Hopper bodies' tensor
maps read them in place). The paged kernel reads its q rows contiguous,
so the engine's attend copies q once (``serve/kv_pages.paged_attend``).

Positions past the learned table: ``apply`` refuses a sequence longer
than the table. The serving forwards clamp a position past the table to
its last row: only a pad row of a bucket or chunk reaches one (the engine
validates every real token against ``max_position_embeddings``), and a
pad row's k/v go to the trash page or are never committed, and its
logits are never read. jax's ``take`` would give the pad rows NaN, and a
CUDA gather past the table would fault.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import multihead_attention
from ..ops.remat import checkpoint_name, remat as remat_layer
from ..ops.matmul import matmul_f32_out
from .llama import (_WHOLE, _layer_pools, _num_layers, _unbind_layers,
                    serve_head,
                    cache_attend, model_positions,
                    init_cache, init_target, layer_params, paged_logits_at,
                    paged_positions, step_positions)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        return self.num_heads          # multi-head attention

    def num_params(self) -> int:
        e, v, p, l = (self.hidden_size, self.vocab_size,
                      self.max_position_embeddings, self.num_layers)
        per_layer = 3 * e * e + 3 * e + e * e + e + 8 * e * e + 5 * e + 4 * e
        return v * e + p * e + l * per_layer + 2 * e


def init(config: GPT2Config, rng, *, device=None) -> dict:
    """Random init, normal(0.02) weights, zero biases, unit LayerNorm
    scales, drawn in the JAX package's leaf order from ``rng`` (a
    ``torch.Generator`` or an int seed; ``device`` default cuda, "meta"
    for shapes only)."""
    gen, dev = init_target(rng, device)
    e, v, p, l = (config.hidden_size, config.vocab_size,
                  config.max_position_embeddings, config.num_layers)
    pdt = config.param_dtype

    def dense(shape):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(0.02).to(pdt)

    def const(shape, value):
        return torch.full(shape, value, device=dev, dtype=pdt)

    def ln(shape):
        return {"scale": const(shape, 1.0), "bias": const(shape, 0.0)}

    wte, wpe = dense((v, e)), dense((p, e))
    wqkv, wo = dense((l, e, 3, e)), dense((l, e, e))
    wi, wo2 = dense((l, e, 4 * e)), dense((l, 4 * e, e))
    return {
        "wte": wte,
        "wpe": wpe,
        "layers": {
            "ln1": ln((l, e)),
            "attn": {"wqkv": wqkv, "bqkv": const((l, 3, e), 0.0),
                     "wo": wo, "bo": const((l, e), 0.0)},
            "ln2": ln((l, e)),
            "mlp": {"wi": wi, "bi": const((l, 4 * e), 0.0),
                    "wo": wo2, "bo": const((l, e), 0.0)},
        },
        "lnf": ln((e,)),
    }


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def param_shapes(config: GPT2Config) -> dict:
    """Every leaf's shape, from an init on the meta device."""
    return _shapes(init(config, 0, device="meta"))


def param_logical_axes(config: GPT2Config) -> dict:
    """The JAX package's logical axes, leaf for leaf: the fused QKV's
    trailing "heads" axis is the one tensor parallelism shards; "pos"
    (the learned table's rows) maps to no mesh axis."""
    del config
    ln_l = {"scale": ("layers", "embed_vector"),
            "bias": ("layers", "embed_vector")}
    return {
        "wte": ("vocab", "embed"),
        "wpe": ("pos", "embed"),
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
    }


# the param paths a sharding plan's ``LocalLayout`` reads: the token table,
# the head (None: tied to the table) and the MLP's input projection
LAYOUT_PATHS = {"table": "wte", "head": None, "mlp_in": "layers/mlp/wi"}


def layernorm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """LayerNorm in fp32 (mean, then the mean square of the deviation),
    returned in ``x``'s dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(dtype)


def fused_qkv(config, y: torch.Tensor, attn: dict) -> tuple:
    """(q, k, v) [B, S, H_loc, D], strided slices of the one fused
    projection ``[B, S, 3, E_loc]`` (``E_loc`` the rank's heads under
    tensor parallelism)."""
    b, s, e = y.shape
    cdt = config.dtype
    wqkv = attn["wqkv"]                   # [E, 3, E_loc]
    e_loc = wqkv.shape[-1]
    h_loc = e_loc // config.head_size
    qkv = (y @ wqkv.reshape(e, 3 * e_loc).to(cdt)).reshape(b, s, 3, e_loc)
    qkv = qkv + attn["bqkv"].to(cdt)
    return tuple(qkv[:, :, i].reshape(b, s, h_loc, config.head_size)
                 for i in range(3))


def attend_or_override(q, k, v, positions, attn_impl, standard_layout,
                       attend_override):
    """The attention of a fused-QKV block: the override (the engine's
    paged attend, the sampler's cache attend) with no attention extras, or
    ``multihead_attention`` (the flash kernels where "auto" picks them)."""
    if attend_override is not None:
        return attend_override(q, k, v, window=None, scale=None,
                               softcap=None)[0]
    return multihead_attention(q, k, v, causal=True, positions=positions,
                               kv_positions=positions, impl=attn_impl,
                               standard_layout=standard_layout)


def _attn_sublayer(config, y, layer, positions, attn_impl,
                   standard_layout=True, return_kv=False,
                   attend_override=None):
    """LayerNormed input -> fused QKV -> attention -> out projection (the
    block adds the residual and the row bias). ``return_kv`` also returns
    (k, v); gpt2 has no rope, so they are the projections themselves."""
    b, s, _ = y.shape
    q, k, v = fused_qkv(config, y, layer["attn"])
    attn = attend_or_override(q, k, v, positions, attn_impl,
                              standard_layout, attend_override)
    out = attn.reshape(b, s, -1) @ layer["attn"]["wo"].to(config.dtype)
    return (out, (k, v)) if return_kv else out


def _mlp_sublayer(config, y, layer):
    """LayerNormed input -> tanh-GELU MLP (no residual, no row bias)."""
    cdt = config.dtype
    h = y @ layer["mlp"]["wi"].to(cdt) + layer["mlp"]["bi"].to(cdt)
    # named for the "attn_mlp" remat policy (llama's mlp_act)
    with checkpoint_name("mlp_act"):
        h = F.gelu(h, approximate="tanh")
    return h @ layer["mlp"]["wo"].to(cdt)


def _block(config, x, layer, positions, attn_impl, standard_layout,
           layout=_WHOLE, attend_override=None, return_kv=False):
    """One pre-LN block, for training (under a plan ``layout`` brings each
    sublayer's normed input to the full sequence and sums its row-parallel
    output; the replicated row biases are added after that sum) and for
    serving (``attend_override``, ``return_kv``). Returns (x, (k, v) or
    None)."""
    cdt = config.dtype
    eps = config.layer_norm_eps
    out = _attn_sublayer(config, layout.enter(layernorm(x, layer["ln1"], eps),
                                              "attn"),
                         layer, positions, attn_impl, standard_layout,
                         return_kv, attend_override)
    attn, kv = out if return_kv else (out, None)
    x = x + layout.leave(attn, "attn") + layer["attn"]["bo"].to(cdt)
    y = layout.enter(layernorm(x, layer["ln2"], eps), "mlp")
    mlp = layout.leave(_mlp_sublayer(config, y, layer), "mlp")
    return x + mlp + layer["mlp"]["bo"].to(cdt), kv


def _in_table(config, positions: torch.Tensor) -> torch.Tensor:
    """Serving positions clamped into the learned table (module
    docstring: only pad rows reach past it)."""
    return positions.clamp(max=config.max_position_embeddings - 1)


def embed_tokens(config: GPT2Config, params: dict, input_ids: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Token plus learned-position rows, summed in the param dtype and
    cast once to the compute dtype (as the JAX package sums them)."""
    tok = params["wte"][input_ids.long()]
    pos = params["wpe"][positions.long()]
    return (tok + pos).to(config.dtype)


def tp_embed(config: GPT2Config, params: dict, input_ids: torch.Tensor,
             positions: torch.Tensor, layout) -> torch.Tensor:
    """The embedding as a plan's ``layout`` holds it: the token rows from
    the (vocab-parallel under tp) ``wte`` plus the replicated position
    rows, each on the residual's sequence shard under sequence
    parallelism. Without a plan it is ``embed_tokens``."""
    tok = layout.embed_rows("wte", params["wte"], input_ids)
    wpe = layout.gather_leaf("wpe", params["wpe"])
    pos = layout.seq_local(wpe[positions.long()])
    return (tok + pos).to(config.dtype)


def output_weights(config: GPT2Config, params: dict) -> torch.Tensor:
    """[E, V] tied output projection in compute dtype."""
    return params["wte"].T.to(config.dtype)


def final_hidden(config: GPT2Config, params: dict,
                 x: torch.Tensor) -> torch.Tensor:
    return layernorm(x, params["lnf"], config.layer_norm_eps)


def lm_head_logits(config: GPT2Config, params: dict,
                   x: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm + tied head, fp32 logits from the fp32 accumulator
    of the compute-dtype product."""
    return matmul_f32_out(final_hidden(config, params, x),
                          output_weights(config, params))


def embed_input(config: GPT2Config, params: dict, input_ids: torch.Tensor,
                positions: torch.Tensor, layout=_WHOLE) -> torch.Tensor:
    """The residual stream's input (a pipeline's first stage)."""
    return tp_embed(config, params, input_ids, positions, layout)


def run_blocks(config: GPT2Config, layers: dict, x: torch.Tensor,
               positions: torch.Tensor, *, attn_impl="auto", layout=_WHOLE,
               remat: bool = False, remat_policy=None,
               standard_layout: bool = True, first_layer: int = 0,
               seq_len=None, layer_schedule=None) -> torch.Tensor:
    """``_block`` over each layer of the stacked ``layers`` (a pipeline
    stage's slice, or every layer), under ``torch.utils.checkpoint`` with
    ``remat``, or run by ``layer_schedule`` (``ops/overlap.py``)."""
    lay = (layout if layer_schedule is None
           else layer_schedule.layout_for(layout))

    def one(x, layer, window=None):
        return _block(config, x, lay.gather_layer(layer), positions,
                      attn_impl, standard_layout, lay)[0]

    if layer_schedule is not None:
        return layer_schedule(one, x, layers)
    for layer in _unbind_layers(layers, _num_layers(layers)):
        x = (remat_layer(one, x, layer, policy=remat_policy) if remat
             else one(x, layer))
    return x


def final_layer(config: GPT2Config, params: dict, x: torch.Tensor,
                layout=_WHOLE) -> torch.Tensor:
    """The final LayerNorm (a pipeline's last stage, before the head)."""
    lnf = {k: layout.gather_leaf(f"lnf/{k}", v)
           for k, v in params["lnf"].items()}
    return final_hidden(config, {"lnf": lnf}, x)


def logits_of_hidden(config: GPT2Config, params: dict, hidden: torch.Tensor,
                     layout=_WHOLE) -> torch.Tensor:
    """fp32 logits of final-normed hidden states: the tied head, or the
    plan's (vocab-parallel under tp)."""
    if layout is _WHOLE:
        return matmul_f32_out(hidden, output_weights(config, params))
    return layout.logits(config, params, hidden)


def apply(config: GPT2Config, params: dict, input_ids: torch.Tensor,
          positions: Optional[torch.Tensor] = None, *, remat: bool = False,
          remat_policy=None, attn_impl="auto",
          activation_sharding=None, return_hidden: bool = False,
          layer_schedule=None) -> torch.Tensor:
    """Training forward -> fp32 logits [B, S, V] (or the final-normed
    hidden states under ``return_hidden``), the ``llama.apply`` contract:
    remat policies (``ops/remat.py``), "auto" attention (the flash
    kernels on the card for the standard layout) or a context-parallel
    callable, and a plan's ``LocalLayout`` as ``activation_sharding``."""
    layout = _WHOLE if activation_sharding is None else activation_sharding
    positions, seq_len, standard_layout = model_positions(input_ids,
                                                          positions, layout)
    if standard_layout and (seq_len or input_ids.shape[1]) > \
            config.max_position_embeddings:
        raise ValueError(
            f"sequence of {seq_len or input_ids.shape[1]} tokens past the "
            f"learned position table ({config.max_position_embeddings} "
            f"rows)")
    x = embed_input(config, params, input_ids, positions, layout)
    x = run_blocks(config, params["layers"], x, positions,
                   attn_impl=attn_impl, layout=layout, remat=remat,
                   remat_policy=remat_policy,
                   standard_layout=standard_layout,
                   layer_schedule=layer_schedule)
    x = final_layer(config, params, x, layout)
    if return_hidden:
        return x
    return logits_of_hidden(config, params, x, layout)


# ---------------------------------------------------------------------------
# Serving: the contiguous cache (prefill, decode_step) and the paged step;
# ``init_cache`` is llama's ([L, B, max_len, H, D])
# ---------------------------------------------------------------------------

def _serve_embed(config, params, input_ids, positions, layout):
    positions = _in_table(config, positions)
    if layout is None:
        return embed_tokens(config, params, input_ids, positions)
    return tp_embed(config, params, input_ids, positions, layout)


@torch.no_grad()
def prefill(config: GPT2Config, params: dict, input_ids: torch.Tensor,
            cache: dict, last_pos: Optional[int] = None, layout=None):
    """Causal forward over the prompt through the einsum attention,
    writing each layer's k/v into ``cache[:, :, :prompt_len]`` in place.
    ``layout``: serving under a plan (``llama.prefill``'s). Returns
    (logits [B, V] at ``last_pos``, default the final position, and the
    cache)."""
    lay = _WHOLE if layout is None else layout
    b, p = input_ids.shape
    positions = torch.arange(p, device=input_ids.device)[None, :].expand(b, -1)
    x = _serve_embed(config, params, input_ids, positions, layout)
    for i in range(config.num_layers):
        x, (k, v) = _block(config, x, lay.gather_layer(layer_params(
            params, i)), positions, "xla", False, layout=lay, return_kv=True)
        cache["k"][i, :, :p] = k.to(cache["k"].dtype)
        cache["v"][i, :, :p] = v.to(cache["v"].dtype)
    x_last = x[:, -1:] if last_pos is None else x[:, last_pos:last_pos + 1]
    head = serve_head(layout, lm_head_logits, final_layer)
    return head(config, params, x_last)[:, 0], cache


@torch.no_grad()
def decode_step(config: GPT2Config, params: dict, token_ids: torch.Tensor,
                pos: int, cache: dict):
    """One contiguous-cache decode step at position ``pos`` (the
    sampler's): returns (logits [B, V], the cache, updated in place)."""
    positions = step_positions(token_ids, pos)
    x = embed_tokens(config, params, token_ids, positions)
    for i in range(config.num_layers):
        x, _ = _block(config, x, layer_params(params, i), positions, "xla",
                      False, attend_override=cache_attend(
                          cache["k"][i], cache["v"][i], pos, positions))
    return lm_head_logits(config, params, x)[:, -1], cache


@torch.no_grad()
def paged_decode_step(config: GPT2Config, params: dict,
                      token_ids: torch.Tensor, positions: torch.Tensor,
                      cache: dict, attend, last_index=None,
                      all_logits=False, layout=None):
    """One step over the paged multi-request cache, the
    ``llama.paged_decode_step`` contract: ``token_ids`` [S, T] from
    per-slot ``positions`` [S] (the learned rows read at embed time),
    ``attend`` scatters each layer's k/v into its pages and attends over
    the block tables (K4 on the card). ``layout`` as in ``prefill``.
    Returns (logits [S, V], or [S, T, V] under ``all_logits``, and the
    cache)."""
    lay = _WHOLE if layout is None else layout
    pos2d = paged_positions(token_ids, positions)
    x = _serve_embed(config, params, token_ids, pos2d, layout)
    for i in range(config.num_layers):
        kp, vp = _layer_pools(cache["k"], i), _layer_pools(cache["v"], i)

        def override(q, k, v, *, window, scale, softcap, kp=kp, vp=vp):
            return attend(q, k, v, kp, vp, window=window, scale=scale,
                          softcap=softcap)

        x, _ = _block(config, x, lay.gather_layer(layer_params(params, i)),
                      pos2d, "xla", False, layout=lay,
                      attend_override=override)
    head = serve_head(layout, lm_head_logits, final_layer)
    return (paged_logits_at(head, config, params, x, last_index,
                            all_logits), cache)


PRESETS = {
    "gpt2-debug": GPT2Config(vocab_size=512, hidden_size=64, num_layers=2,
                             num_heads=4, max_position_embeddings=256),
    "gpt2": GPT2Config(),
    "gpt2-medium": GPT2Config(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt2-large": GPT2Config(hidden_size=1280, num_layers=36, num_heads=20),
    "gpt2-xl": GPT2Config(hidden_size=1600, num_layers=48, num_heads=25),
}
