"""Mixture-of-Experts Llama variant in PyTorch (chapter 10), on one device.

Counterpart of ``distributed_training_guide_tpu/models/moe.py``. Every
layer's FFN is a router plus E experts whose weights are stacked on an
expert axis ``[L, E, ...]``; routing is top-k over a softmax in fp32, with
the chosen weights renormalized under ``norm_topk_prob``. Params are the
JAX pytree's nested dict, leaf for leaf (``models/from_jax.py``).
Attention, norms, embedding and head are the dense Llama pieces of
``models/llama.py``, so the families cannot drift.

Two dispatch backends, selected by ``config.moe_dispatch``:

- ``"dense"``: index-based dispatch into static ``[E, C, D]`` capacity
  buffers, ``C = ceil(capacity_factor * k * tokens / E)``, and batched
  expert products; overflow pairs drop to the residual (Switch/GShard).
  It runs no kernel of the JAX package, so it stays plain PyTorch here.
- ``"ragged"``: dropless sorted dispatch (MegaBlocks, arXiv:2211.15841):
  sort the (token, choice) pairs by expert and run the three expert
  products as grouped GEMMs over the ``[kT, D]`` sorted buffer
  (``ops/grouped_matmul.py``: K5 forward, K5 and K6 backward, on the card).
  ``dropped_frac`` is identically 0. The serve paths (``no_drop``) always
  run it.

The dispatch reads nothing back to the host: group sizes are a
``scatter_add_`` into ``zeros(E)`` (``torch.bincount`` would read the
input's maximum to size its output), and every index is a tensor.
``gmm_impl`` picks the grouped-GEMM implementation ("auto": the kernels on
the card; "scan": the plain version, a reference). The Switch load-balance
loss is returned beside the logits; the Trainer adds
``router_aux_coef * aux`` to the loss.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP.md
item): the expert-parallel dispatch (``make_ragged_ep_dispatch``,
``moe_ep``, ``tp_axis``), the overlap ``layer_schedule`` and the
contiguous-cache ``decode_step``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..ops.grouped_matmul import grouped_matmul
from ..ops.remat import checkpoint_name, remat as remat_layer
from . import llama
from .llama import _rmsnorm, attention_sublayer

MOE_DISPATCH_MODES = ("dense", "ragged")
_EP_ITEM = "ROADMAP.md queue 1, 'Expert parallelism'"


@dataclasses.dataclass(frozen=True)
class MoELlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632      # per-expert FFN width
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    norm_topk_prob: bool = True        # renormalize the chosen top-k weights
    qk_norm: bool = False              # per-head q/k RMSNorm (Qwen3-MoE)
    attn_bias: bool = False            # QKV biases (Qwen2-MoE)
    # Qwen2-MoE shared expert: a dense gated MLP of this width on every
    # token, scaled by sigmoid(x @ shared_gate); None = no shared expert
    shared_expert_intermediate: Optional[int] = None
    moe_dispatch: str = "dense"        # "dense" | "ragged"
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: Optional[tuple] = None
    sliding_window: Optional[int] = None
    layer_windows: Optional[tuple] = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @property
    def head_size(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def _count(self, experts: int) -> int:
        e, f, v = self.hidden_size, self.intermediate_size, self.vocab_size
        d = self.head_size
        hq, hkv = self.num_heads * d, self.num_kv_heads * d
        attn = e * hq + 2 * e * hkv + hq * e
        if self.qk_norm:
            attn += 2 * d
        if self.attn_bias:
            attn += hq + 2 * hkv
        moe = e * self.num_experts + experts * 3 * e * f
        if self.shared_expert_intermediate:   # always active
            moe += 3 * e * self.shared_expert_intermediate + e
        per_layer = attn + moe + 2 * e
        head = 0 if self.tie_word_embeddings else e * v
        return v * e + self.num_layers * per_layer + e + head

    def num_params(self) -> int:
        return self._count(self.num_experts)

    def num_active_params(self) -> int:
        """Params a token flows through (k of E experts): the N of the
        FLOPs / MFU count."""
        return self._count(self.experts_per_token)


def init(config: MoELlamaConfig, rng, *, device=None) -> dict:
    """Random init, normal(0.02), from ``rng`` (a ``torch.Generator`` or an
    int seed for one on ``device``, default cuda), leaves in the JAX
    package's order. Stacked ``[L, ...]`` leaves are drawn one layer at a
    time in fp32 and cast into a ``param_dtype`` buffer, so the largest
    fp32 temporary is one layer's expert stack (805 MB for qwen3-30b-a3b)
    rather than all 48."""
    gen = llama._generator(rng, device)
    dev = gen.device
    e, f, v, l = (config.hidden_size, config.intermediate_size,
                  config.vocab_size, config.num_layers)
    ex = config.num_experts
    d = config.head_size
    hq, hkv = config.num_heads * d, config.num_kv_heads * d
    pdt = config.param_dtype

    def dense(shape):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(0.02).to(pdt)

    def stacked(shape):
        out = torch.empty((l, *shape), device=dev, dtype=pdt)
        for i in range(l):
            out[i] = dense(shape)
        return out

    def const(shape, value):
        return torch.full(shape, value, device=dev, dtype=pdt)

    embed = dense((v, e))
    attn = {"wq": stacked((e, hq)), "wk": stacked((e, hkv)),
            "wv": stacked((e, hkv)), "wo": stacked((hq, e))}
    if config.qk_norm:
        attn.update(q_norm=const((l, d), 1.0), k_norm=const((l, d), 1.0))
    if config.attn_bias:
        attn.update(bq=const((l, hq), 0.0), bk=const((l, hkv), 0.0),
                    bv=const((l, hkv), 0.0))
    moe = {"router": stacked((e, ex)), "gate": stacked((ex, e, f)),
           "up": stacked((ex, e, f)), "down": stacked((ex, f, e))}
    if config.shared_expert_intermediate:
        fs = config.shared_expert_intermediate
        moe.update(shared_gate_proj=stacked((e, fs)),
                   shared_up=stacked((e, fs)), shared_down=stacked((fs, e)),
                   shared_gate=stacked((e,)))
    params = {"embed": {"embedding": embed},
              "layers": {"attn": attn, "moe": moe,
                         "input_norm": const((l, e), 1.0),
                         "post_attn_norm": const((l, e), 1.0)},
              "final_norm": const((e,), 1.0)}
    if not config.tie_word_embeddings:
        params["lm_head"] = dense((e, v))
    return params


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _ragged_expert_compute(x_rows: torch.Tensor, gate, up, down,
                           group_sizes: torch.Tensor, cdt,
                           gmm_impl: str = "auto") -> torch.Tensor:
    """The three expert products as grouped GEMMs over a group-sorted row
    buffer (rows past ``sum(group_sizes)`` come back zero)."""
    def gmm(x, w):
        return grouped_matmul(x, w.to(cdt), group_sizes, impl=gmm_impl)

    g, u = F.silu(gmm(x_rows, gate)), gmm(x_rows, up)
    # named for the "attn_mlp" remat policy (the [kT, F] inner activation)
    with checkpoint_name("mlp_act"):
        h = g * u
    return gmm(h, down)


def _ragged_sort(xt: torch.Tensor, expert_flat, cdt):
    """Sort the choice-rank-major (token, choice) pairs by expert id.
    Returns (order, x_sorted [kT, D]); pair i is token i mod t, so the
    sorted rows gather straight from ``xt``."""
    order = torch.argsort(expert_flat, stable=True)
    return order, xt[order % xt.shape[0]].to(cdt)


def _ragged_combine(out_sorted: torch.Tensor, order, weight_flat, k: int,
                    t: int, cdt) -> torch.Tensor:
    """Unsort (an index inversion and a row gather), weight, and sum the k
    contributions of each token (adjacent in the choice-rank-major layout:
    a reshape and a dense sum, no scatter-add). -> [t, D]."""
    m, d = k * t, out_sorted.shape[1]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(m, device=order.device))
    y_choice = out_sorted[inv]
    return (y_choice * weight_flat[:, None].to(cdt)).reshape(k, t, d).sum(0)


def _ragged_dispatch(config: MoELlamaConfig, xt: torch.Tensor, expert_flat,
                     weight_flat, group_sizes, moe: dict, cdt,
                     gmm_impl: str = "auto") -> torch.Tensor:
    """Dropless sorted dispatch (single device): sort, grouped GEMMs over
    the sorted [kT, D] buffer, unsort, weight, combine. -> [t, D]."""
    k = config.experts_per_token
    order, x_sorted = _ragged_sort(xt, expert_flat, cdt)
    out_sorted = _ragged_expert_compute(x_sorted, moe["gate"], moe["up"],
                                        moe["down"], group_sizes, cdt,
                                        gmm_impl)
    return _ragged_combine(out_sorted, order, weight_flat, k, xt.shape[0],
                           cdt)


def _dense_dispatch(config: MoELlamaConfig, xt: torch.Tensor, expert_flat,
                    weight_flat, moe: dict, cdt):
    """Capacity-buffer dispatch: each pair's slot is its rank among the
    pairs of its expert (stable sort: greedy by choice rank, then token);
    pairs past the capacity drop. Rows move by gather only. Returns
    (y [t, D], dropped_frac)."""
    t, d = xt.shape
    ex, k = config.num_experts, config.experts_per_token
    m = k * t
    capacity = max(int(math.ceil(config.capacity_factor * k * t / ex)), 1)
    dev = xt.device
    order = torch.argsort(expert_flat, stable=True)
    sorted_e = expert_flat[order]
    group_start = torch.searchsorted(sorted_e, sorted_e)
    pos_flat = torch.empty_like(order).scatter_(
        0, order, torch.arange(m, device=dev) - group_start)
    keep = pos_flat < capacity
    dropped_frac = 1.0 - keep.float().mean()
    # overflow pairs target a sacrificial slot that is sliced off
    dest = torch.where(keep, expert_flat * capacity + pos_flat, ex * capacity)
    inv = torch.full((ex * capacity + 1,), m, dtype=torch.int64,
                     device=dev).scatter_(0, dest,
                                          torch.arange(m, device=dev))[:-1]
    expert_in = torch.where((inv < m)[:, None], xt[inv % t].to(cdt),
                            0).reshape(ex, capacity, d)
    g = F.silu(torch.bmm(expert_in, moe["gate"].to(cdt)))
    u = torch.bmm(expert_in, moe["up"].to(cdt))
    with checkpoint_name("mlp_act"):      # the [E, C, F] inner activation
        h = g * u
    expert_out = torch.bmm(h, moe["down"].to(cdt))
    y_choice = expert_out.reshape(ex * capacity, d)[
        dest.clamp(0, ex * capacity - 1)]
    y_choice = torch.where(keep[:, None], y_choice, 0)
    y = (y_choice * weight_flat[:, None].to(cdt)).reshape(k, t, d).sum(0)
    return y, dropped_frac


def _moe_ffn(config: MoELlamaConfig, x: torch.Tensor, moe: dict,
             tp_axis=None, no_drop: bool = False, moe_ep=None,
             gmm_impl: str = "auto"):
    """Top-k routed FFN. x: [B, S, D]. Returns (y, aux_loss,
    dropped_frac). ``no_drop`` (the serve paths) always runs ragged."""
    if tp_axis is not None or moe_ep is not None:
        raise NotImplementedError(f"tp_axis / moe_ep: {_EP_ITEM}")
    b, s, d = x.shape
    t = b * s
    ex, k = config.num_experts, config.experts_per_token
    dispatch = getattr(config, "moe_dispatch", "dense")
    if dispatch not in MOE_DISPATCH_MODES:
        raise ValueError(f"unknown moe_dispatch {dispatch!r}; choose from "
                         f"{MOE_DISPATCH_MODES}")
    if no_drop:
        dispatch = "ragged"
    cdt = config.dtype

    xt = x.reshape(t, d)
    router_logits = xt.float() @ moe["router"].float()          # [T, E]
    probs = torch.softmax(router_logits, dim=-1)
    topk_probs, topk_idx = torch.topk(probs, k, dim=-1)         # [T, k]
    if getattr(config, "norm_topk_prob", True):
        topk_probs = topk_probs / topk_probs.sum(-1, keepdim=True)
    # (token, choice) pairs choice-rank-major: pair i is token i mod t
    expert_flat = topk_idx.T.reshape(k * t)
    weight_flat = topk_probs.T.reshape(k * t)
    # the pairs per expert, with no host read
    counts = torch.zeros(ex, dtype=torch.int32, device=x.device).scatter_add_(
        0, expert_flat, torch.ones_like(expert_flat, dtype=torch.int32))

    if dispatch == "ragged":
        y = _ragged_dispatch(config, xt, expert_flat, weight_flat, counts,
                             moe, cdt, gmm_impl)
        dropped_frac = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        y, dropped_frac = _dense_dispatch(config, xt, expert_flat,
                                          weight_flat, moe, cdt)
    if "shared_gate" in moe:   # Qwen2-MoE shared expert, added to the combine
        xs = xt.to(cdt)
        hs = F.silu(xs @ moe["shared_gate_proj"].to(cdt))
        hs = hs * (xs @ moe["shared_up"].to(cdt))
        shared_out = hs @ moe["shared_down"].to(cdt)
        sgate = torch.sigmoid((xt.float() @ moe["shared_gate"].float())[:, None])
        y = y + sgate.to(cdt) * shared_out

    # Switch load-balance loss over all k choices: E * sum_e (choice
    # fraction)_e * (mean router prob)_e
    token_frac = counts.float() / (t * k)
    aux = ex * torch.sum(token_frac * probs.mean(0))
    return y.reshape(b, s, d), aux, dropped_frac


def _local_groups_compute(*args, **kwargs):
    raise NotImplementedError(f"_local_groups_compute: {_EP_ITEM}")


def make_ragged_ep_dispatch(*args, **kwargs):
    raise NotImplementedError(f"make_ragged_ep_dispatch: {_EP_ITEM}")


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _block(config: MoELlamaConfig, x, aux_acc, dropped_acc, layer: dict,
           positions, attn_impl, rope, standard_layout=True, window=None,
           gmm_impl: str = "auto"):
    attn = attention_sublayer(config, x, layer["attn"], layer["input_norm"],
                              positions, attn_impl, rope,
                              window_override=window,
                              standard_layout=standard_layout)
    x = x + attn
    h = _rmsnorm(x, layer["post_attn_norm"], config.rms_norm_eps)
    y, aux, dropped = _moe_ffn(config, h, layer["moe"], gmm_impl=gmm_impl)
    return x + y, aux_acc + aux, dropped_acc + dropped


def apply_with_aux(config: MoELlamaConfig, params: dict,
                   input_ids: torch.Tensor,
                   positions: Optional[torch.Tensor] = None, *,
                   remat: bool = False, remat_policy=None,
                   attn_impl: str = "auto", activation_sharding=None,
                   return_metrics: bool = False, return_hidden: bool = False,
                   moe_ep=None, layer_schedule=None, gmm_impl: str = "auto"):
    """Forward -> (fp32 logits [B, S, V], mean router aux loss
    [, {"moe_dropped_frac"}]). ``return_hidden`` swaps the logits for the
    final-normed hidden states [B, S, E] (the chunked loss, with
    ``output_weights``). ``remat=True`` wraps each layer in
    ``torch.utils.checkpoint`` under ``remat_policy`` (``ops/remat.py``)."""
    if moe_ep is not None:
        raise NotImplementedError(f"moe_ep: {_EP_ITEM}")
    if activation_sharding is not None:
        raise NotImplementedError(f"activation_sharding: {_EP_ITEM}")
    if layer_schedule is not None:
        raise NotImplementedError(
            "layer_schedule: ROADMAP.md queue 1, 'Context parallel, "
            "pipeline parallel and overlap'")
    standard_layout = positions is None
    if positions is None:
        positions = torch.arange(input_ids.shape[1],
                                 device=input_ids.device)[None, :]
    positions = positions.expand(input_ids.shape)
    x = embed_tokens(config, params, input_ids)
    wins = llama.layer_windows(config)
    rope = llama.layer_rope(config, positions)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux, dropped = zero, zero
    for i, layer in enumerate(llama._unbind_layers(params["layers"],
                                                   config.num_layers)):
        args = (config, x, aux, dropped, layer, positions, attn_impl, rope,
                standard_layout, None if wins is None else wins[i], gmm_impl)
        if remat:
            x, aux, dropped = remat_layer(_block, *args, policy=remat_policy)
        else:
            x, aux, dropped = _block(*args)
    out = (final_hidden(config, params, x) if return_hidden
           else lm_head_logits(config, params, x))
    aux = aux / config.num_layers
    if return_metrics:
        return out, aux, {"moe_dropped_frac": dropped / config.num_layers}
    return out, aux


def apply(config, params, input_ids, positions=None, **kw):
    logits, _ = apply_with_aux(config, params, input_ids, positions, **kw)
    return logits


# embedding and head are the dense family's (identical params layout)
embed_tokens = llama.embed_tokens
output_weights = llama.output_weights
final_hidden = llama.final_hidden
lm_head_logits = llama.lm_head_logits
init_cache = llama.init_cache


@torch.no_grad()
def prefill(config: MoELlamaConfig, params: dict, input_ids: torch.Tensor,
            cache: dict, last_pos: Optional[int] = None, *,
            gmm_impl: str = "auto"):
    """Causal forward over the prompt (the engine's bucketed prefill),
    writing each layer's rope'd k/v into ``cache[:, :, :prompt_len]`` in
    place; the routed FFN runs drop-free. Returns (logits [B, V] at
    ``last_pos``, default the final position, and the cache)."""
    b, p = input_ids.shape
    positions = torch.arange(p, device=input_ids.device)[None, :].expand(b, -1)
    x = embed_tokens(config, params, input_ids)
    wins = llama.layer_windows(config)
    rope = llama.layer_rope(config, positions)
    for i in range(config.num_layers):
        layer = llama.layer_params(params, i)
        attn, (k, v) = attention_sublayer(
            config, x, layer["attn"], layer["input_norm"], positions, "xla",
            rope, return_kv=True,
            window_override=None if wins is None else wins[i])
        x = x + attn
        h = _rmsnorm(x, layer["post_attn_norm"], config.rms_norm_eps)
        x = x + _moe_ffn(config, h, layer["moe"], no_drop=True,
                         gmm_impl=gmm_impl)[0]
        cache["k"][i, :, :p] = k.to(cache["k"].dtype)
        cache["v"][i, :, :p] = v.to(cache["v"].dtype)
    x_last = x[:, -1:] if last_pos is None else x[:, last_pos:last_pos + 1]
    return lm_head_logits(config, params, x_last)[:, 0], cache


def decode_step(*args, **kwargs):
    raise NotImplementedError(
        "moe.decode_step (the contiguous-cache sampler): ROADMAP.md queue "
        "1, 'Other dense families' (models/sample.py); the serving engine "
        "decodes through paged_decode_step")


@torch.no_grad()
def paged_decode_step(config: MoELlamaConfig, params: dict,
                      token_ids: torch.Tensor, positions: torch.Tensor,
                      cache: dict, attend, last_index=None, *,
                      gmm_impl: str = "auto"):
    """One step over a PAGED multi-request cache, the
    ``llama.paged_decode_step`` contract (decode steps at T = 1, prefill
    chunks at T > 1), with the routed FFN drop-free: per-token routing does
    not depend on the co-resident slots. Returns (logits [S, V], cache)."""
    pos2d = llama.paged_positions(token_ids, positions)
    x = embed_tokens(config, params, token_ids)
    wins = llama.layer_windows(config)
    rope = llama.layer_rope(config, pos2d)
    for i in range(config.num_layers):
        layer = llama.layer_params(params, i)
        kp = llama._layer_pools(cache["k"], i)
        vp = llama._layer_pools(cache["v"], i)

        def override(q, k, v, *, window, scale, softcap, kp=kp, vp=vp):
            return attend(q, k, v, kp, vp, window=window, scale=scale,
                          softcap=softcap)

        attn = attention_sublayer(
            config, x, layer["attn"], layer["input_norm"], pos2d, "xla",
            rope, window_override=None if wins is None else wins[i],
            attend_override=override)
        x = x + attn
        h = _rmsnorm(x, layer["post_attn_norm"], config.rms_norm_eps)
        x = x + _moe_ffn(config, h, layer["moe"], no_drop=True,
                         gmm_impl=gmm_impl)[0]
    return (llama.paged_logits_at(lm_head_logits, config, params, x,
                                  last_index), cache)


# ---------------------------------------------------------------------------
# Presets: the JAX package's shapes (public model cards).
# ---------------------------------------------------------------------------

PRESETS = {
    "moe-debug": MoELlamaConfig(vocab_size=512, hidden_size=64,
                                intermediate_size=128, num_layers=2,
                                num_heads=4, num_kv_heads=2, num_experts=4,
                                max_position_embeddings=256),
    "moe-1b-8e": MoELlamaConfig(vocab_size=32000, hidden_size=1024,
                                intermediate_size=2816, num_layers=12,
                                num_heads=16, num_kv_heads=4, num_experts=8,
                                experts_per_token=2,
                                max_position_embeddings=4096),
    "mixtral-8x7b": MoELlamaConfig(vocab_size=32000, hidden_size=4096,
                                   intermediate_size=14336, num_layers=32,
                                   num_heads=32, num_kv_heads=8,
                                   num_experts=8, experts_per_token=2,
                                   rope_theta=1e6,
                                   max_position_embeddings=32768),
    "qwen1.5-moe-a2.7b": MoELlamaConfig(vocab_size=151936, hidden_size=2048,
                                        intermediate_size=1408,
                                        num_layers=24, num_heads=16,
                                        num_kv_heads=16, num_experts=60,
                                        experts_per_token=4, attn_bias=True,
                                        norm_topk_prob=False,
                                        shared_expert_intermediate=5632,
                                        rope_theta=1e6, rms_norm_eps=1e-6,
                                        max_position_embeddings=8192),
    "qwen3-30b-a3b": MoELlamaConfig(vocab_size=151936, hidden_size=2048,
                                    intermediate_size=768, num_layers=48,
                                    num_heads=32, num_kv_heads=4,
                                    head_dim=128, num_experts=128,
                                    experts_per_token=8, qk_norm=True,
                                    norm_topk_prob=True, rope_theta=1e6,
                                    rms_norm_eps=1e-6,
                                    max_position_embeddings=40960),
}
