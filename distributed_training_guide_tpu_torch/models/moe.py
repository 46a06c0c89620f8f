"""Mixture-of-Experts Llama variant in PyTorch (chapter 10), on one device
or under any sharding plan.

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

Under a sharding plan (chapter 10: ``ep`` / ``ep_fsdp``; and every other
plan of the port) the forward runs on this rank's shards and rows through
the plan's ``LocalLayout``, as llama's does, and the collectives GSPMD
derives in the JAX package are written out over ``ops/collectives.py``'s
exchanges: ``make_ragged_ep_dispatch`` (the ragged bulk exchange: gather
the ep group's rows, each member's experts on their window of the sorted
buffer, reduce-scatter home) and ``dense_ep_dispatch`` (the capacity
dispatch of the global program: the slot map over every rank's routing).
Under the overlap schedule (``ops/overlap.py``) ``apply_with_aux`` takes
``layer_schedule`` over its ``(x, aux, dropped)`` carry, and
``make_ragged_ep_dispatch(overlap=True)`` is the double-buffered ring:
token blocks hop around the ep group while each member's experts compute
the block at hand.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..ops import collectives as C
from ..ops.grouped_matmul import grouped_matmul
from ..ops.remat import checkpoint_name, remat as remat_layer
from . import llama
from .llama import _rmsnorm, attention_sublayer

MOE_DISPATCH_MODES = ("dense", "ragged")


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
    gen, dev = llama.init_target(rng, device)
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
# layout of the params under a sharding plan
# ---------------------------------------------------------------------------

def param_logical_axes(config: MoELlamaConfig) -> dict:
    """The logical axes of every leaf (the JAX package's table): the
    routed experts' stacks carry ``experts``, which the ``ep*`` rules put
    on ep; their ``mlp`` dim, and the shared expert's, shard on tp; the
    router and the shared expert's scalar gate are never sharded."""
    attn = {"wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv"),
            "wv": ("layers", "embed", "kv"),
            "wo": ("layers", "heads", "embed")}
    if config.qk_norm:
        attn.update(q_norm=("layers", "head_dim_vector"),
                    k_norm=("layers", "head_dim_vector"))
    if config.attn_bias:
        attn.update(bq=("layers", "heads"), bk=("layers", "kv"),
                    bv=("layers", "kv"))
    moe = {"router": ("layers", "embed", "experts_vector"),
           "gate": ("layers", "experts", "embed", "mlp"),
           "up": ("layers", "experts", "embed", "mlp"),
           "down": ("layers", "experts", "mlp", "embed")}
    if config.shared_expert_intermediate:
        moe.update(shared_gate_proj=("layers", "embed", "mlp"),
                   shared_up=("layers", "embed", "mlp"),
                   shared_down=("layers", "mlp", "embed"),
                   shared_gate=("layers", "embed_vector"))
    axes = {"embed": {"embedding": ("vocab", "embed")},
            "layers": {"attn": attn, "moe": moe,
                       "input_norm": ("layers", "embed_vector"),
                       "post_attn_norm": ("layers", "embed_vector")},
            "final_norm": ("embed_vector",)}
    if not config.tie_word_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def param_shapes(config: MoELlamaConfig) -> dict:
    """Every leaf's shape, as ``init`` makes it (on the meta device)."""
    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)
    return shapes(init(config, 0, device="meta"))


# the param paths a plan's ``LocalLayout`` reads (llama's, with the routed
# experts' gate as the MLP input projection)
LAYOUT_PATHS = {**llama.LAYOUT_PATHS, "mlp_in": "layers/moe/gate"}
# the routed experts' stacks, whose ``experts`` axis the ep rules shard
EXPERT_LEAVES = ("gate", "up", "down")
# layer weights the block reads in fp32 (the router's logits and the shared
# expert's gate): the overlap schedule hands them over uncast
FP32_LAYER_LEAVES = frozenset({"moe/router", "moe/shared_gate"})


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


def _group_sizes(expert_flat: torch.Tensor, ex: int) -> torch.Tensor:
    """The pairs per expert, int32 [E], with no host read."""
    return torch.zeros(ex, dtype=torch.int32,
                       device=expert_flat.device).scatter_add_(
        0, expert_flat, torch.ones_like(expert_flat, dtype=torch.int32))


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


def _local_groups_compute(x_sorted: torch.Tensor, sizes: torch.Tensor,
                          gate, up, down, e0: int, e_local: int, cdt,
                          gmm_impl: str = "auto") -> torch.Tensor:
    """Grouped-GEMM the ``e_local`` experts from expert ``e0`` over their
    contiguous run of a group-sorted row buffer; rows outside those
    groups come back zero. The run starts at the sum of the earlier
    groups' sizes, a device scalar: the worst-case-static ``[m, D]``
    window is an index gather (``arange(m) + start``) from a zero-padded
    copy, so nothing is read back to the host. Past the local groups the
    window holds other experts' rows, which K5's contract (rows at or past
    ``sum(group_sizes)`` come out 0) and K6's (they add nothing) ignore."""
    m = x_sorted.shape[0]
    start = sizes[:e0].sum()
    rows = torch.arange(m, device=x_sorted.device)
    x_pad = torch.cat([x_sorted, torch.zeros_like(x_sorted)])
    out_local = _ragged_expert_compute(x_pad[rows + start], gate, up, down,
                                       sizes[e0:e0 + e_local], cdt, gmm_impl)
    back = rows - start
    return torch.where((back >= 0)[:, None], out_local[back.clamp(min=0)],
                       0)


def make_ragged_ep_dispatch(ep, config: MoELlamaConfig, *, embed=None,
                            overlap: bool = False, gmm_impl: str = "auto"):
    """The dropless dispatch with the experts spread over the members of
    ``ep`` (a ``MemberExchange``; None: every member owns every expert),
    the JAX package's ``make_ragged_ep_dispatch`` in its bulk form: each
    member all-gathers the rows, ``topk_idx`` and ``topk_probs`` of its ep
    group, sorts the pairs once, runs its ``E / ep`` experts on their
    window of the sorted buffer (``_local_groups_compute``: about 1/ep of
    the rows live) and reduce-scatters the partial combine back to each
    token's home member. The float rows and probs carry grads through the
    gather / reduce-scatter pair; the int routing is gathered without.

    ``embed``: an exchange over the axis that shards the experts' embed
    dim (fsdp under ``ep_fsdp``), all-gathered before compute; its
    backward reduce-scatters the weight grads. With ep == 1 the body does
    no collective but that gather; where neither is wider than one member
    this returns None (the local dispatch is the program).

    Returns ``dispatch(xts, topk_idxs, topk_probs, gates, ups, downs)``
    over one item per local member (rows [t, D], routing [t, k], the
    member's expert stacks [E / ep, ...]) -> the combined outputs [t, D]
    per member. The local members are the grid of ``embed``'s local
    members by ``ep``'s, ``embed``'s major: with one member of each per
    process (a plan's ranks) one item; over a ``LocalExchange`` of each
    (ep x fsdp virtual members on one device) item ``f * len(ep.local) +
    e`` is member e of ep group f, whose weights are the (e, f) block.

    ``overlap=True`` (the overlap schedule, ``ops/overlap.py``) is the
    double-buffered ring in place of the bulk gather: each member's block
    of rows and routing hops one member along the ring a step
    (``ops/collectives.py:post_permute`` over ``ep.permute``, posted
    before the step's compute and waited after it), each visiting block
    runs through ``_local_groups_compute`` on this member's experts, and
    each partial goes straight back to its owner (posted at once, waited
    after the last step). The owner sums the ep partials in member order,
    the order ``ep.reduce_scatter`` sums them in on one device. Per row
    the products are the bulk form's; each hop sorts ``t`` rows, not
    ``ep * t``, and an expert's weight gradient is summed over the hops.
    The gradients of the rows and probs travel the inverse permutations in
    the backward."""
    ex, k = config.num_experts, config.experts_per_token
    n_ep = 1 if ep is None else ep.size
    if n_ep > 1 and ex % n_ep:
        raise ValueError(
            f"moe_dispatch='ragged' under expert parallelism needs "
            f"num_experts divisible by the ep axis; got E={ex}, ep={n_ep} — "
            f"change the mesh or use moe_dispatch='dense'")
    if embed is not None and embed.size <= 1:
        embed = None
    if n_ep == 1 and embed is None:
        return None
    e_local, cdt = ex // n_ep, config.dtype

    def member(xt, idx, probs, gate, up, down, e0):
        t = xt.shape[0]
        expert_flat = idx.T.reshape(k * t)
        order, x_sorted = _ragged_sort(xt, expert_flat, cdt)
        sizes = _group_sizes(expert_flat, ex)
        if n_ep == 1:           # every expert here: the whole buffer
            out = _ragged_expert_compute(x_sorted, gate, up, down, sizes,
                                         cdt, gmm_impl)
        else:
            out = _local_groups_compute(x_sorted, sizes, gate, up, down, e0,
                                        e_local, cdt, gmm_impl)
        return _ragged_combine(out, order, probs.T.reshape(k * t), k, t,
                               cdt)

    n_emb = 1 if embed is None else len(embed.local)
    n_loc = 1 if ep is None else len(ep.local)

    def gathered(ws, dim):
        """Each member's expert stack with its embed dim gathered over
        ``embed``: for each ep member e, the stacks of (e, f) over f."""
        out = list(ws)
        for e in range(n_loc):
            whole = embed.all_gather([ws[f * n_loc + e]
                                      for f in range(n_emb)], dim)
            for f in range(n_emb):
                out[f * n_loc + e] = whole[f]
        return out

    def dispatch(xts, topk_idxs, topk_probs, gates, ups, downs):
        if embed is not None:
            gates, ups = gathered(gates, 1), gathered(ups, 1)
            downs = gathered(downs, 2)
        ys = []
        for f in range(n_emb):      # each ep group of local members
            blk = slice(f * n_loc, (f + 1) * n_loc)
            ys += exchange(xts[blk], topk_idxs[blk], topk_probs[blk],
                           gates[blk], ups[blk], downs[blk])
        return ys

    def exchange(xts, topk_idxs, topk_probs, gates, ups, downs):
        if n_ep == 1:
            return [member(*a, 0) for a in zip(xts, topk_idxs, topk_probs,
                                                gates, ups, downs)]
        if overlap:
            return ring(xts, topk_idxs, topk_probs, gates, ups, downs)
        rows = zip(ep.all_gather(xts, 0), ep.all_gather(topk_idxs, 0),
                   ep.all_gather(topk_probs, 0), gates, ups, downs, ep.local)
        ys = [member(*a[:6], a[6] * e_local) for a in rows]
        return ep.reduce_scatter(ys, 0)

    def ring(xts, topk_idxs, topk_probs, gates, ups, downs):
        step = [(i, (i + 1) % n_ep) for i in range(n_ep)]
        blocks = [list(b) for b in zip(xts, topk_idxs, topk_probs)]
        parts = [{} for _ in ep.local]   # each owner's partials by member
        back = []
        for j in range(n_ep):
            nxt = (C.post_permute(ep, blocks, step) if j + 1 < n_ep
                   else None)
            ys = [member(*blk, g, u, d, m * e_local) for blk, g, u, d, m
                  in zip(blocks, gates, ups, downs, ep.local)]
            if j == 0:
                for got, m, y in zip(parts, ep.local, ys):
                    got[m] = y
            else:   # home to the block's owner, member m - j
                back.append((j, C.post_permute(
                    ep, [[y] for y in ys],
                    [(i, (i - j) % n_ep) for i in range(n_ep)])))
            if nxt is not None:
                blocks = nxt.wait()
        for j, hop in back:
            for got, m, (y,) in zip(parts, ep.local, hop.wait()):
                got[(m + j) % n_ep] = y
        out = []
        for got in parts:
            total = got[0]
            for q in range(1, n_ep):
                total = total + got[q]
            out.append(total)
        return out

    dispatch.ep, dispatch.embed, dispatch.overlap = ep, embed, overlap
    return dispatch


def _slots(expert_flat: torch.Tensor) -> torch.Tensor:
    """Each pair's rank among the pairs of its expert, in pair order (the
    stable sort keeps the choice-rank-major priority within a group)."""
    m = expert_flat.shape[0]
    order = torch.argsort(expert_flat, stable=True)
    sorted_e = expert_flat[order]
    group_start = torch.searchsorted(sorted_e, sorted_e)
    return torch.empty_like(order).scatter_(
        0, order, torch.arange(m, device=order.device) - group_start)


def _capacity_compute(xt, e_rel, pos, mine, weight_flat, w: dict,
                      n_exp: int, capacity: int, k: int, cdt):
    """The pairs ``mine`` (expert ``e_rel`` of this member's ``n_exp``,
    slot ``pos``) through ``[n_exp, C, D]`` capacity buffers, weighted and
    combined per token -> [t, D] (zero where no pair of a token is
    ``mine``). Rows move by gather only: the one scatter inverts the int
    slot map."""
    t, d = xt.shape
    m, dev = k * t, xt.device
    # other pairs target a sacrificial slot that is sliced off
    dest = torch.where(mine, e_rel * capacity + pos, n_exp * capacity)
    inv = torch.full((n_exp * capacity + 1,), m, dtype=torch.int64,
                     device=dev).scatter_(0, dest,
                                          torch.arange(m, device=dev))[:-1]
    expert_in = torch.where((inv < m)[:, None], xt[inv % t].to(cdt),
                            0).reshape(n_exp, capacity, d)
    g = F.silu(torch.bmm(expert_in, w["gate"].to(cdt)))
    u = torch.bmm(expert_in, w["up"].to(cdt))
    with checkpoint_name("mlp_act"):      # the [E, C, F] inner activation
        h = g * u
    expert_out = torch.bmm(h, w["down"].to(cdt))
    y_choice = expert_out.reshape(n_exp * capacity, d)[
        dest.clamp(0, n_exp * capacity - 1)]
    y_choice = torch.where(mine[:, None], y_choice, 0)
    return (y_choice * weight_flat[:, None].to(cdt)).reshape(k, t, d).sum(0)


def dense_ep_dispatch(config: MoELlamaConfig, xts: list, topk_idxs: list,
                      topk_probs: list, weights: list, *, route=None,
                      ep=None, token_index: Optional[list] = None) -> tuple:
    """The capacity dispatch of tokens spread over members, computing what
    the single device computes on all of them (the JAX package's dense
    path is one GSPMD program): the capacity is ``C = ceil(cf k T / E)``
    over the global token count T, and the slots go by priority in the
    global choice-rank-major order, so which pairs drop depends on every
    member's tokens.

    ``route`` (a ``MemberExchange``; None: these are all the tokens)
    gathers the int routing of every member that holds other tokens (the
    data axes and cp), and each token's global index (``token_index``, one
    [t] tensor per local member; default the members' tokens in member
    order); every member builds the global slot map from them. ``ep``
    (within ``route``; None: each member runs every expert on its own
    tokens) gathers the rows and weights of the expert-parallel group;
    each member fills and computes only its ``[E / ep, C, D]`` buffers,
    and the partial combine is reduce-scattered home. ``weights``: per
    local member {"gate", "up", "down"}, its experts' stacks.

    Returns (the outputs [t, D] per local member, the global fraction of
    dropped pairs)."""
    ex, k = config.num_experts, config.experts_per_token
    n_ep = 1 if ep is None else ep.size
    if ex % n_ep:
        raise ValueError(f"num_experts {ex} not divisible by ep {n_ep}")
    e_local, cdt = ex // n_ep, config.dtype
    if token_index is None:
        members = (0,) if route is None else route.local
        token_index = [torch.arange(x.shape[0], device=x.device)
                       + m * x.shape[0] for m, x in zip(members, xts)]
    idx_all, tok_all = topk_idxs, token_index
    if route is not None:
        idx_all = route.all_gather(topk_idxs, 0)
        tok_all = route.all_gather(token_index, 0)
    xs, ps, toks, owners = xts, topk_probs, token_index, (0,) * len(xts)
    if ep is not None:
        xs, ps, toks = (ep.all_gather(v, 0)
                        for v in (xts, topk_probs, token_index))
        owners = ep.local
    ys, dropped = [], None
    for x, p, tok, w, owner, idx, tg in zip(xs, ps, toks, weights, owners,
                                           idx_all, tok_all):
        n_tok, t = idx.shape[0], x.shape[0]
        capacity = max(int(math.ceil(config.capacity_factor * k * n_tok
                                     / ex)), 1)
        table = torch.empty((k, n_tok), dtype=idx.dtype, device=x.device)
        table[:, tg] = idx.T                  # global choice-rank-major
        expert_g = table.reshape(k * n_tok)
        pos_g = _slots(expert_g)
        keep_g = pos_g < capacity
        dropped = 1.0 - keep_g.float().mean()
        pair = (torch.arange(k, device=x.device)[:, None] * n_tok
                + tok[None, :]).reshape(k * t)
        e_rel = expert_g[pair] - owner * e_local
        mine = keep_g[pair] & (e_rel >= 0) & (e_rel < e_local)
        ys.append(_capacity_compute(x, e_rel, pos_g[pair], mine,
                                    p.T.reshape(k * t), w, e_local,
                                    capacity, k, cdt))
    if ep is not None:
        ys = ep.reduce_scatter(ys, 0)
    return ys, dropped


@dataclasses.dataclass
class TokenSplit:
    """How the tokens of one routed FFN call lie over the ranks of a plan
    (``parallel/plans.py:LocalLayout.token_split``): ``route`` gathers from
    every rank that holds other tokens (the data axes and cp: an
    ``ops/collectives.AxesExchange``), ``ep`` is the expert-parallel
    group's exchange (None at ep 1), ``token_index`` [t] the global index
    of each local token (b-major, the single device's order),
    and ``replicas`` the tp ranks that route the same tokens (the aux
    loss's gradient is shared among them)."""
    route: Any
    ep: Any
    token_index: torch.Tensor
    replicas: int = 1

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``route``; the backward is the
        identity (each rank differentiates the one global value for its
        own tokens)."""
        for g in (() if self.route is None else self.route.groups):
            x = C.all_reduce(x, g)
        return x


class _ShareGrad(torch.autograd.Function):
    """Identity whose backward scales by ``share``: a value every one of
    ``1 / share`` ranks computes from the same tokens, whose grads are
    then summed over those ranks."""

    @staticmethod
    def forward(ctx, x, share):
        ctx.share = share
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.share, None


def _moe_ffn(config: MoELlamaConfig, x: torch.Tensor, moe: dict,
             no_drop: bool = False, moe_ep=None, gmm_impl: str = "auto",
             split: Optional[TokenSplit] = None):
    """Top-k routed FFN. x: [B, S, D]. Returns (y, aux_loss,
    dropped_frac). ``no_drop`` (the serve paths) always runs ragged.

    Under a plan (``split``: how the tokens lie over the ranks) the dense
    dispatch computes the global program (``dense_ep_dispatch``), the
    ragged one runs ``moe_ep`` (``make_ragged_ep_dispatch``, threaded in
    by the Trainer) where the plan has one, and the load-balance loss
    ``E * sum_e token_frac_e * prob_frac_e`` is a product of global means
    (both summed over the ranks of ``split.route`` first). Under tp the
    experts' and the shared expert's mlp dims are sharded and ``y`` is a
    partial sum: the caller's ``layout.leave`` sums it once, routed and
    shared outputs together (the JAX package's ``tp_axis``); where tp
    divides neither width, the layout hands the weights whole and ``y``
    is the whole output ("moe" among ``LocalLayout.whole_parts``)."""
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
    counts = _group_sizes(expert_flat, ex)
    ep = None if split is None else split.ep

    if dispatch == "ragged":
        if moe_ep is not None:
            y = moe_ep([xt], [topk_idx], [topk_probs], [moe["gate"]],
                       [moe["up"]], [moe["down"]])[0]
        elif ep is not None:
            raise ValueError("moe_dispatch='ragged' under expert "
                             "parallelism needs moe_ep "
                             "(make_ragged_ep_dispatch over the ep group)")
        else:
            y = _ragged_dispatch(config, xt, expert_flat, weight_flat,
                                 counts, moe, cdt, gmm_impl)
        dropped_frac = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        ys, dropped_frac = dense_ep_dispatch(
            config, [xt], [topk_idx], [topk_probs], [moe],
            route=None if split is None else split.route, ep=ep,
            token_index=None if split is None else [split.token_index])
        y = ys[0]
    if "shared_gate" in moe:   # Qwen2-MoE shared expert, added to the combine
        xs = xt.to(cdt)
        hs = F.silu(xs @ moe["shared_gate_proj"].to(cdt))
        hs = hs * (xs @ moe["shared_up"].to(cdt))
        shared_out = hs @ moe["shared_down"].to(cdt)
        sgate = torch.sigmoid((xt.float() @ moe["shared_gate"].float())[:, None])
        y = y + sgate.to(cdt) * shared_out

    # Switch load-balance loss over all k choices: E * sum_e (choice
    # fraction)_e * (mean router prob)_e, both over every token
    counts, prob_sum, n_tok = counts.float(), probs.sum(0), t
    if split is not None:
        counts, prob_sum = split.reduce(counts), split.reduce(prob_sum)
        n_tok = t * (1 if split.route is None else split.route.size)
    aux = ex * torch.sum((counts / (n_tok * k)) * (prob_sum / n_tok))
    if split is not None and split.replicas > 1:
        aux = _ShareGrad.apply(aux, 1.0 / split.replicas)
    return y.reshape(b, s, d), aux, dropped_frac


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def block(config: MoELlamaConfig, x: torch.Tensor, layer: dict, *,
          positions: torch.Tensor, rope: tuple, attn_impl, window=None,
          standard_layout: bool = True, layout=llama._WHOLE, kv_hook=None,
          moe_ep=None, gmm_impl: str = "auto") -> tuple:
    """One decoder layer -> (x, aux, dropped_frac): ``layout`` gathers the
    layer's fsdp shards (the experts keep their ep shards), brings each
    sublayer's normed input to the full sequence and sums its
    row-parallel output back, and says how the tokens lie over the ranks
    (``layout.token_split``)."""
    eps = config.rms_norm_eps
    layer = layout.gather_layer(layer)
    attn = layout.leave(attention_sublayer(
        config, layout.enter(_rmsnorm(x, layer["input_norm"], eps), "attn"),
        layer["attn"], None, positions, attn_impl, rope,
        window_override=window, standard_layout=standard_layout,
        kv_hook=kv_hook), "attn")
    x = x + attn
    h = layout.enter(_rmsnorm(x, layer["post_attn_norm"], eps), "moe")
    y, aux, dropped = _moe_ffn(config, h, layer["moe"], moe_ep=moe_ep,
                               gmm_impl=gmm_impl,
                               split=layout.token_split(h))
    return x + layout.leave(y, "moe"), aux, dropped


def run_blocks(config: MoELlamaConfig, layers: dict, x: torch.Tensor,
               positions: torch.Tensor, *, attn_impl="auto",
               layout=llama._WHOLE, remat: bool = False, remat_policy=None,
               standard_layout: bool = True, first_layer: int = 0,
               seq_len: Optional[int] = None, moe_ep=None,
               gmm_impl: str = "auto", layer_schedule=None) -> tuple:
    """The layers of the stacked ``layers`` in order (a pipeline stage's
    slice from global layer ``first_layer``, or all of them) -> (x, the
    sum of their aux losses, the sum of their dropped fractions); each
    layer under ``torch.utils.checkpoint`` with ``remat``, or run by
    ``layer_schedule`` (``ops/overlap.py``) over the ``(x, aux,
    dropped)`` carry."""
    wins = llama.layer_windows(config)
    rope = llama.layer_rope(config, positions, seq_len)
    kv_hook = layout.kv_hook(config)
    lay = (layout if layer_schedule is None
           else layer_schedule.layout_for(layout))

    def one(x, layer, window):
        return block(config, x, layer, positions=positions, rope=rope,
                     attn_impl=attn_impl, window=window,
                     standard_layout=standard_layout, layout=lay,
                     kv_hook=kv_hook, moe_ep=moe_ep, gmm_impl=gmm_impl)

    aux = dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    if layer_schedule is not None:
        def carried(carry, layer, window):
            x, a, dr = carry
            x, a2, dr2 = one(x, layer, window)
            return x, a + a2, dr + dr2

        n = llama._num_layers(layers)
        return layer_schedule(carried, (x, aux, dropped), layers,
                              None if wins is None
                              else wins[first_layer:first_layer + n])
    for i, layer in enumerate(llama._unbind_layers(
            layers, llama._num_layers(layers))):
        window = None if wins is None else wins[first_layer + i]
        if remat:
            x, a, dr = remat_layer(one, x, layer, window, policy=remat_policy)
        else:
            x, a, dr = one(x, layer, window)
        aux, dropped = aux + a, dropped + dr
    return x, aux, dropped


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
    ``torch.utils.checkpoint`` under ``remat_policy`` (``ops/remat.py``).
    ``activation_sharding``: a plan's ``LocalLayout``, as
    ``models/llama.apply`` takes it (this rank's shards and rows);
    ``moe_ep``: the expert-parallel ragged dispatch
    (``make_ragged_ep_dispatch``), threaded to every layer;
    ``layer_schedule`` (``ops/overlap.py``) runs the layers over the
    ``(x, aux, dropped)`` carry with its own remat per layer."""
    layout = (llama._WHOLE if activation_sharding is None
              else activation_sharding)
    positions, seq_len, standard_layout = llama.model_positions(
        input_ids, positions, layout)
    x = embed_input(config, params, input_ids, positions, layout)
    x, aux, dropped = run_blocks(
        config, params["layers"], x, positions, attn_impl=attn_impl,
        layout=layout, remat=remat, remat_policy=remat_policy,
        standard_layout=standard_layout, seq_len=seq_len, moe_ep=moe_ep,
        gmm_impl=gmm_impl, layer_schedule=layer_schedule)
    x = final_layer(config, params, x, layout)
    out = x if return_hidden else logits_of_hidden(config, params, x, layout)
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
embed_input = llama.embed_input
final_layer = llama.final_layer
logits_of_hidden = llama.logits_of_hidden


@torch.no_grad()
def prefill(config: MoELlamaConfig, params: dict, input_ids: torch.Tensor,
            cache: dict, last_pos: Optional[int] = None, *,
            gmm_impl: str = "auto", layout=None):
    """Causal forward over the prompt (the engine's bucketed prefill),
    writing each layer's rope'd k/v into ``cache[:, :, :prompt_len]`` in
    place; the routed FFN runs drop-free. ``layout``: serving under a plan
    (``llama.prefill``'s; the experts' columns are this rank's under tp,
    their partial outputs summed with the shared expert's). Returns
    (logits [B, V] at ``last_pos``, default the final position, and the
    cache)."""
    lay = llama._WHOLE if layout is None else layout
    b, p = input_ids.shape
    positions = torch.arange(p, device=input_ids.device)[None, :].expand(b, -1)
    x = lay.embed(config, params, input_ids)
    wins = llama.layer_windows(config)
    rope = llama.layer_rope(config, positions)
    kv_hook = lay.kv_hook(config)
    for i in range(config.num_layers):
        layer = lay.gather_layer(llama.layer_params(params, i))
        attn, (k, v) = attention_sublayer(
            config, x, layer["attn"], layer["input_norm"], positions, "xla",
            rope, return_kv=True,
            window_override=None if wins is None else wins[i],
            kv_hook=kv_hook)
        x = x + lay.leave(attn, "attn")
        h = _rmsnorm(x, layer["post_attn_norm"], config.rms_norm_eps)
        x = x + lay.leave(_moe_ffn(config, h, layer["moe"], no_drop=True,
                                   gmm_impl=gmm_impl)[0], "moe")
        cache["k"][i, :, :p] = k.to(cache["k"].dtype)
        cache["v"][i, :, :p] = v.to(cache["v"].dtype)
    x_last = x[:, -1:] if last_pos is None else x[:, last_pos:last_pos + 1]
    return llama.serve_head(layout)(config, params, x_last)[:, 0], cache


@torch.no_grad()
def decode_step(config: MoELlamaConfig, params: dict,
                token_ids: torch.Tensor, pos: int, cache: dict, *,
                gmm_impl: str = "auto"):
    """One contiguous-cache decode step (``models/sample.py``): attention
    over the whole cache (``llama.cache_attend``), the routed FFN drop-free
    on the one token. Returns (logits [B, V], the cache)."""
    positions = llama.step_positions(token_ids, pos)
    x = embed_tokens(config, params, token_ids)
    wins = llama.layer_windows(config)
    rope = llama.layer_rope(config, positions)
    for i in range(config.num_layers):
        layer = llama.layer_params(params, i)
        attn = attention_sublayer(
            config, x, layer["attn"], layer["input_norm"], positions, "xla",
            rope, window_override=None if wins is None else wins[i],
            attend_override=llama.cache_attend(cache["k"][i], cache["v"][i],
                                               pos, positions))
        x = x + attn
        h = _rmsnorm(x, layer["post_attn_norm"], config.rms_norm_eps)
        x = x + _moe_ffn(config, h, layer["moe"], no_drop=True,
                         gmm_impl=gmm_impl)[0]
    return lm_head_logits(config, params, x)[:, -1], cache


@torch.no_grad()
def paged_decode_step(config: MoELlamaConfig, params: dict,
                      token_ids: torch.Tensor, positions: torch.Tensor,
                      cache: dict, attend, last_index=None,
                      all_logits=False, *, gmm_impl: str = "auto",
                      layout=None):
    """One step over a PAGED multi-request cache, the
    ``llama.paged_decode_step`` contract (decode steps at T = 1, prefill
    chunks at T > 1), with the routed FFN drop-free: per-token routing does
    not depend on the co-resident slots. ``layout`` as in ``prefill``.
    Returns (logits [S, V], or [S, T, V] under ``all_logits``, and the
    cache)."""
    lay = llama._WHOLE if layout is None else layout
    pos2d = llama.paged_positions(token_ids, positions)
    x = lay.embed(config, params, token_ids)
    wins = llama.layer_windows(config)
    rope = llama.layer_rope(config, pos2d)
    kv_hook = lay.kv_hook(config)
    for i in range(config.num_layers):
        layer = lay.gather_layer(llama.layer_params(params, i))
        kp = llama._layer_pools(cache["k"], i)
        vp = llama._layer_pools(cache["v"], i)

        def override(q, k, v, *, window, scale, softcap, kp=kp, vp=vp):
            return attend(q, k, v, kp, vp, window=window, scale=scale,
                          softcap=softcap)

        attn = attention_sublayer(
            config, x, layer["attn"], layer["input_norm"], pos2d, "xla",
            rope, window_override=None if wins is None else wins[i],
            attend_override=override, kv_hook=kv_hook)
        x = x + lay.leave(attn, "attn")
        h = _rmsnorm(x, layer["post_attn_norm"], config.rms_norm_eps)
        x = x + lay.leave(_moe_ffn(config, h, layer["moe"], no_drop=True,
                                   gmm_impl=gmm_impl)[0], "moe")
    return (llama.paged_logits_at(llama.serve_head(layout), config, params,
                                  x, last_index, all_logits), cache)


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
