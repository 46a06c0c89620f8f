"""Serving under a plan: the page pool split over tp, and the ranks that
run the engine's programs together.

Counterpart of ``distributed_training_guide_tpu/serve/sharding.py``. The
JAX engine is one process driving a tp mesh: params follow the plan's
shardings, GSPMD inserts the collectives, and under ``shard_kv`` the pool
``[L, n_pages, page, kvh, hd]`` splits on its kv-head axis (``SERVE_KV_RULES``)
with the attend, commit and copy in a full-manual ``shard_map`` that
issues no collective. The port's plans run one process per rank, so:

- **Rank 0 leads.** It alone owns the ``Scheduler``, the prefix cache and
  every host decision (``ServeEngine``, ``DisaggEngine``).
- **Every rank runs every device program** of ``ModelPrograms`` in the
  same order, on its own params and its own pools: before rank 0 runs a
  program it broadcasts the call (``Channel``: the program's key and its
  host inputs, tensors by value, the params, pools and adapter stacks by
  name); the other ranks run ``follow(programs)`` until rank 0 sends a
  stop (``ModelPrograms.release``). A program that fails on any rank
  after its broadcast ends that rank (``abort_gang``), and the launcher
  (``launch.local``) ends the others: its peers may be inside one of its
  collectives, where a stop would not match what they wait for.
- **Params** are each rank's shards under the plan's rules, held through
  a ``ServeLayout`` (the training plans' ``LocalLayout`` without sequence
  parallelism: a decode step has one token a slot): tp's column / row
  split with the row-parallel ``all_reduce``, fsdp's per-layer gather, the
  vocab-parallel head's logits gathered whole before sampling, so the
  sort, top-k / top-p and the Gumbel draw see the whole vocabulary on
  every rank. int8 weights follow ``quantized_param_shardings``: the
  payload is split like its leaf, the scales' block axis where every
  shard holds whole blocks; otherwise each rank reads its own columns'
  scales off the whole row (``_scale_cut``).
- **The pool.** Without ``shard_kv`` every rank holds the whole pool, as
  the JAX layout replicates it: under tp each rank gathers its q / k / v
  heads, writes and attends every head, and keeps its heads of the
  output. With ``shard_kv`` each rank holds ``Hkv / tp`` heads of every
  page (and of the int8 scales), and its attend, commit and copy run on
  its slice with no collective (``validate_kv_shard``: tp > 1, tp the only
  axis above 1, tp dividing both head counts).
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
import sys
import traceback
from typing import NoReturn, Optional

import torch
import torch.distributed as dist

from ..ops import collectives as C
from ..parallel.plans import LocalLayout, _leaf, entry_axes
from ..train.precision import Quantized


def num_kv_heads(config) -> int:
    return getattr(config, "num_kv_heads", config.num_heads)

# Regex -> spec over serve-state tree paths, the JAX table: the pool
# splits on the kv-head axis (dim 3 of [L, n_pages, page, kvh, hd]), an
# int8 pool's payload and scales alike; the host bookkeeping the programs
# consume is replicated. An unmatched leaf is an error.
SERVE_KV_RULES = (
    (r"pages/(k|v)(/(q|scale))?$", (None, None, None, "tp", None)),
    (r"(tables|table_row)$", ()),
    (r"(lengths|tokens|seeds|actives|n_valid)$", ()),
    (r"(temps|top_ks|top_ps)$", ()),
)


def match_partition_rules(rules, tree, prefix: str = ""):
    """The spec tree of ``tree``: each leaf's "/"-joined path matched
    against ``rules`` (ordered (regex, spec) pairs, first hit wins);
    scalar and size-1 leaves replicate, anything unmatched raises."""
    if isinstance(tree, dict):
        return {k: match_partition_rules(
            rules, v, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree.items()}
    if isinstance(tree, Quantized):
        return Quantized(q=match_partition_rules(rules, tree.q,
                                                 f"{prefix}/q"),
                         scale=match_partition_rules(rules, tree.scale,
                                                     f"{prefix}/scale"))
    shape = tuple(getattr(tree, "shape", ()))
    if not shape or math.prod(shape) == 1:
        return ()
    for rule, spec in rules:
        if re.search(rule, prefix):
            return spec
    raise ValueError(f"no serve partition rule matches leaf {prefix!r} "
                     f"(shape {shape})")


def validate_kv_shard(plan, config) -> None:
    """The sharded-pool contract: tp is the mesh's only non-trivial axis
    and tp divides both head counts so every rank owns whole (kv-)heads."""
    if plan is None:
        raise ValueError("shard_kv=True needs a plan= with a tp mesh "
                         "(parallel.make_plan('tp', make_mesh(tp=N)))")
    sizes = plan.sizes
    tp = int(sizes["tp"])
    if tp < 2:
        raise ValueError(f"shard_kv=True needs mesh tp > 1, got tp={tp}")
    extra = [a for a, n in sizes.items() if n > 1 and a != "tp"]
    if extra:
        raise ValueError(
            f"shard_kv supports tp-only meshes (the attend region is "
            f"full-manual over every axis); axes {extra} have size > 1")
    kvh, hq = num_kv_heads(config), config.num_heads
    if kvh % tp or hq % tp:
        raise ValueError(
            f"kv pool shards on the kv-head axis: num_kv_heads ({kvh}) and "
            f"num_heads ({hq}) must both divide by tp ({tp})")


def serve_plan(plan):
    """The plan a serving engine holds params under: the same mesh and
    rules, no sequence parallelism."""
    return dataclasses.replace(plan, sequence_sharded=False)


def _map(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _scale_cut(plan, spec: tuple, q_full: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """This rank's scales of a quantized leaf whose payload ``spec``
    splits: the leading dims as the payload; along the trailing (block)
    axis, where the spec splits the columns, the scale of each of the
    rank's columns read off the whole row at a block ``g`` that divides
    the full block, the shard's width and its offset (``g`` is the full
    block where every shard holds whole blocks: then this is the block
    axis's own shard, as JAX's ``quantized_param_shardings`` splits it)."""
    lead = tuple(spec[:q_full.ndim - 1])
    scale = plan.shard(lead, scale)
    trail = spec[q_full.ndim - 1] if len(spec) >= q_full.ndim else None
    axes = entry_axes(trail)
    if not axes:
        return scale
    n_full = q_full.shape[-1]
    bs = -(-n_full // scale.shape[-1])
    shards = math.prod(plan.sizes[a] for a in axes)
    n_local = n_full // shards
    offset = plan.rank_over(axes) * n_local
    g = math.gcd(bs, n_local)
    cols = offset + torch.arange(n_local // g, device=scale.device) * g
    return scale.index_select(-1, cols // bs).contiguous()


def shard_leaf(plan, spec: tuple, leaf):
    """This rank's copy of one whole leaf under ``spec`` (a ``Quantized``
    leaf: the payload split like the leaf, its scales by ``_scale_cut``)."""
    if isinstance(leaf, Quantized):
        return Quantized(q=plan.shard(spec, leaf.q).contiguous(),
                         scale=_scale_cut(plan, spec, leaf.q, leaf.scale))
    return plan.shard(spec, leaf).contiguous()


def shard_params(plan, specs: dict, params):
    """This rank's shards of a whole (stored-layout) param tree."""
    return _map(lambda path, leaf: shard_leaf(plan, specs[path], leaf),
                params)


class ServeLayout(LocalLayout):
    """A rank's layout for the serve forwards (``prefill``,
    ``paged_decode_step`` of every family): ``LocalLayout`` over the plan
    without sequence parallelism, with int8 leaves gathered and read as
    their payload and scales, the logits gathered to the whole
    vocabulary, and where every rank holds the whole pool, each rank's
    heads gathered whole to write and attend it."""

    def __init__(self, plan, specs: dict, config, paths: dict, *,
                 shard_kv: bool):
        super().__init__(serve_plan(plan), specs, config, paths)
        self.shard_kv = shard_kv
        self.hq = config.num_heads
        self.hkv = num_kv_heads(config)

    def gather_leaf(self, path: str, local, layer: bool = False):
        if isinstance(local, Quantized):
            return Quantized(q=super().gather_leaf(path, local.q, layer),
                             scale=super().gather_leaf(path, local.scale,
                                                       layer))
        return super().gather_leaf(path, local, layer)

    def embed_rows(self, path: str, table, input_ids: torch.Tensor):
        from ..ops.quantized_matmul import quantized_take

        table = self.gather_leaf(path, table)
        if not isinstance(table, Quantized):
            if self.vocab_parallel:
                from ..ops.vocab_parallel import vocab_parallel_embed

                return vocab_parallel_embed(table, input_ids, self.tp_group,
                                            self.tp_rank)
            return table[input_ids.long()]
        if not self.vocab_parallel:
            return quantized_take(table, input_ids)
        v_local = table.q.shape[0]
        local = input_ids.long() - self.tp_rank * v_local
        mine = (local >= 0) & (local < v_local)
        rows = quantized_take(table, torch.where(mine, local, 0))
        return C.all_reduce(rows * mine[..., None].to(rows.dtype),
                            self.tp_group)

    def logits(self, config, params: dict, hidden: torch.Tensor):
        """The whole vocabulary's fp32 logits on every rank: the rank's
        vocab shard (the head's columns, or the tied table's rows) gathered
        over tp."""
        from ..ops.quantized_matmul import quantized_matmul

        path = self.head_path or self.table_path
        w = self.gather_leaf(path, _leaf(params, path))
        if isinstance(w, Quantized):
            logits = quantized_matmul(hidden, w,
                                      transpose=self.head_path is None)
            cap = getattr(config, "final_logit_softcap", None)
            if cap:
                logits = torch.tanh(logits / cap) * cap
        else:
            logits = super().logits(config, params, hidden)
        if self.vocab_parallel:
            logits = C.gather_tiled(logits, self.tp_group, logits.ndim - 1)
        return logits

    def kv_heads_local(self) -> int:
        """The kv heads a rank's k / v projections give it: every one
        without tp (or where attention runs whole), ``Hkv / tp`` where tp
        divides them, else the one head its q heads read (``kv_hook``)."""
        if not self.tp_on or "attn" in self.whole_parts:
            return self.hkv
        return self.hkv // self.tp if self.hkv % self.tp == 0 else 1

    def whole_heads(self, t: torch.Tensor, heads: int, dim: int):
        """Every one of ``heads`` heads along ``dim`` from each tp rank's
        share of them (where tp ranks share a head, as ``kv_hook`` gives
        it, each head once)."""
        if t.shape[dim] == heads:
            return t
        full = C.gather_tiled(t, self.tp_group, dim)
        step = full.shape[dim] // heads
        if step == 1:
            return full
        return full.index_select(dim, torch.arange(
            0, full.shape[dim], step, device=full.device))

    def lora_cut(self, name: str):
        """(a, b) of a multi-LoRA target ``name`` as this rank's base
        product holds it: b's columns where tp splits the base's output,
        a's rows where it splits the base's input; None where the base is
        whole here (no tp split, a whole part, or gathered by fsdp)."""
        part = "attn" if name in ("wq", "wk", "wv", "wo") else "mlp"
        spec = self.specs.get(f"layers/{part}/{name}")
        if spec is None or not self.tp_on or part in self.whole_parts:
            return None
        out_tp = "tp" in entry_axes((spec + (None,) * 3)[2])
        in_tp = "tp" in entry_axes((spec + (None,) * 3)[1])
        if not (out_tp or in_tp):
            return None
        rank, tp = self.tp_rank, self.tp

        def cut(a: torch.Tensor, b: torch.Tensor) -> tuple:
            if out_tp:
                n = b.shape[-1] // tp
                b = b.narrow(-1, rank * n, n)
            if in_tp:
                n = a.shape[-2] // tp
                a = a.narrow(-2, rank * n, n)
            return a, b
        return cut

    def attend(self, base):
        """The per-layer attend under this layout. With the whole pool on
        every tp rank (no ``shard_kv``), a rank's q heads (and k / v
        heads, where the kv projection is split) are gathered, every head
        is written and attended, and the rank keeps its heads of the
        output; otherwise ``base`` as it is."""
        if self.shard_kv or not self.tp_on:
            return base
        rank, hq, hkv = self.tp_rank, self.hq, self.hkv

        def attend(q, k, v, kp, vp, **kw):
            hq_local = q.shape[2]
            out, aux = base(self.whole_heads(q, hq, 2),
                            self.whole_heads(k, hkv, 2),
                            self.whole_heads(v, hkv, 2), kp, vp, **kw)
            if hq_local < hq:
                out = out.narrow(2, rank * hq_local, hq_local)
            return out, aux
        return attend


# ---------------------------------------------------------------------------
# rank 0 leads, the other ranks follow
# ---------------------------------------------------------------------------

class _Ref:
    """A by-name reference in a program call: the params, a pool, the
    adapter stacks (each rank's own)."""

    def __init__(self, kind: str, index: int = 0):
        self.kind, self.index = kind, index


class Channel:
    """The program calls rank 0 broadcasts over the plan's process group
    (every rank of the world), in the order it runs them. Tensors travel
    by value on the host; the params, the pools and the adapter stacks by
    name (``_Ref``)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.leader = self.rank == 0

    def send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=0, group=self.group)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def encode(programs, x):
    """A program argument as the followers receive it."""
    if x is programs.params:
        return _Ref("params")
    if programs.adapter_stacks is not None and x is programs.adapter_stacks:
        return _Ref("stacks")
    if isinstance(x, dict) and id(x) in programs._pool_ids:
        return _Ref("pages", programs._pool_ids[id(x)])
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu")
    if isinstance(x, Quantized):
        return Quantized(q=encode(programs, x.q),
                         scale=encode(programs, x.scale))
    if isinstance(x, dict):
        return {k: encode(programs, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(encode(programs, v) for v in x)
    return x


def decode(programs, x):
    """A received argument on this rank: references to its own params,
    pools and stacks, tensors on its device."""
    if isinstance(x, _Ref):
        if x.kind == "params":
            return programs.params
        if x.kind == "stacks":
            return programs.adapter_stacks
        return programs._pools[x.index]
    if isinstance(x, torch.Tensor):
        return x.to(programs.device)
    if isinstance(x, Quantized):
        return Quantized(q=decode(programs, x.q),
                         scale=decode(programs, x.scale))
    if isinstance(x, dict):
        return {k: decode(programs, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(decode(programs, v) for v in x)
    return x


def abort_gang(what: str) -> NoReturn:
    """End this rank at once, with exit status 1 and the traceback on
    stderr. Called where a program failed after its broadcast: the other
    ranks may be inside one of its collectives, which no later message
    (rank 0's stop, a follower's return) can match, so they would wait
    there until the backend's timeout. ``launch.local`` ends the gang's
    other ranks when one exits non-zero."""
    sys.stderr.write(f"{what}; ending this rank\n")
    traceback.print_exc()
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(1)


def follow(programs) -> int:
    """A follower rank's loop: run each program call rank 0 broadcasts,
    on this rank's params and pools, until rank 0's stop
    (``ModelPrograms.release``). Returns the number of calls run; a call
    that fails ends the rank (``abort_gang``)."""
    channel = programs._channel
    if channel is None or channel.leader:
        raise ValueError("follow() runs on a follower rank of a plan over "
                         "more than one rank; rank 0 drives the engine")
    n = 0
    while True:
        key, args, kwargs = channel.recv()
        if key == ("stop",):
            return n
        try:
            fn = programs.program(key)
            with torch.no_grad():
                fn(*decode(programs, args), **decode(programs, kwargs))
        except BaseException:
            abort_gang(f"rank {channel.rank} failed in program {key[0]!r}")
        n += 1


# ---------------------------------------------------------------------------
# pages across the tp ranks (the host tier, a cross-engine copy)
# ---------------------------------------------------------------------------

def gather_sharded_payload(pages: dict, page_ids, group) -> dict:
    """Every kv head of the given pages on the host, from each rank's
    head slice (the payload ``transport.gather_payload`` gives for the
    whole pool: what the JAX engine's gather of a sharded pool holds)."""
    from .transport import gather_payload, pool_leaf_names, _leaf as leaf_of

    names = pool_leaf_names(pages)
    dev = leaf_of(pages, names[0]).device
    idx = torch.as_tensor(list(page_ids), dtype=torch.long, device=dev)
    whole = {}
    for name in names:
        src = leaf_of(pages, name).index_select(1, idx)
        whole[name] = C.gather_tiled(src, group, 3)
    return gather_payload(_as_pool(whole), range(len(idx)))


def _as_pool(flat: dict) -> dict:
    """``{leaf name: tensor}`` (``k``, ``v``, or ``k.q`` / ``k.scale``) as
    a pools dict."""
    out = {}
    for name, t in flat.items():
        pool, _, part = name.partition(".")
        if part:
            prev = out.get(pool, {})
            prev[part] = t
            out[pool] = prev
        else:
            out[pool] = t
    return {k: Quantized(q=v["q"], scale=v["scale"]) if isinstance(v, dict)
            else v for k, v in out.items()}


def head_slice(payload: dict, rank: int, heads: int) -> dict:
    """This rank's kv heads of a whole payload (dim 3)."""
    return {k: v.narrow(3, rank * heads, heads).contiguous()
            for k, v in payload.items()}


def kv_heads_here(config, plan, shard_kv: bool) -> Optional[int]:
    """The kv heads a rank's pool holds: ``Hkv / tp`` under ``shard_kv``,
    else None (every head)."""
    if not shard_kv:
        return None
    return num_kv_heads(config) // int(plan.sizes["tp"])
