"""Sharding plans: every parallelism strategy as a logical -> mesh axis
mapping.

Counterpart of ``distributed_training_guide_tpu/parallel/plans.py``, whose
rules table it copies: DDP, ZeRO-1 / 2, FSDP, tensor parallelism with
sequence parallelism, and FSDP x TP are one table mapping the model's
logical parameter axes (vocab / embed / heads / kv / mlp) to mesh axes
(dp / fsdp / tp). ``spec_for_leaf`` gives each leaf its spec, a tuple of
mesh-axis entries per tensor dim (the JAX ``PartitionSpec``, trailing
``None`` dropped), and replicates a dim its axes do not divide, as JAX
does. ``torch.distributed``'s own wrappers (``DistributedDataParallel``,
``fully_shard``, ``parallelize_module``) are not used: the port's params are
leaves stacked on a leading ``[L]`` axis, which ``fully_shard`` would shard
on the layer dim, so one table places every leaf instead.

Where GSPMD inserts the collectives in the JAX package, the port runs them
itself (``ops/collectives.py``), on local tensors:

- a param lives as this rank's shard of its spec (``ShardingPlan.shard``;
  ``ShardingPlan.dtensor`` wraps it as a ``DTensor`` for checkpoints);
- ``LocalLayout`` (what ``models/llama.apply`` takes as
  ``activation_sharding``) all-gathers a layer's fsdp shards just before
  the layer (its backward reduce-scatters the grads), gathers the
  sequence-sharded residual over tp before attention and the MLP and
  reduce-scatters their row-parallel outputs after (sequence parallelism;
  without it an all-reduce), runs the embedding and the loss on the vocab
  shards, and maps the kv projection to the kv heads of the rank's q heads;
- ``LeafLayout`` says which collectives a leaf's grads and statistics need:
  the Trainer sums every grad over the data axes (each rank's loss is its
  share of the global mean), over tp where ranks hold partial sums, and
  takes global norms and means over the axes that shard it.

``pp*`` and ``ep*`` strategies and cp > 1 raise ``NotImplementedError``
naming their ROADMAP.md items.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any, Optional

import torch

from ..ops import collectives as C
from .mesh import AXIS_NAMES

# logical axis -> mesh axes, per strategy. A value may be a single mesh axis
# name or a tuple of them (sharded over both).
STRATEGIES: dict[str, dict[str, Any]] = {
    # chapter 01: one device
    "single": {},
    # chapter 02: replicated params, data sharded over (dp, fsdp)
    "ddp": {},
    # chapter 02 + ZeRO-1: params replicated, *optimizer state* sharded (the
    # optimizer-state rules below are applied by train/optimizer.py)
    "zero1": {},
    # ZeRO-2 (deepspeed stage 2): params replicated, optimizer state AND the
    # gradient-accumulation buffer sharded over the data axes — the grads'
    # reduce-scatter replaces DDP's all-reduce, and full grads never persist
    "zero2": {},
    # chapter 04: FULL_SHARD — every weight matrix sharded on its embed dim
    "fsdp": {
        "embed": "fsdp",
        "vocab": "fsdp",  # embedding + lm_head shard vocab (big dim, avoids
                          # resharding the embed dim used in every matmul)
    },
    # chapter 06: megatron TP + sequence parallelism for activations.
    # *_vector axes are the gpt2 biases — a column-parallel projection's
    # bias shards with its columns
    "tp": {
        "heads": "tp",
        "kv": "tp",
        "mlp": "tp",
        "vocab": "tp",
        "heads_vector": "tp",
        "kv_vector": "tp",
        "mlp_vector": "tp",
    },
    # chapter 07: 2-D = FSDP x TP on orthogonal axes
    "tp_fsdp": {
        "heads": "tp",
        "kv": "tp",
        "mlp": "tp",
        "vocab": "tp",
        "heads_vector": "tp",
        "kv_vector": "tp",
        "mlp_vector": "tp",
        "embed": "fsdp",
    },
    # chapter 09 (beyond the reference): pipeline stages own layer slices;
    # the stacked layer dim is the sharded one (parallel/pipeline.py)
    "pp": {"layers": "pp"},
    "pp_fsdp": {"layers": "pp", "embed": "fsdp", "vocab": "fsdp"},
    "pp_tp": {"layers": "pp", "heads": "tp", "kv": "tp", "mlp": "tp",
              "vocab": "tp", "heads_vector": "tp", "kv_vector": "tp",
              "mlp_vector": "tp"},
    # pp x tp x fsdp: tp is manual inside the pipeline shard_map (megatron
    # shards + vocab-parallel embed/head), fsdp stays auto on the embed dim
    "pp_tp_fsdp": {"layers": "pp", "heads": "tp", "kv": "tp", "mlp": "tp",
                   "vocab": "tp", "heads_vector": "tp", "kv_vector": "tp",
                   "mlp_vector": "tp",
                   "embed": "fsdp"},
    # chapter 10 (beyond the reference): MoE expert parallelism — the expert
    # dim of stacked expert weights lives on ep. With moe_dispatch="dense"
    # GSPMD derives the token all-to-all from the static capacity
    # dispatch/combine einsums; with "ragged" (dropless sorted dispatch) the
    # sort is data-dependent, so the Trainer threads a manual shard_map over
    # the data axes that exchanges sorted expert groups instead
    # (models/moe.py make_ragged_ep_dispatch) — same rules table either way
    "ep": {"experts": "ep"},
    "ep_fsdp": {"experts": "ep", "embed": "fsdp", "vocab": "fsdp"},
}

# logical axes that shard the optimizer state only (ZeRO-1, reference C3):
ZERO1_RULES = {"embed": ("dp", "fsdp"), "vocab": ("dp", "fsdp")}

# the ROADMAP.md items that port what a plan here refuses
_PP_ITEM = "ROADMAP.md queue 1, 'Context parallel, pipeline parallel and overlap'"
_EP_ITEM = "ROADMAP.md queue 1, 'Expert parallelism'"


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of a mapping given as
    the mesh's shape, as the layout tests do)."""
    if isinstance(mesh, Mapping):
        return {a: int(mesh.get(a, 1)) for a in AXIS_NAMES}
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _dim_divisible(sizes: dict, axes, dim: int) -> bool:
    if axes is None:
        return True
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    size = int(math.prod(sizes[a] for a in names))
    return size > 0 and dim % size == 0


def spec_for_leaf(mesh, logical_axes: tuple, shape: tuple, rules: dict) -> tuple:
    """The spec of one parameter leaf; replicates non-divisible dims."""
    sizes = axis_sizes(mesh)
    entries = []
    used: set = set()
    for ax_name, dim in zip(logical_axes, shape):
        mesh_axes = rules.get(ax_name)
        if mesh_axes is not None:
            names = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
            if any(n in used for n in names) or not _dim_divisible(sizes, names, dim):
                mesh_axes = None
            else:
                used.update(names)
        entries.append(mesh_axes)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _tree_map(fn, axes_tree, shape_tree):
    if isinstance(axes_tree, dict):
        return {k: _tree_map(fn, axes_tree[k], shape_tree[k])
                for k in axes_tree}
    return fn(axes_tree, tuple(shape_tree))


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Everything the Trainer needs to lay out one strategy on one mesh."""

    mesh: Any
    strategy: str
    rules: dict
    sequence_sharded: bool = False  # SP: shard the seq dim of activations on tp
    zero1: bool = False             # shard optimizer state over the data axes
    zero2: bool = False             # zero1 + shard persistent gradients too

    # ---- the mesh ----------------------------------------------------------
    @property
    def sizes(self) -> dict:
        return axis_sizes(self.mesh)

    def size(self) -> int:
        """Devices in the mesh (ranks)."""
        return int(math.prod(self.sizes.values()))

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.mesh.get_group(axis)

    def rank_over(self, axes) -> int:
        """This rank's index among the shards of ``axes`` (the first axis
        major, as a DTensor lays out several mesh dims on one tensor dim)."""
        idx = 0
        for a in axes:
            idx = idx * self.sizes[a] + self.mesh.get_local_rank(a)
        return idx

    @property
    def tensor_parallel(self) -> bool:
        """True when the rules put a model axis on tp."""
        return any("tp" in entry_axes(v) for v in self.rules.values())

    # ---- batch / data ------------------------------------------------------
    @property
    def data_axes(self) -> tuple:
        """Mesh axes that partition the global batch dim (ep is one: tokens
        shard over it in the JAX package's expert parallelism)."""
        return ("dp", "fsdp", "ep")

    def batch_spec(self, ndim: int = 2) -> tuple:
        seq = ("cp",) if self.sizes["cp"] > 1 else None
        if ndim == 1:
            return (self.data_axes,)
        extra = [seq[0] if seq else None] + [None] * (ndim - 2)
        return (self.data_axes, *extra)

    @property
    def data_parallel_size(self) -> int:
        return int(math.prod(self.sizes[a] for a in self.data_axes))

    @property
    def data_rank(self) -> int:
        """This rank's data coordinate: which rows of a global batch it
        reads (ranks of one tp group read the same rows)."""
        return self.rank_over(self.data_axes)

    # ---- activations -------------------------------------------------------
    def activation_sharding(self) -> Optional[tuple]:
        """The residual stream's spec [B, S, E] between blocks: the seq dim
        on tp under sequence parallelism (norms run on 1/tp of the tokens,
        an all-gather before attention / MLP and a reduce-scatter after)."""
        if self.sequence_sharded and self.sizes["tp"] > 1:
            return (self.data_axes, "tp", None)
        if self.strategy == "single":
            return None
        return (self.data_axes, None, None)

    def logits_sharding(self) -> Optional[tuple]:
        """Loss-parallel layout [B, S, V]: the vocab dim stays tp-sharded
        through the cross-entropy (``ops/vocab_parallel.py``)."""
        if self.rules.get("vocab") == "tp" and self.sizes["tp"] > 1:
            return (self.data_axes, None, "tp")
        return None

    # ---- params / optimizer state -----------------------------------------
    def param_specs(self, logical_axes_tree, shape_tree) -> Any:
        """Spec tree for params (shape_tree: shapes, the axes tree's
        structure)."""
        return _tree_map(
            lambda ax, shape: spec_for_leaf(self.mesh, ax, shape, self.rules),
            logical_axes_tree, shape_tree)

    def optimizer_state_rules(self) -> dict:
        """Rules for optimizer-state leaves (adds ZeRO-1 on top of params)."""
        if self.zero1:
            return {**self.rules, **ZERO1_RULES}
        return self.rules

    def optimizer_state_specs(self, logical_axes_tree, shape_tree) -> Any:
        rules = self.optimizer_state_rules()
        return _tree_map(
            lambda ax, shape: spec_for_leaf(self.mesh, ax, shape, rules),
            logical_axes_tree, shape_tree)

    def grad_shardings(self, logical_axes_tree, shape_tree) -> Any:
        """Specs of *persistent* gradient buffers (ZeRO-2): grads follow the
        optimizer-state layout, so under zero2 the accumulation buffer is
        reduce-scattered across the data axes (``PlanState._scatter``)."""
        if self.zero2:
            return self.optimizer_state_specs(logical_axes_tree, shape_tree)
        return self.param_specs(logical_axes_tree, shape_tree)

    # ---- shards ------------------------------------------------------------
    def placements(self, spec: tuple) -> list:
        """The DTensor placement of each mesh dim for ``spec``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in AXIS_NAMES:
            dims = [d for d, e in enumerate(spec) if axis in entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def local_shape(self, spec: tuple, shape: tuple) -> tuple:
        shape = list(shape)
        for d, e in enumerate(spec):
            shape[d] //= int(math.prod(self.sizes[a] for a in entry_axes(e)))
        return tuple(shape)

    def shard(self, spec: tuple, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full tensor (a view)."""
        for d, e in enumerate(spec):
            axes = entry_axes(e)
            if axes:
                n = int(math.prod(self.sizes[a] for a in axes))
                size = full.shape[d] // n
                full = full.narrow(d, self.rank_over(axes) * size, size)
        return full

    def unshard(self, spec: tuple, local: torch.Tensor,
                skip: tuple = ()) -> torch.Tensor:
        """All-gather ``local`` over the axes of ``spec`` but ``skip``
        (autograd-aware: the backward reduce-scatters); the inner axis of
        an entry first, so the shards land in ``rank_over`` order."""
        for d, e in enumerate(spec):
            for a in reversed([a for a in entry_axes(e) if a not in skip]):
                local = C.all_gather(local, self.group(a), d)
        return local

    def dtensor(self, local: torch.Tensor, spec: tuple, shape: tuple):
        """``local`` (this rank's shard, storage shared) as the DTensor of
        global ``shape`` laid out by ``spec``."""
        from torch.distributed.tensor import DTensor

        shape = torch.Size(shape)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh, self.placements(spec),
                                  run_check=False, shape=shape, stride=stride)


def make_plan(strategy: str, mesh, *, sequence_sharded: Optional[bool] = None,
              zero1: Optional[bool] = None,
              zero2: Optional[bool] = None) -> ShardingPlan:
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; choose from {sorted(STRATEGIES)}")
    if strategy.startswith("pp"):
        raise NotImplementedError(f"strategy {strategy!r}: {_PP_ITEM}")
    if strategy.startswith("ep"):
        raise NotImplementedError(f"strategy {strategy!r}: {_EP_ITEM}")
    sizes = axis_sizes(mesh)
    if sizes["cp"] > 1:
        raise NotImplementedError(f"context parallelism (cp > 1): {_PP_ITEM}")
    if sizes["pp"] > 1 or sizes["ep"] > 1:
        raise NotImplementedError(
            f"a mesh with pp or ep > 1: {_PP_ITEM}; {_EP_ITEM}")
    if sequence_sharded is None:
        sequence_sharded = strategy in ("tp", "tp_fsdp")
    if zero2 is None:
        zero2 = strategy == "zero2"
    if zero1 is None:
        zero1 = strategy == "zero1" or zero2
    return ShardingPlan(mesh=mesh, strategy=strategy, rules=STRATEGIES[strategy],
                        sequence_sharded=sequence_sharded, zero1=zero1,
                        zero2=zero2)


# ---------------------------------------------------------------------------
# One leaf on a rank
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LeafLayout:
    """One leaf as this rank holds it: its ``spec``, its global ``shape``,
    and the collectives over the axes that shard it (global means and
    norms for the optimizer and the grad norm)."""

    plan: ShardingPlan
    spec: tuple
    global_shape: tuple

    def axes_of(self, dim: int) -> tuple:
        return entry_axes(self.spec[dim]) if dim < len(self.spec) else ()

    @property
    def sharded_axes(self) -> tuple:
        return tuple(a for e in self.spec for a in entry_axes(e))

    def _sum_over(self, x: torch.Tensor, axes) -> torch.Tensor:
        for a in axes:
            x = C.all_reduce_(x, self.plan.group(a))
        return x

    def mean(self, x: torch.Tensor, dim: int, keepdim: bool = False):
        """The mean over tensor dim ``dim`` of the global leaf, from this
        rank's shard ``x``."""
        axes = self.axes_of(dim)
        if not axes:
            return x.mean(dim, keepdim=keepdim)
        s = self._sum_over(x.sum(dim, keepdim=keepdim, dtype=torch.float32),
                           axes)
        return (s / self.global_shape[dim]).to(x.dtype)

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        if not self.sharded_axes:
            return torch.mean(x)
        s = self._sum_over(x.sum(dtype=torch.float32), self.sharded_axes)
        return (s / math.prod(self.global_shape)).to(x.dtype)


def global_norm(grads: list, layouts: list) -> torch.Tensor:
    """The fp32 L2 norm of the global grads, from each rank's shards: each
    leaf's norm (summed in squares over the axes that shard it), then the
    norm of those, the single-device Trainer's order."""
    plan = layouts[0].plan
    if all(g.dtype == torch.float32 for g in grads):
        norms = list(torch._foreach_norm(grads))
    else:
        norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
                 for g in grads]
    for i, lay in enumerate(layouts):
        if lay.sharded_axes:
            sq = norms[i] * norms[i]
            for a in lay.sharded_axes:
                sq = C.all_reduce_(sq, plan.group(a))
            norms[i] = torch.sqrt(sq)
    return torch.linalg.vector_norm(torch.stack(norms))


# ---------------------------------------------------------------------------
# The forward on a rank (models/llama.py:apply)
# ---------------------------------------------------------------------------

# leaves every tp rank keeps whole but uses on its own heads only: their
# grads are partial sums over tp (the kv projection where it is not
# sharded, the per-head q / k norm scales)
_PARTIAL_ON_TP = ("wk", "wv", "bk", "bv", "q_norm", "k_norm")


class LocalLayout:
    """What the llama forward and the loss need on one rank under a plan:
    the specs of the param shards it holds, and the tp context. It is what
    ``models/llama.apply`` takes as ``activation_sharding``."""

    def __init__(self, plan: ShardingPlan, specs: dict, config):
        self.plan = plan
        self.specs = specs                  # path -> spec of the param
        self.tp_on = plan.tensor_parallel
        self.tp = plan.sizes["tp"]
        self.sp = self.tp_on and plan.sequence_sharded
        self.tp_group = plan.group("tp") if self.tp_on else None
        self.tp_rank = plan.mesh.get_local_rank("tp") if self.tp_on else 0
        self.vocab_parallel = "tp" in entry_axes(
            (specs["embed/embedding"] + (None,))[0])
        if self.tp_on:
            _check_tp(config, self.tp, specs)

    # ---- params ------------------------------------------------------------
    def gather_leaf(self, path: str, local: torch.Tensor,
                    layer: bool = False) -> torch.Tensor:
        """A param's compute form: its shards over the data axes (fsdp)
        all-gathered, its tp shard kept. ``layer``: one layer's slice of a
        stacked leaf (the spec's layer dim dropped)."""
        spec = self.specs[path][1:] if layer else self.specs[path]
        return self.plan.unshard(spec, local, skip=("tp",))

    def gather_layer(self, layer: dict, prefix: str = "layers") -> dict:
        return {k: (self.gather_layer(v, f"{prefix}/{k}")
                    if isinstance(v, dict)
                    else self.gather_leaf(f"{prefix}/{k}", v, layer=True))
                for k, v in layer.items()}

    # ---- the residual stream ----------------------------------------------
    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """A sublayer's input: the full sequence, read by every tp rank."""
        if not self.tp_on:
            return h
        if self.sp:
            return C.all_gather(h, self.tp_group, 1)
        return C.copy_to(h, self.tp_group)

    def leave(self, out: torch.Tensor) -> torch.Tensor:
        """A row-parallel sublayer output summed over tp (reduce-scattered
        onto the sequence shards under sequence parallelism)."""
        if not self.tp_on:
            return out
        if self.sp:
            return C.reduce_scatter(out, self.tp_group, 1)
        return C.all_reduce(out, self.tp_group)

    def _seq_shard(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[1] // self.tp
        return x.narrow(1, self.tp_rank * n, n)

    # ---- attention ---------------------------------------------------------
    def kv_hook(self, config):
        """Where tp does not divide the kv heads (it shards their fused
        dim, even in half-heads, as the JAX layout does): gather the kv
        projection over tp and keep the kv heads this rank's q heads read.
        None where each rank holds whole heads of its own."""
        if not self.tp_on:
            return None
        hkv, d = config.num_kv_heads, config.head_size
        sharded = "tp" in entry_axes(
            (self.specs["layers/attn/wk"] + (None,) * 3)[2])
        if sharded and hkv % self.tp == 0:
            return None
        hq_local = config.num_heads // self.tp
        lo = self.tp_rank * hq_local // (config.num_heads // hkv)
        group = self.tp_group if sharded else None

        def hook(t: torch.Tensor) -> torch.Tensor:
            full = C.all_gather(t, group, -1)
            return full[..., lo * d:(lo + 1) * d]
        return hook

    # ---- embedding, head and loss -----------------------------------------
    def embed(self, config, params: dict, input_ids: torch.Tensor):
        from ..ops.vocab_parallel import vocab_parallel_embed

        table = self.gather_leaf("embed/embedding",
                                 params["embed"]["embedding"])
        if self.vocab_parallel:
            x = vocab_parallel_embed(table, input_ids, self.tp_group,
                                     self.tp_rank,
                                     scatter_dim=1 if self.sp else None)
        else:
            x = table[input_ids.long()]
            if self.sp:
                x = self._seq_shard(x)
        x = x.to(config.dtype)
        if getattr(config, "scale_embed", False):
            x = x * torch.tensor(config.hidden_size ** 0.5,
                                 dtype=config.dtype, device=x.device)
        return x

    def head_weights(self, config, params: dict) -> torch.Tensor:
        """[E, V or V/tp] output projection in compute dtype."""
        if config.tie_word_embeddings:
            return self.gather_leaf("embed/embedding",
                                    params["embed"]["embedding"]
                                    ).T.to(config.dtype)
        return self.gather_leaf("lm_head", params["lm_head"]).to(config.dtype)

    def logits(self, config, params: dict, hidden: torch.Tensor):
        """This rank's fp32 logits: [B, S, V/tp] under vocab parallelism,
        else [B, S (or its seq shard), V]."""
        from ..ops.matmul import matmul_f32_out

        h = self.enter(hidden) if self.vocab_parallel else hidden
        logits = matmul_f32_out(h, self.head_weights(config, params))
        cap = getattr(config, "final_logit_softcap", None)
        if cap:
            logits = torch.tanh(logits / cap) * cap
        return logits

    def loss(self, config, params: dict, hidden: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """The global mean next-token NLL: every rank's (sum, count) pair
        summed over the ranks that hold different tokens (the data axes,
        and tp where each rank has its own sequence shard), never a mean of
        per-rank means. Its backward gives each rank its share of the one
        global loss's gradient."""
        from ..ops.cross_entropy import global_mean_loss, nll_and_count
        from ..ops.vocab_parallel import vocab_parallel_nll

        logits = self.logits(config, params, hidden)
        groups = [self.plan.group(a) for a in self.plan.data_axes]
        if self.vocab_parallel:
            nll, count = vocab_parallel_nll(logits[:, :-1], labels[:, 1:],
                                            self.tp_group, self.tp_rank)
        elif self.sp:       # this rank's sequence shard: targets shifted first
            targets = torch.nn.functional.pad(labels[:, 1:], (0, 1),
                                              value=-100)
            nll, count = nll_and_count(logits, self._seq_shard(targets))
            groups.append(self.tp_group)
        else:
            nll, count = nll_and_count(logits[:, :-1], labels[:, 1:])
        return global_mean_loss(nll, count, groups)

    # ---- grads -------------------------------------------------------------
    def grad_axes(self, path: str) -> tuple:
        """The axes a param's grad is summed over after backward: the data
        axes its gather did not already reduce-scatter, and tp where the
        tp ranks hold partial sums of a leaf they all keep (a norm scale
        on sequence shards, a per-head scale or an unsharded kv projection
        on their own heads)."""
        sharded = {a for e in self.specs[path] for a in entry_axes(e)}
        axes = [a for a in self.plan.data_axes if a not in sharded]
        if (self.tp_on and "tp" not in sharded
                and (self.sp or path.rsplit("/", 1)[-1] in _PARTIAL_ON_TP)):
            axes.append("tp")
        return tuple(axes)


def _check_tp(config, tp: int, specs: dict) -> None:
    """What the local tp forward needs of the model's widths."""
    problems = []
    if config.num_heads % tp:
        problems.append(f"num_heads {config.num_heads} % tp {tp}")
    if (config.num_kv_heads % tp and tp % config.num_kv_heads):
        problems.append(f"num_kv_heads {config.num_kv_heads} and tp {tp} "
                        f"(neither divides the other)")
    if "tp" not in entry_axes((specs["layers/mlp/gate"] + (None,) * 3)[2]):
        problems.append(f"intermediate_size {config.intermediate_size} % "
                        f"tp {tp}")
    if getattr(config, "qk_norm", False) == "flat":
        problems.append("qk_norm='flat' (a norm across every head)")
    if problems:
        raise NotImplementedError(
            "tensor parallelism here runs each rank on whole q heads and "
            "MLP columns of its own: " + "; ".join(problems))
