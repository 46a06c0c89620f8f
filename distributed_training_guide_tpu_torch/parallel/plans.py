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
  share of the global mean), over tp where ranks hold partial sums, over
  cp (each rank holds a sequence shard) and over pp for a leaf every stage
  keeps (the embedding on the first stage, the head on the last), and
  takes global norms and means over the axes that shard it.

Context parallelism (cp > 1) shards the residual's sequence contiguously
over cp: ``LocalLayout.positions`` gives the shard's global positions,
the loss reads targets shifted before the sequence was sharded, and the
attention is the ring or Ulysses (``ops/ring_attention.py``,
``ops/ulysses_attention.py``), built by the Trainer over the cp group.
The ``pp*`` strategies place the stacked ``[L]`` axis on pp; the step is
the 1F1B schedule of ``parallel/pipeline.py``. Under cp or pp the
residual is not sequence-sharded on tp (the JAX package's layout: cp
holds the sequence dim, and the pipeline's blocks carry no sequence
parallelism).

The ``ep*`` strategies (chapter 10) put the routed experts' ``experts``
axis on ep, a data axis: each ep rank holds other tokens and ``E / ep``
experts. ``LocalLayout`` gathers a layer's other shards but keeps the
experts' ep shard, and says how the tokens lie over the ranks
(``token_split``) for the MoE dispatch (``models/moe.py``): the ragged
exchange over the ep group, the dense dispatch's global slot map and the
load-balance loss's global means over every axis that splits tokens (the
data axes and cp). An expert leaf's grad is summed over the data axes but
ep (each rank owns its experts, and its exchange already brought every
ep rank's tokens to them); every other leaf's over all of them, as
before. A mixture of experts runs under every plan: the router (and the
shared expert's scalar gate) are whole on the tp ranks, whose grads of
them are partial sums.
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
    def sequence_parallel(self) -> bool:
        """The residual's sequence sharded on tp: the plan asks for it, tp
        > 1, and neither cp (which holds the sequence dim) nor pp (whose
        blocks carry none) is on."""
        sz = self.sizes
        return (self.sequence_sharded and sz["tp"] > 1 and sz["cp"] == 1
                and sz["pp"] == 1)

    def exchange(self, axis: str):
        """The ``ops/collectives.GroupExchange`` of this rank's line along
        ``axis`` (cp's ring, pp's stages)."""
        from ..ops.collectives import GroupExchange

        return GroupExchange(self.group(axis))

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
        if self.sizes["cp"] > 1:
            return (self.data_axes, "cp", None)
        if self.sequence_sharded and self.sizes["tp"] > 1:
            return (self.data_axes, "tp", None)
        if self.strategy == "single":
            return None
        return (self.data_axes, None, None)

    def logits_sharding(self) -> Optional[tuple]:
        """Loss-parallel layout [B, S, V]: the vocab dim stays tp-sharded
        through the cross-entropy (``ops/vocab_parallel.py``)."""
        if self.rules.get("vocab") == "tp" and self.sizes["tp"] > 1:
            seq = "cp" if self.sizes["cp"] > 1 else None
            return (self.data_axes, seq, "tp")
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
        reduce-scattered across the data axes (``PlanState.scatter``)."""
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

    def reshard(self, local: torch.Tensor, spec_from: tuple,
                spec_to: tuple) -> torch.Tensor:
        """This rank's shard under ``spec_to`` of the tensor whose shard
        under ``spec_from`` is ``local``: the shards gathered whole (none
        where ``spec_from`` replicates), then cut. ZeRO beside fsdp or tp
        (``ZERO1_RULES`` put the optimizer's embed dim on (dp, fsdp), dp
        major, which no fsdp shard contains), outside autograd."""
        if tuple(spec_from) == tuple(spec_to):
            return local
        return self.shard(spec_to, self.unshard(spec_from, local))

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

# leaves every tp rank keeps whole but uses on its own heads or MLP columns
# only: their grads are partial sums over tp (the kv projection where it is
# not sharded, the per-head q / k norm scales; the MoE router and shared
# expert gate, whose outputs weight the rank's partial expert outputs)
_PARTIAL_ON_TP = ("wk", "wv", "bk", "bv", "q_norm", "k_norm", "router",
                  "shared_gate")


def _under(specs: dict, prefix: str) -> dict:
    """The entries of ``specs`` under ``prefix``, the prefix dropped."""
    if not prefix:
        return specs
    cut = len(prefix) + 1
    return {p[cut:]: s for p, s in specs.items()
            if p.startswith(prefix + "/")}


def _leaf(params: dict, path: str) -> torch.Tensor:
    for k in path.split("/"):
        params = params[k]
    return params


class LocalLayout:
    """What a family's forward and the loss need on one rank under a plan:
    the specs of the param shards it holds, and the tp context. It is what
    every family's ``apply`` takes as ``activation_sharding`` (gpt2 and
    neox: the fused QKV shards its trailing heads axis, so each rank's q,
    k and v are its own heads and no kv hook is needed). ``paths`` is the
    family module's ``LAYOUT_PATHS``."""

    def __init__(self, plan: ShardingPlan, specs: dict, config, paths: dict,
                 model: str = "", partners: Optional[dict] = None):
        self.plan = plan
        self.specs = specs                  # path -> spec of the param
        self.tp_on = plan.tensor_parallel
        self.tp = plan.sizes["tp"]
        self.sp = self.tp_on and plan.sequence_parallel
        self.cp = plan.sizes["cp"]
        self.pp = plan.sizes["pp"]
        self.cp_group = plan.group("cp") if self.cp > 1 else None
        self.cp_rank = plan.mesh.get_local_rank("cp") if self.cp > 1 else 0
        self.tp_group = plan.group("tp") if self.tp_on else None
        self.tp_rank = plan.mesh.get_local_rank("tp") if self.tp_on else 0
        # the MoE dispatch: the ranks that hold other tokens, the ep group
        sizes = plan.sizes
        self.route_groups = tuple(plan.group(a) for a in (*plan.data_axes,
                                                          "cp")
                                  if sizes[a] > 1)
        # (where ep does not divide the experts, spec_for_leaf replicates
        # them, as JAX does, and each rank runs every expert)
        on_ep = "ep" in {a for e in _under(specs, model).get(
            paths["mlp_in"], ()) for a in entry_axes(e)}
        self.ep_exchange = (plan.exchange("ep") if on_ep and sizes["ep"] > 1
                            else None)
        # leaves whose fsdp gather the MoE dispatch runs itself (the
        # experts under a ragged ep_fsdp exchange: ``embed``)
        self.gathered_by_dispatch: frozenset = frozenset()
        # leaves a layer schedule hands the blocks already gathered
        # (``ops/overlap.py``; ``pregathered``)
        self.handed_gathered: frozenset = frozenset()
        # ``model``: the subtree of the params the family's forward reads
        # (a LoRA bundle's "base"); ``partners``: {adapter path: the leaf
        # it adapts}
        self.partners = partners or {}
        model_specs = _under(specs, model)
        # the family's token table, and its head (None: tied to the table)
        self.table_path = paths["table"]
        self.head_path = (paths["head"] if paths["head"] in model_specs
                          else None)
        self.vocab_parallel = "tp" in entry_axes(
            (model_specs[self.table_path] + (None,))[0])
        # the layer parts ("attn", "mlp") that tp's shards cannot run on
        # whole heads or columns: each runs whole on every tp rank
        self.whole_parts = (_whole_parts(config, self.tp, model_specs,
                                         paths["mlp_in"])
                            if self.tp_on else frozenset())

    def scoped(self, prefix: str) -> "LocalLayout":
        """This layout over the subtree ``prefix`` of the params (a LoRA
        bundle's ``base``): the same plan and tp context, the specs of the
        leaves under ``prefix`` with the prefix dropped."""
        out = object.__new__(LocalLayout)
        out.__dict__.update(self.__dict__)
        out.specs = _under(self.specs, prefix)
        return out

    def pregathered(self, paths) -> "LocalLayout":
        """This layout for blocks whose layer leaves at ``paths`` a
        schedule has already gathered (``ops/overlap.py:LayerSchedule``):
        ``gather_leaf`` passes them through, so nothing is gathered
        twice."""
        out = object.__new__(LocalLayout)
        out.__dict__.update(self.__dict__)
        out.handed_gathered = self.handed_gathered | frozenset(paths)
        return out

    # ---- params ------------------------------------------------------------
    def gather_leaf(self, path: str, local: torch.Tensor,
                    layer: bool = False) -> torch.Tensor:
        """A param's compute form: its shards over the data axes (fsdp)
        all-gathered, its tp and ep shards kept. ``layer``: one layer's
        slice of a stacked leaf (the spec's layer dim dropped)."""
        if path in self.gathered_by_dispatch:
            return local
        spec = self.specs[path][1:] if layer else self.specs[path]
        if path not in self.handed_gathered:
            local = self.plan.unshard(spec, local, skip=("tp", "ep"))
        if self._part(path) in self.whole_parts:
            local = self._gather_tp(spec, local)
        return local

    @staticmethod
    def _part(path: str):
        """The layer part a leaf belongs to ("attn", "mlp", "moe") or
        None outside the layers."""
        parts = path.split("/")
        return parts[1] if parts[0] == "layers" and len(parts) > 2 else None

    def _gather_tp(self, spec: tuple, local: torch.Tensor) -> torch.Tensor:
        """A whole part's leaf gathered over tp along its tp dim: under
        sequence parallelism each rank's grad of it is a partial sum (its
        own rows' outputs), so the backward reduce-scatters; without,
        every rank's grad is the whole one, so it keeps its slice."""
        for d, e in enumerate(spec):
            if "tp" in entry_axes(e):
                gather = C.all_gather if self.sp else C.gather_replicated
                return gather(local, self.tp_group, d)
        return local

    def gather_layer(self, layer: dict, prefix: str = "layers") -> dict:
        return {k: (self.gather_layer(v, f"{prefix}/{k}")
                    if isinstance(v, dict)
                    else self.gather_leaf(f"{prefix}/{k}", v, layer=True))
                for k, v in layer.items()}

    # ---- the residual stream ----------------------------------------------
    def enter(self, h: torch.Tensor, part=None) -> torch.Tensor:
        """A sublayer's input: the full sequence, read by every tp rank.
        A whole ``part`` (``whole_parts``) reads it as every rank runs it:
        the gathered sequence under sequence parallelism (its backward sums
        the ranks' partial input grads), else as it is."""
        if not self.tp_on:
            return h
        if part in self.whole_parts:
            return C.all_gather(h, self.tp_group, 1) if self.sp else h
        if self.sp:
            return C.all_gather(h, self.tp_group, 1)
        return C.copy_to(h, self.tp_group)

    def leave(self, out: torch.Tensor, part=None) -> torch.Tensor:
        """A row-parallel sublayer output summed over tp (reduce-scattered
        onto the sequence shards under sequence parallelism). A whole
        ``part``'s output is already the sum: this rank's sequence shard of
        it under sequence parallelism, else all of it; no collective."""
        if not self.tp_on:
            return out
        if part in self.whole_parts:
            return self._seq_shard(out) if self.sp else out
        if self.sp:
            return C.reduce_scatter(out, self.tp_group, 1)
        return C.all_reduce(out, self.tp_group)

    def _seq_shard(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[1] // self.tp
        return x.narrow(1, self.tp_rank * n, n)

    # ---- the MoE dispatch ----------------------------------------------------
    def token_split(self, h: torch.Tensor):
        """How the tokens of ``h`` [b, s, E] (a routed FFN's input, the full
        sequence of the rank's rows, or its cp shard) lie over the ranks:
        ``models/moe.py:TokenSplit``, or None where this rank holds every
        token alone (the single device's program)."""
        from ..models.moe import TokenSplit
        from ..ops.collectives import AxesExchange

        # tp ranks that route the same tokens and then sum their aux
        # gradients over tp: every one, but for experts run whole without
        # sequence parallelism, whose router grads are not summed over tp
        # (each rank's is the whole one)
        replicas = (self.tp if self.tp_on and (
            self.sp or "moe" not in self.whole_parts) else 1)
        if not self.route_groups and self.ep_exchange is None \
                and replicas == 1:
            return None
        b, s = h.shape[:2]
        rows = self.plan.data_rank * b + torch.arange(b, device=h.device)
        cols = self.cp_rank * s + torch.arange(s, device=h.device)
        index = (rows[:, None] * (s * self.cp) + cols[None, :]).reshape(-1)
        route = (AxesExchange(list(self.route_groups))
                 if self.route_groups else None)
        return TokenSplit(route=route, ep=self.ep_exchange,
                          token_index=index, replicas=replicas)

    # ---- attention ---------------------------------------------------------
    def kv_hook(self, config):
        """Where tp does not divide the kv heads (it shards their fused
        dim, even in half-heads, as the JAX layout does): gather the kv
        projection over tp and keep the kv heads this rank's q heads read.
        None where each rank holds whole heads of its own."""
        if not self.tp_on or "attn" in self.whole_parts:
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
    def embed_rows(self, path: str, table: torch.Tensor,
                   input_ids: torch.Tensor) -> torch.Tensor:
        """The rows of the token table at ``path`` for ``input_ids``, in
        the table's dtype: vocab-parallel when tp shards the vocab, and
        this rank's sequence shard under sequence parallelism."""
        from ..ops.vocab_parallel import vocab_parallel_embed

        table = self.gather_leaf(path, table)
        if self.vocab_parallel:
            return vocab_parallel_embed(table, input_ids, self.tp_group,
                                        self.tp_rank,
                                        scatter_dim=1 if self.sp else None)
        return self.seq_local(table[input_ids.long()])

    def seq_local(self, x: torch.Tensor) -> torch.Tensor:
        """Rows over the full sequence as the residual holds them: this
        rank's sequence shard under sequence parallelism."""
        return self._seq_shard(x) if self.sp else x

    def positions(self, seq: int, device) -> tuple:
        """(the global positions [1, seq] of this rank's rows, the whole
        sequence's length for a sequence-dependent rope, or None): under
        context parallelism the rank's contiguous shard of cp x ``seq``
        positions."""
        pos = torch.arange(seq, device=device)[None, :]
        if self.cp == 1:
            return pos, None
        return pos + self.cp_rank * seq, seq * self.cp

    def embed(self, config, params: dict, input_ids: torch.Tensor):
        """The llama family's embedding (scaled for Gemma)."""
        x = self.embed_rows(self.table_path, params["embed"]["embedding"],
                            input_ids).to(config.dtype)
        if getattr(config, "scale_embed", False):
            x = x * torch.tensor(config.hidden_size ** 0.5,
                                 dtype=config.dtype, device=x.device)
        return x

    def head_weights(self, config, params: dict) -> torch.Tensor:
        """[E, V or V/tp] output projection in compute dtype (the token
        table's transpose where the head is tied)."""
        if self.head_path is None:
            table = _leaf(params, self.table_path)
            return self.gather_leaf(self.table_path, table).T.to(
                config.dtype)
        return self.gather_leaf(self.head_path, _leaf(
            params, self.head_path)).to(config.dtype)

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
        tp where each rank has its own sequence shard, and cp), never a
        mean of per-rank means. Its backward gives each rank its share of
        the one global loss's gradient. Under context parallelism
        ``labels`` are the rank's targets, shifted before the sequence was
        sharded (``data/loader.py:shift_targets``)."""
        from ..ops.cross_entropy import global_mean_loss, nll_and_count
        from ..ops.vocab_parallel import vocab_parallel_nll

        logits = self.logits(config, params, hidden)
        groups = [self.plan.group(a) for a in self.plan.data_axes]
        if self.cp > 1:
            groups.append(self.cp_group)
            if self.vocab_parallel:
                nll, count = vocab_parallel_nll(logits, labels, self.tp_group,
                                                self.tp_rank)
            else:
                nll, count = nll_and_count(logits, labels)
        elif self.vocab_parallel:
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

    # ---- the global batch (a custom loss, the post-training loss) ---------
    def global_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows [b, s, ...] of the global batch gathered whole:
        the sequence over cp (dim 1: each rank holds a contiguous shard;
        the ring's zigzag is internal to it), then the rows over the data
        axes (dim 0, in ``data_rank`` order). Each rank's backward keeps
        its own slice (``ops/collectives.py:gather_replicated``)."""
        if self.cp > 1:
            x = C.gather_replicated(x, self.cp_group, 1)
        for a in reversed(self.plan.data_axes):
            if self.plan.sizes[a] > 1:
                x = C.gather_replicated(x, self.plan.group(a), 0)
        return x

    def global_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The global [B, S, V] logits from this rank's (``logits``):
        its vocab shard gathered over tp (or its sequence shard under
        sequence parallelism where the vocab is whole), then
        ``global_rows``. B x S x V fp32 on every rank."""
        if self.vocab_parallel:
            logits = C.gather_replicated(logits, self.tp_group, -1)
        elif self.sp:
            logits = C.gather_replicated(logits, self.tp_group, 1)
        return self.global_rows(logits)

    # ---- grads -------------------------------------------------------------
    def grad_axes(self, path: str) -> tuple:
        """The axes a param's grad is summed over after backward: the data
        axes its gather did not already reduce-scatter, and tp where the
        tp ranks hold partial sums of a leaf they all keep (a norm scale
        on sequence shards, a per-head scale or an unsharded kv projection
        on their own heads), cp (each rank's grad is its sequence shard's
        share), and pp for a leaf every stage keeps (the embedding, the
        norms and head: partial on the stages that use them, zero on the
        rest)."""
        sharded = {a for e in self.specs[path] for a in entry_axes(e)}
        axes = [a for a in self.plan.data_axes if a not in sharded]
        # a whole part's replicated leaf: every rank's grad is the whole
        # one without sequence parallelism, its own rows' share with
        whole = self._part(path) in self.whole_parts
        if (self.tp_on and "tp" not in sharded
                and (self.sp or (not whole and (
                    path.rsplit("/", 1)[-1] in _PARTIAL_ON_TP
                    or self._adapts_tp_leaf(path))))):
            axes.append("tp")
        if self.cp > 1:
            axes.append("cp")
        if self.pp > 1 and "pp" not in sharded:
            axes.append("pp")
        return tuple(axes)

    def _adapts_tp_leaf(self, path: str) -> bool:
        """A LoRA adapter whole on every tp rank whose base leaf tp shards:
        each rank's grad sums over its own block of the base's dims
        only."""
        base = self.partners.get(path)
        return base is not None and any(
            "tp" in entry_axes(e) for e in self.specs[base])


def _whole_parts(config, tp: int, specs: dict, mlp_in: str) -> frozenset:
    """The layer parts tp cannot run on shards of whole heads or columns,
    which then run whole on every tp rank (the JAX package runs the
    replicated or resharded weight there): attention where tp divides the
    q heads or the kv heads in neither direction, or under
    ``qk_norm="flat"`` (a norm across every head); the MLP where tp does
    not divide its width (``spec_for_leaf`` replicated it); a mixture of
    experts ("moe") where tp divides neither the routed experts' width nor
    ``shared_expert_intermediate``: its routed and shared experts' outputs
    are summed over tp together, so both run whole (every tp rank all its
    tokens through the whole expert weights, no tp sum)."""
    parts = set()
    hkv = getattr(config, "num_kv_heads", config.num_heads)
    if (config.num_heads % tp or (hkv % tp and tp % hkv)
            or getattr(config, "qk_norm", False) == "flat"):
        parts.add("attn")
    split = any("tp" in entry_axes(e) for e in specs[mlp_in])
    if mlp_in.startswith("layers/moe/"):
        shared = getattr(config, "shared_expert_intermediate", None)
        if not split or (shared and shared % tp):
            parts.add("moe")
    elif not split:
        parts.add("mlp")
    return frozenset(parts)
