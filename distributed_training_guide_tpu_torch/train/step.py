"""The train step, on one device or under a sharding plan.

Counterpart of ``distributed_training_guide_tpu/train/step.py``'s
``Trainer``. Where the JAX step is one compiled program, the port's is
eager PyTorch: forward (bf16 compute; attention through the flash kernels
on the card), backward, the fp32 grad norm, the guard, then the optimizer
and its schedule, updating the state in place. ``remat`` checkpoints each
layer under ``remat_policy`` (``ops/remat.py:REMAT_POLICIES``).

``plan`` (``parallel/plans.py:make_plan``; None or "single": one device)
lays the params out by the plan's rules table: each rank holds its shards
(``PlanState``), the forward runs on local tensors
(``models/llama.apply(activation_sharding=...)``, K1-K3 on the rank's own
heads), the loss is the global mean, and after backward every grad is
summed over the ranks that hold partial sums of it. ddp / zero1 / zero2:
params replicated, grads all-reduced over the data axes; zero1 shards the
optimizer state by ``ZERO1_RULES`` (each rank updates its slice, then the
params are all-gathered), zero2 also reduce-scatters the accumulation
buffer. fsdp: params sharded on embed / vocab, each layer all-gathered just
before it (again in the remat recompute), grads reduce-scattered. tp:
column-parallel wq / wk / wv / gate / up, row-parallel wo / down, the
residual's sequence on tp, the vocab-parallel embedding and loss. tp_fsdp:
both, on orthogonal axes.

``precision`` (``train/precision.py``) sets the storage: params in the
policy's dtype (or the model's, ``--param-dtype``), the optimizer state in
its form, and the gradient-accumulation buffer in ``accum_dtype``; the
optimizer computes in fp32 (``train/optimizer.py``). ``base_optimizer`` is
the spec without the policy: its fp32 layout is the restore target of a
checkpoint written before a run adopted a policy (``encode_fp32_state``).

Gradient accumulation sums the microbatch grads into the ``.grad``
buffers (or, where the policy's ``accum_dtype`` differs from the params',
into buffers of that dtype) and divides by ``grad_accum``, as the JAX scan
does. A model with ``apply_with_aux`` (MoE) trains on ``ce +
router_aux_coef * aux`` and reports the router's ``moe_dropped_frac``,
averaged over microbatches. ``DTG_FAULT_NAN_LOSS_STEP=N`` (read when the
Trainer is built) makes the loss of the step taken at ``state.step == N``
NaN, the guard drill.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from .._device import resolve_device
from ..models.registry import ModelBundle, family_module
from ..ops.cross_entropy import causal_lm_loss, chunked_causal_lm_loss
from ..ops.remat import REMAT_POLICIES, resolve_remat_policy
from .guards import apply_step_guard, validate_guard_policy
from .precision import cast_floats, resolve_policy
from .state import TrainState, named_leaves

__all__ = ["REMAT_POLICIES", "PlanState", "Trainer"]

# what the sharded paths leave for later, by ROADMAP.md item
_PLAN_REST = "ROADMAP.md queue 1, 'Distributed plans, the rest'"

# Trainer fields of the JAX package that later slices port, and where
_UNPORTED = {
    "context_impl": "'Context parallel, pipeline parallel and overlap'",
    "offload_opt_state": "'Chapter 05 recipe and conversion'",
    "offload_params": "'Chapter 05 recipe and conversion'",
    "lora_only": "'Other dense families' (LoRA)",
    "overlap_schedule": "'Context parallel, pipeline parallel and overlap'",
    "pp_microbatches": "'Context parallel, pipeline parallel and overlap'",
}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _global_norm(grads: list) -> torch.Tensor:
    """The fp32 global L2 norm of a list of grads of any float dtype."""
    if all(g.dtype == torch.float32 for g in grads):
        norms = torch._foreach_norm(grads)
    else:
        norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
                 for g in grads]
    return torch.linalg.vector_norm(torch.stack(norms))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass
class Trainer:
    """Builds the state and takes optimizer steps for one model on one
    device. ``optimizer`` is a ``train.optimizer`` spec (``adamw_cosine``,
    ``adafactor_cosine``, ``lion_cosine``); ``device`` defaults to cuda."""

    bundle: ModelBundle
    optimizer: Any
    grad_accum: int = 1
    remat: bool = False
    remat_policy: str = "all"
    loss_chunks: int = 0   # >0: chunked CE from hidden states
    attn_impl: str = "auto"
    loss_fn: Callable = causal_lm_loss
    guard_policy: str = "off"   # "off" | "skip" | "abort" (train/guards.py)
    precision: Any = "fp32"
    device: Any = None
    plan: Any = None            # a ShardingPlan; None or "single": one device
    context_impl: Any = None
    offload_opt_state: bool = False
    offload_params: bool = False
    lora_only: bool = False
    overlap_schedule: bool = False
    pp_microbatches: Any = None

    def __post_init__(self):
        validate_guard_policy(self.guard_policy)
        self.precision = resolve_policy(self.precision)
        resolve_remat_policy(self.remat_policy)
        self.base_optimizer = self.optimizer
        if getattr(self.plan, "strategy", None) == "single":
            if self.plan.size() > 1:
                raise ValueError(
                    f"strategy 'single' on a mesh of {self.plan.size()} "
                    f"ranks would train each rank alone on its rows; use "
                    f"'ddp' for a replicated model over many ranks")
            self.plan = None
        elif self.plan == "single":
            self.plan = None
        for name, item in _UNPORTED.items():
            if getattr(self, name) not in (None, False):
                raise NotImplementedError(
                    f"Trainer({name}=...) is not ported yet (ROADMAP.md "
                    f"queue 1, {item})")
        if self.loss_chunks > 0 and self.loss_fn is not causal_lm_loss:
            raise NotImplementedError(
                "loss_chunks hardwires the causal-LM loss; drop the custom "
                "loss_fn or the chunking")
        self.device = resolve_device(self.device)
        from ..utils.faults import active_faults

        self._nan_fault_step = active_faults().nan_loss_step
        self.plan_state = (None if self.plan is None
                           else PlanState.build(self))

    # ---- init --------------------------------------------------------------
    def _fresh_state(self, params, seed: int, policy=None,
                     optimizer=None) -> TrainState:
        policy = self.precision if policy is None else policy
        params = policy.cast_params(params)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(int(seed))
        if self.plan_state is not None:
            return self.plan_state.fresh_state(
                params, policy, optimizer or self.optimizer, rng)
        params = _map(params, lambda t: t.requires_grad_(True))
        opt_state = (optimizer or self.optimizer).init(_leaves(params),
                                                       policy)
        return TrainState(step=0, params=params, opt_state=opt_state,
                          rng=rng)

    def init_state(self, seed: int) -> TrainState:
        """Random init from ``seed``, on the trainer's device, stored under
        the precision policy."""
        cfg = self.bundle.config
        return self._fresh_state(
            self.bundle.init(cfg, seed, device=self.device), seed)

    def init_state_from_params(self, params, seed: int = 0) -> TrainState:
        """Fresh optimizer state around given params (copied to the
        trainer's device, so the caller's tensors are never updated)."""
        return self._fresh_state(
            _map(params, lambda t: t.detach().to(self.device, copy=True)),
            seed)

    def fp32_reference_state(self, seed: int = 0) -> TrainState:
        """A state in the layout before any policy: fp32 params and the
        base optimizer's fp32 state (the restore target of a checkpoint
        written by an fp32 run)."""
        from .precision import POLICIES

        params = cast_floats(self.bundle.init(self.bundle.config, seed,
                                              device=self.device),
                             torch.float32)
        return self._fresh_state(params, seed, POLICIES["fp32"],
                                 self.base_optimizer)

    def encode_fp32_state(self, state32: TrainState) -> TrainState:
        """Re-encode an fp32-layout state into this trainer's policy: the
        params cast, each optimizer slot stored in the policy's form (Adam's
        moments quantized under adam8bit), the counts and generator
        carried over."""
        if self.precision.is_noop:
            return state32
        if self.plan_state is not None:
            raise NotImplementedError(
                f"re-encoding an fp32 checkpoint into a policy under a "
                f"sharding plan: {_PLAN_REST}")
        state = self._fresh_state(
            _map(state32.params, lambda t: t.detach()), 0)
        opt32 = state32.opt_state.optimizer
        opt = state.opt_state.optimizer
        policy = self.precision
        for (_, p32), (_, p) in zip(named_leaves(state32.params),
                                    named_leaves(state.params)):
            opt.state[p] = {k: policy.store_moment(v.float(), opt.SLOTS[k])
                            for k, v in opt32.state[p32].items()
                            if k != "step"}
        count = state32.opt_state.count
        state.opt_state.set_count(count)
        if hasattr(opt, "count"):
            opt.count = count
        state.step = state32.step
        state.rng.set_state(state32.rng.get_state())
        return state

    # ---- the step ----------------------------------------------------------
    def _loss(self, params, mb: dict) -> tuple:
        """(loss, extra metrics) of one microbatch; the extras are
        detached fp32 scalars."""
        cfg = self.bundle.config
        kw = dict(positions=mb.get("positions"), remat=self.remat,
                  remat_policy=self.remat_policy, attn_impl=self.attn_impl,
                  return_hidden=self.loss_chunks > 0)
        extras, aux_loss = {}, None
        if self.bundle.apply_with_aux is not None:
            out, aux, extras = self.bundle.apply_with_aux(
                cfg, params, mb["input_ids"], return_metrics=True, **kw)
            aux_loss = getattr(cfg, "router_aux_coef", 0.0) * aux
            extras = {k: v.detach() for k, v in extras.items()}
        else:
            out = self.bundle.apply(cfg, params, mb["input_ids"], **kw)
        if self.loss_chunks > 0:
            w_out = family_module(self.bundle.family).output_weights(cfg,
                                                                     params)
            loss = chunked_causal_lm_loss(out, w_out, mb["labels"],
                                          num_chunks=self.loss_chunks)
        else:
            loss = self.loss_fn(out, mb["labels"])
        return (loss if aux_loss is None else loss + aux_loss), extras

    def step_fn(self, state: TrainState, batch: dict) -> tuple:
        """One optimizer step on ``batch`` ({"input_ids", "labels"}
        [B, S], or [A, B, S] under grad accumulation). Updates ``state`` in
        place and returns (state, {"loss", "grad_norm"[, "notfinite"]}),
        the metrics as fp32 device scalars. Under a plan ``batch`` holds
        this rank's rows (``data/loader.py``)."""
        if self.plan_state is not None:
            return self.plan_state.step(state, batch)
        leaves = _leaves(state.params)
        state.opt_state.optimizer.zero_grad(set_to_none=True)
        buffers = None      # the accumulation buffers, where not .grad
        if self.grad_accum > 1:
            accum = self.precision.accum_dtype
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            extras = {}
            for a in range(self.grad_accum):
                mb_loss, mb_extras = self._loss(
                    state.params, {k: v[a] for k, v in batch.items()})
                mb_loss.backward()
                if any(p.dtype != accum for p in leaves):
                    mb = [p.grad.to(accum) for p in leaves]
                    if buffers is None:
                        buffers = mb
                    else:
                        torch._foreach_add_(buffers, mb)
                    for p in leaves:
                        p.grad = None
                loss = loss + mb_loss.detach()
                for k, v in mb_extras.items():
                    extras[k] = extras.get(k, 0.0) + v / self.grad_accum
            loss = loss / self.grad_accum
            grads = [p.grad for p in leaves] if buffers is None else buffers
            torch._foreach_div_(grads, float(self.grad_accum))
        else:
            loss, extras = self._loss(state.params, batch)
            loss.backward()
            loss = loss.detach()
            grads = [p.grad for p in leaves]
        if (self._nan_fault_step is not None
                and state.step == self._nan_fault_step):
            loss = torch.full_like(loss, float("nan"))
        metrics = {
            "loss": loss.to(torch.float32),
            "grad_norm": _global_norm(grads),
            **{k: v.to(torch.float32) for k, v in extras.items()},
        }
        apply_update = True
        if self.guard_policy != "off":
            metrics, apply_update = apply_step_guard(self.guard_policy,
                                                     metrics)
        if apply_update:
            state.opt_state.step(buffers)
        state.step += 1
        return state, metrics

    # ---- accounting --------------------------------------------------------
    def tokens_per_step(self, per_device_batch: int, seq_len: int) -> int:
        """Tokens per optimizer step over every rank (data ranks * batch *
        seq * grad_accum)."""
        dp = 1 if self.plan is None else self.plan.data_parallel_size
        return dp * per_device_batch * seq_len * self.grad_accum


# ---------------------------------------------------------------------------
# Under a sharding plan
# ---------------------------------------------------------------------------

def _unflatten(flat: dict) -> dict:
    """{"a/b": t} -> {"a": {"b": t}}."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


class StateShards:
    """What a ``TrainState`` under a plan carries beside its params: the
    update shard of each param whose optimizer state is sharded where the
    param is not (ZeRO: the optimizer steps the shard, then the params are
    all-gathered), and the DTensor form of each tensor for checkpoints."""

    def __init__(self, plan_state: "PlanState", update: dict):
        self.plan_state = plan_state
        self.update = update            # path -> the optimizer's shard

    def update_leaf(self, path: str, p: torch.Tensor) -> torch.Tensor:
        return self.update.get(path, p)

    def param_dtensor(self, path: str, p: torch.Tensor):
        ps = self.plan_state
        return ps.plan.dtensor(p, ps.specs[path], ps.shapes[path])

    def slot_dtensor(self, path: str, slot: str, t: torch.Tensor, opt):
        """An optimizer slot as a DTensor: laid out as its leaf's update
        shard, but adafactor's row / column accumulators (the reduced dim
        dropped: the global mean made them whole along it) and a quantized
        moment's block scales (one per block of the trailing axis)."""
        from ..parallel.plans import entry_axes
        from .optimizer import factored_dims

        if t.ndim == 0:
            return t
        ps = self.plan_state
        spec = ps.opt_specs[path] + (None,) * len(ps.shapes[path])
        spec = spec[:len(ps.shapes[path])]
        shape = ps.shapes[path]
        base = slot.split(".")[0]
        if base in ("v_row", "v_col"):
            d1, d0 = factored_dims(shape, opt.min_dim)
            drop = d0 if base == "v_row" else d1
            spec = spec[:drop] + spec[drop + 1:]
            shape = shape[:drop] + shape[drop + 1:]
        elif slot.endswith(".scale"):
            n = math.prod(ps.plan.sizes[a] for a in entry_axes(spec[-1]))
            shape = shape[:-1] + (t.shape[-1] * n,)
        while spec and spec[-1] is None:
            spec = spec[:-1]
        return ps.plan.dtensor(t, spec, shape)

    @torch.no_grad()
    def gather_updates(self, params: dict) -> None:
        """The stepped update shards all-gathered into their params."""
        ps = self.plan_state
        flat = dict(named_leaves(params))
        for path, u in self.update.items():
            flat[path].copy_(ps.plan.unshard(ps.opt_specs[path], u))

    @torch.no_grad()
    def reshard_update_leaves(self, state: TrainState) -> None:
        """Refresh the update shards from the params (after a restore,
        which fills the params)."""
        ps = self.plan_state
        flat = dict(named_leaves(state.params))
        for path, u in self.update.items():
            u.copy_(ps.plan.shard(ps.opt_specs[path], flat[path]))


class PlanState:
    """A Trainer's layout under a sharding plan: every leaf's spec (the
    plan's rules) and that of its optimizer state, the ``LocalLayout`` the
    forward runs on, and the sharded step."""

    def __init__(self, trainer, specs: dict, opt_specs: dict, shapes: dict):
        from ..parallel.plans import LeafLayout, LocalLayout

        self.trainer = trainer
        self.plan = trainer.plan
        self.specs, self.opt_specs, self.shapes = specs, opt_specs, shapes
        self.layout = LocalLayout(self.plan, specs, trainer.bundle.config)
        self.leaf_layouts = {p: LeafLayout(self.plan, opt_specs[p], shapes[p])
                             for p in specs}
        self.zero_paths = [p for p in specs if opt_specs[p] != specs[p]]
        for p in self.zero_paths:
            if any(specs[p]):
                raise NotImplementedError(
                    f"{p}: optimizer state sharded further than its sharded "
                    f"param ({specs[p]} -> {opt_specs[p]}): {_PLAN_REST}")

    @classmethod
    def build(cls, trainer) -> "PlanState":
        plan, bundle = trainer.plan, trainer.bundle
        if bundle.apply_with_aux is not None:
            from ..models.moe import _EP_ITEM

            raise NotImplementedError(
                f"{bundle.name} under plan {plan.strategy!r}: a mixture of "
                f"experts under a sharding plan needs expert parallelism "
                f"({_EP_ITEM})")
        if trainer.loss_chunks > 0 or trainer.loss_fn is not causal_lm_loss:
            raise NotImplementedError(
                f"a chunked or custom loss under a sharding plan: "
                f"{_PLAN_REST}")
        mesh_type = plan.mesh.device_type
        if mesh_type != trainer.device.type:
            raise ValueError(f"the plan's mesh is on {mesh_type}, the "
                             f"trainer on {trainer.device}")
        mod = family_module(bundle.family)
        cfg = bundle.config
        axes, shapes = mod.param_logical_axes(cfg), mod.param_shapes(cfg)
        flat = lambda tree: dict(named_leaves(tree))   # noqa: E731
        return cls(trainer, flat(plan.param_specs(axes, shapes)),
                   flat(plan.optimizer_state_specs(axes, shapes)),
                   flat(shapes))

    # ---- the state ---------------------------------------------------------
    def fresh_state(self, params: dict, policy, optimizer,
                    rng: torch.Generator) -> TrainState:
        """This rank's shards of full ``params`` (already in the policy's
        storage) and a fresh optimizer state around them."""
        plan = self.plan
        if policy.quantize_moments:
            self._check_blocks(policy.block_size)
        local = {}
        for path, full in named_leaves(params):
            t = plan.shard(self.specs[path], full.detach()).contiguous()
            if t.numel() != full.numel():
                t = t.clone()
            local[path] = t.requires_grad_(True)
        update = {p: plan.shard(self.opt_specs[p], local[p].detach()).clone()
                  for p in self.zero_paths}
        leaves = [update.get(p, t) for p, t in local.items()]
        layouts = {update.get(p, t): self.leaf_layouts[p]
                   for p, t in local.items()}
        opt_state = optimizer.init(leaves, policy, layouts)
        return TrainState(step=0, params=_unflatten(local),
                          opt_state=opt_state, rng=rng,
                          sharding=StateShards(self, update))

    def _check_blocks(self, block: int) -> None:
        """adam8bit's blocks tile the trailing axis: a shard of it must
        hold whole blocks of the global tiling."""
        for path, spec in self.opt_specs.items():
            shape = self.shapes[path]
            if len(spec) < len(shape) or spec[-1] is None:
                continue
            local = self.plan.local_shape(spec, shape)[-1]
            if shape[-1] % block or local % block:
                raise NotImplementedError(
                    f"{path}: adam8bit blocks of {block} across a trailing "
                    f"axis of {shape[-1]} sharded to {local}: {_PLAN_REST}")

    # ---- the step ----------------------------------------------------------
    def _loss(self, params: dict, mb: dict) -> torch.Tensor:
        t = self.trainer
        cfg = t.bundle.config
        ids = mb["input_ids"]
        if self.layout.sp and ids.shape[1] % self.layout.tp:
            raise ValueError(f"sequence parallelism needs the sequence "
                             f"({ids.shape[1]}) divisible by tp "
                             f"({self.layout.tp})")
        hidden = t.bundle.apply(cfg, params, ids, remat=t.remat,
                                remat_policy=t.remat_policy,
                                attn_impl=t.attn_impl,
                                activation_sharding=self.layout,
                                return_hidden=True)
        return self.layout.loss(cfg, params, hidden, mb["labels"])

    @torch.no_grad()
    def _scatter(self, path: str, g: torch.Tensor) -> torch.Tensor:
        """ZeRO-2: a replicated param's microbatch grad reduce-scattered
        onto this rank's optimizer shard (outer axis first), and summed
        over the other axes its grad needs."""
        from ..ops import collectives as C
        from ..parallel.plans import entry_axes

        spec = self.opt_specs[path]
        done = set()
        for d, e in enumerate(spec):
            for a in entry_axes(e):
                g = C.reduce_scatter(g, self.plan.group(a), d)
                done.add(a)
        for a in self.layout.grad_axes(path):
            if a not in done:
                C.all_reduce_(g, self.plan.group(a))
        return g

    def step(self, state: TrainState, batch: dict) -> tuple:
        from ..ops import collectives as C
        from ..parallel.plans import global_norm

        t = self.trainer
        sh = state.sharding
        leaves = dict(named_leaves(state.params))
        for p in list(leaves.values()) + list(sh.update.values()):
            p.grad = None
        accum, n_acc = t.precision.accum_dtype, t.grad_accum
        zero2 = self.plan.zero2 and n_acc > 1
        bufs: dict = {}
        loss = torch.zeros((), dtype=torch.float32, device=t.device)
        for a in range(n_acc):
            mb = batch if n_acc == 1 else {k: v[a] for k, v in batch.items()}
            mb_loss = self._loss(state.params, mb)
            mb_loss.backward()
            loss = loss + mb_loss.detach()
            if n_acc == 1:
                continue
            for path, p in leaves.items():
                g = p.grad.to(accum)
                p.grad = None
                if zero2 and path in sh.update:
                    g = self._scatter(path, g)
                if path in bufs:
                    bufs[path].add_(g)
                else:
                    bufs[path] = g
        loss = loss / n_acc
        grads = []
        with torch.no_grad():
            for path, p in leaves.items():
                g = p.grad if n_acc == 1 else bufs.pop(path).div_(n_acc)
                if not (zero2 and path in sh.update):
                    for a in self.layout.grad_axes(path):
                        C.all_reduce_(g, self.plan.group(a))
                    if path in sh.update:
                        g = self.plan.shard(self.opt_specs[path],
                                            g).contiguous()
                grads.append(g)
                p.grad = None
        paths = list(leaves)
        if (t._nan_fault_step is not None
                and state.step == t._nan_fault_step):
            loss = torch.full_like(loss, float("nan"))
        metrics = {"loss": loss,
                   "grad_norm": global_norm(
                       grads, [self.leaf_layouts[p] for p in paths])}
        apply_update = True
        if t.guard_policy != "off":
            metrics, apply_update = apply_step_guard(t.guard_policy, metrics)
        if apply_update:
            opt = state.opt_state.optimizer
            if isinstance(opt, torch.optim.AdamW):
                for path, g in zip(paths, grads):
                    sh.update_leaf(path, leaves[path]).grad = g
                state.opt_state.step(norm=metrics["grad_norm"])
                for path in paths:
                    sh.update_leaf(path, leaves[path]).grad = None
            else:
                state.opt_state.step(grads, norm=metrics["grad_norm"])
            sh.gather_updates(state.params)
        state.step += 1
        return state, metrics
