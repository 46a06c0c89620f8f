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
summed over the ranks that hold partial sums of it. One step loop
(``Trainer._step``) runs with and without a plan: without one the layout
is the identity. ddp / zero1 / zero2: params replicated, grads all-reduced
over the data axes; zero1 shards the optimizer state by ``ZERO1_RULES``
(each rank updates its slice, then the params are all-gathered), zero2
also reduce-scatters the accumulation buffer; ``make_plan(...,
zero1=True)`` beside fsdp / tp / tp_fsdp cuts each slot from the param's
shards (``ShardingPlan.reshard``). fsdp: params sharded on embed / vocab,
each layer all-gathered just before it (again in the remat recompute),
grads reduce-scattered. tp: column-parallel wq / wk / wv / gate / up,
row-parallel wo / down, the residual's sequence on tp, the vocab-parallel
embedding and loss; where tp does not divide the heads or the MLP width,
that sublayer runs whole on every tp rank (``LocalLayout.whole_parts``).
tp_fsdp: both, on orthogonal axes. cp > 1 (chapter 08): each rank holds a
sequence shard (the loader's shifted ``targets`` beside it) and attention
is the ring or Ulysses over the cp group (``context_impl``; window,
Gemma-2's scale and softcap built in from the config), every grad summed
over cp. pp > 1 (chapter 09): the 1F1B schedule of
``parallel/pipeline.py`` (``pp_microbatches``, 2 pp by default) is the
value-and-grad, each stage holding its slice of the layers. A mixture of
experts (chapter 10) trains under every plan: ep / ep_fsdp put the experts
on ep; the dense dispatch runs the global program over the ranks
(``models/moe.py:dense_ep_dispatch``), the ragged one the expert exchange
(``make_ragged_ep_dispatch``, built once here where the JAX Trainer builds
it: pp 1, the experts' embed dim gathered inside it under ep_fsdp), which,
as in the JAX package, runs under neither cp, pp nor tp.
``overlap_schedule`` (``ops/overlap.py``; not under pp or cp) runs the
layers through a ``LayerSchedule`` (each layer's fsdp leaves gathered a
layer ahead and again for the backward), the loss through the fused
hidden->loss where ``fused_loss_supported`` allows it, and the ragged
exchange as the double-buffered ring; ``loss_chunks`` runs that fused
loss too, on one device and under every plan (on each rank's sequence
shard under cp, per microbatch on the last stage under pp).

A custom ``loss_fn`` under a plan reads the global ``[B, S, V]`` logits,
gathered on every rank over the axes that shard them (vocab over tp, rows
over the data axes, the sequence over cp; ``LocalLayout.global_logits``),
with the global labels: B x S x V fp32 on each rank (4.2 GB at B 4 x S 2048
x 128256), which the causal-LM loss never pays. Each rank's backward keeps
its own slice of the one cotangent, so the grad sums stay the plan's.

``offload_opt_state`` / ``offload_params`` keep the optimizer state /
params in host memory between steps (``train/offload.py``: fetched to the
device before each step and copied back after, the update unchanged); a
meta-device trainer (``device="meta"``) builds and steps a state that
allocates nothing, the preflight's (``train/preflight.py``).

``precision`` (``train/precision.py``) sets the storage: params in the
policy's dtype (or the model's, ``--param-dtype``), the optimizer state in
its form, and the gradient-accumulation buffer in ``accum_dtype``; the
optimizer computes in fp32 (``train/optimizer.py``). ``base_optimizer`` is
the spec without the policy: its fp32 layout is the restore target of a
checkpoint written before a run adopted a policy (``encode_fp32_state``).

Gradient accumulation sums the microbatch grads into buffers of the
policy's ``accum_dtype`` (each first microbatch's ``.grad`` itself where
the dtypes match) and divides by ``grad_accum``, as the JAX scan does. ``lora_only`` (a ``models/lora.py`` bundle) trains the adapters alone:
the optimizer holds only them, and the base leaves take no gradient. A
model with ``apply_with_aux`` (MoE) trains on ``ce +
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
from ..ops.cross_entropy import causal_lm_loss, validate_chunked_loss_support
from ..ops.remat import REMAT_POLICIES, resolve_remat_policy
from .guards import apply_step_guard, validate_guard_policy
from .offload import make_offload
from .precision import cast_floats, resolve_policy
from .state import TrainState, named_leaves

__all__ = ["POST_BASELINES", "POST_OBJECTIVES", "REMAT_POLICIES",
           "PlanState", "Trainer", "make_post_step", "post_loss"]

# the JAX package's chunked loss skips a final logit softcap, so its
# ``--loss-chunks`` trains another model there; the port refuses the case
_SOFTCAP_CHUNKS = ("ROADMAP.md queue 3, 'Found in the reference': the JAX "
                   "chunked loss drops final_logit_softcap")

CONTEXT_IMPLS = ("ring", "ulysses")


def _global_norm(grads: list) -> torch.Tensor:
    """The fp32 global L2 norm of a list of grads of any float dtype."""
    if all(g.dtype == torch.float32 for g in grads):
        norms = torch._foreach_norm(grads)
    else:
        norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
                 for g in grads]
    return torch.linalg.vector_norm(torch.stack(norms))


def _check_moe_dispatch(cfg, plan) -> None:
    """The JAX Trainer's refusals of an MoE dispatch under a plan: an
    unknown mode, and the ragged exchange under cp, pp or tp (its sorted
    groups are manual over the data axes only)."""
    mode = getattr(cfg, "moe_dispatch", None)
    if mode is None:
        return
    from ..models.moe import MOE_DISPATCH_MODES

    if mode not in MOE_DISPATCH_MODES:
        raise ValueError(f"unknown moe_dispatch {mode!r}; choose from "
                         f"{MOE_DISPATCH_MODES}")
    if mode != "ragged" or plan is None:
        return
    for axis, what in (("cp", "context"), ("pp", "pipeline"),
                       ("tp", "tensor")):
        if plan.sizes[axis] > 1:
            raise ValueError(
                f"moe_dispatch='ragged' under {what} parallelism is not "
                f"implemented (the sorted-group exchange runs over the "
                f"data axes only, as in the JAX package); use "
                f"moe_dispatch='dense' or {axis}=1")


def _overlap_parts(trainer, layout=None, model_layout=None) -> tuple:
    """(the layer schedule, the fused loss) of the overlap schedule and of
    ``loss_chunks`` (``ops/overlap.py``): the schedule over ``layout``'s
    fsdp leaves (None: one device, nothing gathered); the fused
    hidden->loss in ``loss_chunks`` chunks (8 by default) where
    ``fused_loss_supported`` allows it. Else the overlap schedule keeps
    the standard loss, as in the JAX Trainer. ``loss_chunks`` runs the
    fused loss under any plan's vocab layout (its head gathers what the
    spec shards), and refuses a final logit softcap: the JAX package's
    chunked loss computes an uncapped loss there (``_SOFTCAP_CHUNKS``)."""
    from ..ops.overlap import (fused_loss_supported, make_fused_loss,
                               make_layer_schedule)

    chunks = trainer.loss_chunks
    cfg = trainer.bundle.config
    family = family_module(trainer.bundle.family)
    schedule = fused = None
    if trainer.overlap_schedule:
        axes = dict(named_leaves(trainer.bundle.logical_axes()))
        schedule = make_layer_schedule(
            layout, axes, remat=trainer.remat,
            remat_policy=trainer.remat_policy, compute_dtype=cfg.dtype,
            fp32_leaves=getattr(family, "FP32_LAYER_LEAVES", frozenset()))
    if trainer.overlap_schedule or chunks > 0:
        why = fused_loss_supported(trainer.plan, cfg, family,
                                   trainer.loss_fn)
        if chunks > 0 and getattr(cfg, "final_logit_softcap", None):
            raise NotImplementedError(f"loss_chunks: {why} "
                                      f"({_SOFTCAP_CHUNKS})")
        if why is None or chunks > 0:
            fused = make_fused_loss(model_layout, num_chunks=chunks or 8,
                                    family_mod=family)
    return schedule, fused


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
    context_impl: str = "ring"  # cp > 1 attention: "ring" or "ulysses"
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
        if self.context_impl not in CONTEXT_IMPLS:
            raise ValueError(f"unknown context_impl {self.context_impl!r}; "
                             f"use 'ring' or 'ulysses'")
        cfg = self.bundle.config
        if callable(self.attn_impl) and (
                getattr(cfg, "attn_logit_softcap", None) is not None
                or getattr(cfg, "query_pre_attn_scalar", None)
                or ((getattr(cfg, "layer_windows", None)
                     or getattr(cfg, "sliding_window", None))
                    and not getattr(self.attn_impl, "accepts_window",
                                    False))):
            # a user-supplied callable's contract carries no softcap or
            # scale (the Trainer-built ring and Ulysses bake them in from
            # the config), so Gemma-2's extras would be dropped silently
            raise ValueError(
                "a user-supplied attn_impl callable cannot receive the "
                "configured attention extras (attn_logit_softcap / "
                "query_pre_attn_scalar / sliding_window / layer_windows): "
                "they would be silently dropped; use attn_impl='auto' or "
                "'xla', or set accepts_window=True on a callable that "
                "takes the per-call window")
        from ..models.lora import is_lora

        self.lora = is_lora(self.bundle)
        if self.lora_only and not self.lora:
            raise ValueError(
                "lora_only=True needs a lora_bundle-wrapped bundle "
                "(models/lora.py): this bundle has no adapters to restrict "
                "the optimizer to")
        if self.loss_chunks > 0:
            validate_chunked_loss_support(family_module(self.bundle.family),
                                          self.bundle.family, self.loss_fn)
        _check_moe_dispatch(cfg, self.plan)
        if self.overlap_schedule:
            self._check_overlap()
        self.device = resolve_device(self.device)
        from ..utils.faults import active_faults

        self._nan_fault_step = active_faults().nan_loss_step
        self.layer_schedule = self.fused_loss = None
        if self.plan is None:
            self.layer_schedule, self.fused_loss = _overlap_parts(self)
        self.plan_state = (None if self.plan is None
                           else PlanState.build(self))

    def _check_overlap(self) -> None:
        """The JAX Trainer's refusals of the overlap schedule: under pp and
        cp, for a family whose apply takes no ``layer_schedule``, and for a
        bundle without the stacked ``params["layers"]`` (LoRA)."""
        import inspect

        if self.plan is not None and self.plan.sizes["pp"] > 1:
            raise ValueError(
                "--overlap-schedule cannot run under pipeline parallelism: "
                "the pipeline runs its own 1F1B schedule of the stages' "
                "layers; use dp/fsdp/tp/ep plans")
        if self.plan is not None and self.plan.sizes["cp"] > 1:
            raise ValueError(
                "--overlap-schedule under context parallelism is not "
                "implemented (the ring / Ulysses attention is its own "
                "exchange schedule, and the fused loss has no cp-sharded "
                "sequence form); use cp=1")
        apply = self.bundle.apply_with_aux or self.bundle.apply
        sig = inspect.signature(apply).parameters
        if not ("layer_schedule" in sig
                or any(p.kind is inspect.Parameter.VAR_KEYWORD
                       for p in sig.values())):
            raise ValueError(
                f"--overlap-schedule: family {self.bundle.family!r} apply "
                f"does not take a layer_schedule")
        if "layers" not in self.bundle.shapes():
            raise ValueError(
                "--overlap-schedule needs the family's stacked "
                "params['layers'] layout; wrapped bundles (LoRA) are not "
                "supported")

    # ---- init --------------------------------------------------------------
    def _fresh_state(self, params, seed: int, policy=None,
                     optimizer=None, sharded: bool = False) -> TrainState:
        policy = self.precision if policy is None else policy
        params = policy.cast_params(params)
        # a meta trainer (the preflight) keeps a CPU generator: meta has none
        rng = torch.Generator(device="cpu" if self.device.type == "meta"
                              else self.device)
        rng.manual_seed(int(seed))
        if self.plan_state is not None:
            state = self.plan_state.fresh_state(
                params, policy, optimizer or self.optimizer, rng, sharded)
        else:
            leaves = []
            for path, t in named_leaves(params):
                t.requires_grad_(self.trains(path))
                if self.trains(path):
                    leaves.append(t)
            opt_state = (optimizer or self.optimizer).init(leaves, policy)
            state = TrainState(step=0, params=params, opt_state=opt_state,
                               rng=rng)
        state.offload = make_offload(self.device,
                                     params=self.offload_params,
                                     opt_state=self.offload_opt_state)
        if state.offload is not None:
            state.offload.release(state)     # to the host until a step
        return state

    def init_state(self, seed: int) -> TrainState:
        """Random init from ``seed``, on the trainer's device, stored under
        the precision policy."""
        cfg = self.bundle.config
        return self._fresh_state(
            self.bundle.init(cfg, seed, device=self.device), seed)

    def init_state_from_params(self, params, seed: int = 0, *,
                               sharded: bool = False) -> TrainState:
        """Fresh optimizer state around given params (copied to the
        trainer's device, so the caller's tensors are never updated).
        ``sharded``: under a plan, ``params`` are already this rank's
        shards (``models/hf_convert.py:load_pretrained(bundle, plan,
        ...)``), not whole leaves."""
        return self._fresh_state(
            _map(params, lambda t: t.detach().to(self.device, copy=True)),
            seed, sharded=sharded)

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
        carried over. Under a plan ``state32`` is this rank's shards (the
        plan's ``fp32_reference_state``), and each rank encodes its own:
        the result is the unsharded re-encoding's shards."""
        if self.precision.is_noop:
            return state32
        ps = self.plan_state
        state = self._fresh_state(
            _map(state32.params, lambda t: t.detach()), 0,
            sharded=ps is not None)
        opt32 = state32.opt_state.optimizer
        opt = state.opt_state.optimizer
        policy = self.precision
        sh32, sh = state32.sharding, state.sharding
        for (path, p32), (_, p) in zip(named_leaves(state32.params),
                                       named_leaves(state.params)):
            if not self.trains(path):
                continue
            if ps is not None:
                # each rank encodes its own shards; a quantized moment's
                # block scales line up with them, or are the global
                # leaf's where its shards split a block (JAX's ``.scale``
                # rule: the block axis replicated)
                p32, p = sh32.update_leaf(path, p32), sh.update_leaf(path, p)
            layout = None if ps is None else ps.leaf_layouts[path]
            opt.state[p] = {k: policy.store_moment(v.float(), opt.SLOTS[k],
                                                   layout)
                            for k, v in opt32.state[p32].items()
                            if k != "step"}
        count = state32.opt_state.count
        state.opt_state.set_count(count)
        if hasattr(opt, "count"):
            opt.count = count
        state.step = state32.step
        state.rng.set_state(state32.rng.get_state())
        return state

    def trains(self, path: str) -> bool:
        """Whether the optimizer holds the leaf at ``path``: every leaf, or
        under ``lora_only`` the adapters alone (the base takes no grad)."""
        return not self.lora_only or path.startswith("lora/")

    # ---- the step ----------------------------------------------------------
    def _loss(self, params, mb: dict) -> tuple:
        """(loss, extra metrics) of one microbatch, the step loop's default
        hook; the extras are detached fp32 scalars. Under a plan the
        plan's (``PlanState.loss``)."""
        if self.plan_state is not None:
            return self.plan_state.loss(params, mb)
        cfg = self.bundle.config
        fused = self.fused_loss
        kw = dict(positions=mb.get("positions"), remat=self.remat,
                  remat_policy=self.remat_policy, attn_impl=self.attn_impl,
                  return_hidden=fused is not None)
        if self.layer_schedule is not None:
            kw["layer_schedule"] = self.layer_schedule
        extras, aux_loss = {}, None
        if self.bundle.apply_with_aux is not None:
            out, aux, extras = self.bundle.apply_with_aux(
                cfg, params, mb["input_ids"], return_metrics=True, **kw)
            aux_loss = getattr(cfg, "router_aux_coef", 0.0) * aux
            extras = {k: v.detach() for k, v in extras.items()}
        else:
            out = self.bundle.apply(cfg, params, mb["input_ids"], **kw)
        if fused is not None:
            loss = fused(cfg, params["base"] if self.lora else params, out,
                         mb["labels"])
        else:
            loss = self.loss_fn(out, mb["labels"])
        return (loss if aux_loss is None else loss + aux_loss), extras

    def step_fn(self, state: TrainState, batch: dict) -> tuple:
        """One optimizer step on ``batch`` ({"input_ids", "labels"}
        [B, S], or [A, B, S] under grad accumulation). Updates ``state`` in
        place and returns (state, {"loss", "grad_norm"[, "notfinite"]}),
        the metrics as fp32 device scalars. Under a plan ``batch`` holds
        this rank's rows (``data/loader.py``). An offloaded state
        (``offload_params`` / ``offload_opt_state``) is fetched to the
        device first and copied back to the host after (``train/
        offload.py``); read it on the host only after
        ``state.offload.wait()``."""
        return self._run(state, batch)

    def _run(self, state: TrainState, batch: dict, loss_hook=None,
             n_acc: int = None) -> tuple:
        """``_step`` around an offloaded state's fetch and release."""
        off = state.offload
        if off is None:
            return self._step(state, batch, loss_hook, n_acc)
        off.fetch(state)
        try:
            return self._step(state, batch, loss_hook, n_acc)
        finally:
            off.release(state)

    def _step(self, state: TrainState, batch: dict, loss_hook=None,
              n_acc: int = None) -> tuple:
        """The one step loop, with or without a plan: each of ``n_acc``
        microbatches' loss (``loss_hook(params, mb) -> (loss, extras)``;
        by default ``_loss``, the causal-LM or custom loss) and its
        backward (under pp the pipeline's value-and-grad instead), the
        grads popped into fp32 (``accum_dtype``) buffers between
        microbatches (reduce-scattered onto the optimizer's shard per
        microbatch under zero2), then each grad summed over its leaf's grad
        axes and cut to the optimizer's shard, the global norm, the NaN
        drill, the guard and one optimizer step. Without a plan the layout
        is the identity: no collective, every leaf whole."""
        ps = self.plan_state
        n_acc = self.grad_accum if n_acc is None else n_acc
        mb_loss = self._loss if loss_hook is None else loss_hook
        sh = state.sharding
        update = {} if sh is None else sh.update
        leaves = {path: p for path, p in named_leaves(state.params)
                  if self.trains(path)}
        for p in list(leaves.values()) + list(update.values()):
            p.grad = None
        accum = self.precision.accum_dtype
        zero2 = ps is not None and self.plan.zero2 and n_acc > 1
        pipeline = None if ps is None else ps.pipeline
        bufs: dict = {}
        extras: dict = {}
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for a in range(n_acc):
            mb = batch if n_acc == 1 else {k: v[a] for k, v in batch.items()}
            if pipeline is not None:
                mb_l = ps.pipeline_backward(state.params, leaves, mb)
            else:
                mb_l, mb_extras = mb_loss(state.params, mb)
                mb_l.backward()
                for k, v in mb_extras.items():
                    extras[k] = extras.get(k, 0.0) + v / n_acc
            loss = loss + mb_l.detach()
            if n_acc == 1:
                continue
            for path, p in leaves.items():
                g = p.grad.to(accum)
                p.grad = None
                if zero2 and path in update:
                    g = ps.scatter(path, g)
                if path in bufs:
                    bufs[path].add_(g)
                else:
                    bufs[path] = g
        loss = loss / n_acc
        paths = list(leaves)
        grads = []
        # without a plan each leaf keeps its grad after the step (in its
        # own dtype), as a plain torch loop does; a plan's are transient
        keep = ps is None
        with torch.no_grad():
            for path, p in leaves.items():
                g = p.grad if n_acc == 1 else bufs.pop(path).div_(n_acc)
                if ps is not None:
                    g = ps.reduce_grad(path, g, zero2 and path in update)
                grads.append(g)
                p.grad = g if keep and g.dtype == p.dtype else None
        if ps is None:
            norm = _global_norm(grads)
        else:
            from ..parallel.plans import global_norm

            norm = global_norm(grads, [ps.leaf_layouts[p] for p in paths])
        if (self._nan_fault_step is not None
                and state.step == self._nan_fault_step):
            loss = torch.full_like(loss, float("nan"))
        metrics = {"loss": loss.to(torch.float32), "grad_norm": norm,
                   **{k: v.to(torch.float32) for k, v in extras.items()}}
        apply_update = True
        if self.guard_policy != "off":
            metrics, apply_update = apply_step_guard(self.guard_policy,
                                                     metrics)
        if apply_update:
            # without a plan the clip takes the norm of the grads it is
            # handed (as optax does); under a plan the global one
            clip_norm = None if ps is None else metrics["grad_norm"]
            opt = state.opt_state.optimizer
            if isinstance(opt, torch.optim.AdamW):
                for path, g in zip(paths, grads):
                    update.get(path, leaves[path]).grad = g
                state.opt_state.step(norm=clip_norm)
                if not keep:
                    for path in paths:
                        update.get(path, leaves[path]).grad = None
            else:
                state.opt_state.step(grads, norm=clip_norm)
            if sh is not None:
                sh.gather_updates(state.params)
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
    update shard of each param whose optimizer state is laid out otherwise
    than the param (ZeRO: the optimizer steps the shard, then the params
    are gathered back; beside fsdp or tp the shard is cut from the
    param's shards, ``ShardingPlan.reshard``), and the DTensor form of
    each tensor for checkpoints."""

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
        from .precision import straddles_shards

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
            if straddles_shards(ps.leaf_layouts[path], opt.policy.block_size):
                # quantize_sharded's global scales: whole on every rank
                spec = spec[:-1] + (None,)
                shape = shape[:-1] + (t.shape[-1],)
            else:
                n = math.prod(ps.plan.sizes[a]
                              for a in entry_axes(spec[-1]))
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
            flat[path].copy_(ps.plan.reshard(u, ps.opt_specs[path],
                                             ps.specs[path]))

    @torch.no_grad()
    def reshard_update_leaves(self, state: TrainState) -> None:
        """Refresh the update shards from the params (after a restore,
        which fills the params)."""
        ps = self.plan_state
        flat = dict(named_leaves(state.params))
        for path, u in self.update.items():
            u.copy_(ps.plan.reshard(flat[path], ps.specs[path],
                                    ps.opt_specs[path]))


class PlanState:
    """A Trainer's layout under a sharding plan: every leaf's spec (the
    plan's rules) and that of its optimizer state, the ``LocalLayout`` the
    forward runs on, the microbatch loss, and the grad collectives the
    Trainer's one step loop (``Trainer._step``) calls. It holds no
    accumulation, guard or optimizer code of its own."""

    def __init__(self, trainer, specs: dict, opt_specs: dict, shapes: dict):
        from ..parallel.plans import LeafLayout, LocalLayout

        self.trainer = trainer
        self.plan = trainer.plan
        self.specs, self.opt_specs, self.shapes = specs, opt_specs, shapes
        # a LoRA bundle's model is its "base" subtree; its adapters sum
        # over tp the grads a rank holds partially (parallel/plans.py)
        partners = None
        if trainer.lora:
            from ..models.lora import lora_partners

            partners = lora_partners(trainer.bundle)
        self.layout = LocalLayout(self.plan, specs, trainer.bundle.config,
                                  family_module(
                                      trainer.bundle.family).LAYOUT_PATHS,
                                  model="base" if trainer.lora else "",
                                  partners=partners)
        self.model_layout = (self.layout.scoped("base") if trainer.lora
                             else self.layout)
        self.leaf_layouts = {p: LeafLayout(self.plan, opt_specs[p], shapes[p])
                             for p in specs}
        self.zero_paths = [p for p in specs if opt_specs[p] != specs[p]
                           and trainer.trains(p)]
        self.zero_set = frozenset(self.zero_paths)
        self.custom_loss = trainer.loss_fn is not causal_lm_loss
        self.cp, self.pp = self.plan.sizes["cp"], self.plan.sizes["pp"]
        self.attn_impl = self._attention(trainer)
        self.moe_ep = self._moe_ep(trainer)
        self.layer_schedule, self.fused_loss = _overlap_parts(
            trainer, self.layout, self.model_layout)
        self.pipeline = None
        if self.pp > 1:
            from ..parallel.pipeline import Pipeline

            # under cp every tick runs on every member, masked (JAX's
            # run_all)
            self.pipeline = Pipeline(
                trainer.bundle, self.plan.exchange("pp"),
                microbatches=trainer.pp_microbatches, layout=self.layout,
                attn_impl=self.attn_impl, remat=trainer.remat,
                remat_policy=trainer.remat_policy, run_all=self.cp > 1,
                data_size=self.plan.data_parallel_size,
                head_loss=self._pipeline_head_loss())

    def _attention(self, trainer):
        """The attention the forward runs: the trainer's, or under cp > 1
        the ring or Ulysses over this rank's cp group, with the config's
        window, Gemma-2 score scale and softcap built in (the JAX
        Trainer's ``step_fn``)."""
        if self.cp == 1 or callable(trainer.attn_impl):
            return trainer.attn_impl
        from ..models.llama import attention_extras

        cfg = trainer.bundle.config
        scale, softcap = attention_extras(cfg)
        window = getattr(cfg, "sliding_window", None)
        exchange = self.plan.exchange("cp")
        if trainer.context_impl == "ulysses":
            from ..ops.ulysses_attention import make_ulysses_attention

            impl = trainer.attn_impl
            if self.pp > 1:
                # the JAX pipeline nests only Ulysses' flash path
                if impl == "xla":
                    raise ValueError(
                        "attn_impl='xla' cannot run Ulysses inside the "
                        "pipeline (the JAX package's refusal: its xla path "
                        "names the concrete mesh); drop --attn-impl, or use "
                        "--context-impl ring")
                impl = "flash"
            return make_ulysses_attention(exchange, window=window, impl=impl,
                                          scale=scale, logit_softcap=softcap)
        from ..ops.ring_attention import make_ring_attention

        return make_ring_attention(exchange, window=window, scale=scale,
                                   logit_softcap=softcap)

    def _moe_ep(self, trainer):
        """The ragged expert exchange the forward threads to every MoE
        layer (the JAX Trainer's ``moe_ep``): over this rank's ep group,
        gathering the experts' embed dim over fsdp when fsdp shards it;
        None for the dense dispatch, under pp, and where no axis is wider
        than one rank."""
        cfg = trainer.bundle.config
        if (trainer.bundle.apply_with_aux is None or self.pp > 1
                or getattr(cfg, "moe_dispatch", "dense") != "ragged"):
            return None
        from ..models.moe import EXPERT_LEAVES, make_ragged_ep_dispatch

        sizes = self.plan.sizes
        embed = (self.plan.exchange("fsdp")
                 if sizes["fsdp"] > 1 and self.plan.rules.get("embed")
                 == "fsdp" else None)
        ep = self.plan.exchange("ep") if sizes["ep"] > 1 else None
        moe_ep = make_ragged_ep_dispatch(ep, cfg, embed=embed,
                                         overlap=trainer.overlap_schedule)
        if moe_ep is not None and moe_ep.embed is not None:
            self.layout.gathered_by_dispatch = frozenset(
                f"layers/moe/{k}" for k in EXPERT_LEAVES)
        return moe_ep

    @classmethod
    def build(cls, trainer) -> "PlanState":
        plan, bundle = trainer.plan, trainer.bundle
        if plan.sizes["pp"] > 1 and plan.sizes["tp"] > 1:
            _check_pp_tp(trainer)
        mesh_type = plan.mesh.device_type
        # a meta trainer runs on any mesh (the preflight's fake group)
        if mesh_type != trainer.device.type and trainer.device.type != "meta":
            raise ValueError(f"the plan's mesh is on {mesh_type}, the "
                             f"trainer on {trainer.device}")
        axes, shapes = bundle.logical_axes(), bundle.shapes()
        flat = lambda tree: dict(named_leaves(tree))   # noqa: E731
        return cls(trainer, flat(plan.param_specs(axes, shapes)),
                   flat(plan.optimizer_state_specs(axes, shapes)),
                   flat(shapes))

    # ---- the state ---------------------------------------------------------
    def fresh_state(self, params: dict, policy, optimizer,
                    rng: torch.Generator,
                    sharded: bool = False) -> TrainState:
        """This rank's shards of full ``params`` (already in the policy's
        storage; ``sharded``: already this rank's shards) and a fresh
        optimizer state around them."""
        plan = self.plan
        trains = self.trainer.trains
        local, update = {}, {}
        for path, full in named_leaves(params):
            if path in self.zero_set:
                # the optimizer's shard, from the whole leaf or (given
                # shards) from the param's shards
                update[path] = plan.reshard(
                    full.detach(), self.specs[path] if sharded else (),
                    self.opt_specs[path]).clone()
            if sharded:
                want = plan.local_shape(self.specs[path], self.shapes[path])
                if tuple(full.shape) != want:
                    raise ValueError(f"{path}: shard {tuple(full.shape)}, "
                                     f"the plan's {want}")
                local[path] = full.detach().requires_grad_(trains(path))
                continue
            t = plan.shard(self.specs[path], full.detach()).contiguous()
            if t.numel() != full.numel():
                t = t.clone()
            else:   # the whole leaf, not a view of it: a view's base
                t = full.detach()   # would keep the storage an offload moves
            local[path] = t.requires_grad_(trains(path))
        leaves = [update.get(p, t) for p, t in local.items() if trains(p)]
        layouts = {update.get(p, t): self.leaf_layouts[p]
                   for p, t in local.items() if trains(p)}
        opt_state = optimizer.init(leaves, policy, layouts)
        return TrainState(step=0, params=_unflatten(local),
                          opt_state=opt_state, rng=rng,
                          sharding=StateShards(self, update))

    # ---- the microbatch loss -------------------------------------------
    def _labels(self, mb: dict) -> torch.Tensor:
        """The microbatch's labels, or under cp its shifted targets."""
        if self.cp == 1:
            return mb["labels"]
        if "targets" not in mb:
            raise ValueError(
                "under context parallelism the batch holds each rank's "
                "sequence shard and its targets, shifted before the "
                "sequence was sharded ({'input_ids', 'targets'}: "
                "data/loader.py:local_batch, or the loader's seq_size)")
        return mb["targets"]

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of a global [B, S] batch: its rows (the data
        ranks split B), and under cp its contiguous sequence shard."""
        from ..data.loader import seq_shard

        data = self.plan.data_parallel_size
        if x.shape[0] % data:
            raise ValueError(f"a global batch of {x.shape[0]} rows does not "
                             f"split over {data} data ranks")
        n = x.shape[0] // data
        x = x[self.plan.data_rank * n:(self.plan.data_rank + 1) * n]
        if self.cp > 1:
            x = seq_shard(x, self.layout.cp_rank, self.cp)
        return x

    def _global_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """The global [B, S] labels from this rank's rows (and under cp
        its sequence shard of the unshifted labels)."""
        with torch.no_grad():
            return self.layout.global_rows(labels)

    def forward(self, params: dict, ids: torch.Tensor,
                with_aux: bool = True) -> tuple:
        """(final hidden, the router aux loss or None, extras) of this
        rank's ``ids``: the plan's forward on local tensors; an MoE model's
        aux and ``moe_dropped_frac`` global over the ranks."""
        t = self.trainer
        cfg = t.bundle.config
        if self.layout.sp and ids.shape[1] % self.layout.tp:
            raise ValueError(f"sequence parallelism needs the sequence "
                             f"({ids.shape[1]}) divisible by tp "
                             f"({self.layout.tp})")
        kw = dict(remat=t.remat, remat_policy=t.remat_policy,
                  attn_impl=self.attn_impl, activation_sharding=self.layout,
                  return_hidden=True)
        if self.layer_schedule is not None:
            kw["layer_schedule"] = self.layer_schedule
        if with_aux and t.bundle.apply_with_aux is not None:
            hidden, aux, extras = t.bundle.apply_with_aux(
                cfg, params, ids, return_metrics=True, moe_ep=self.moe_ep,
                **kw)
            return (hidden, getattr(cfg, "router_aux_coef", 0.0) * aux,
                    {k: v.detach() for k, v in extras.items()})
        return t.bundle.apply(cfg, params, ids, **kw), None, {}

    def global_logits(self, model: dict, hidden: torch.Tensor):
        """The fp32 logits [B, S, V] of the global batch on every rank,
        gathered from this rank's (``LocalLayout.global_logits``): what a
        custom loss and the post-training loss read. Each rank's backward
        keeps its own slice of the one cotangent."""
        layout = self.model_layout
        cfg = self.trainer.bundle.config
        return layout.global_logits(layout.logits(cfg, model, hidden))

    def loss(self, params: dict, mb: dict) -> tuple:
        """(the global loss, extra metrics) of one microbatch: the
        causal-LM loss (vocab-parallel, or fused under ``loss_chunks``), or
        a custom ``loss_fn`` on the gathered global logits and labels; an
        MoE model's loss is ``ce + router_aux_coef * aux``."""
        t = self.trainer
        cfg = t.bundle.config
        hidden, aux_loss, extras = self.forward(params, mb["input_ids"])
        model = params["base"] if t.lora else params
        if self.fused_loss is not None:
            loss = self.fused_loss(cfg, model, hidden, self._labels(mb))
        elif self.custom_loss:
            loss = t.loss_fn(self.global_logits(model, hidden),
                             self._global_labels(self._custom_labels(mb)))
        else:
            loss = self.model_layout.loss(cfg, model, hidden,
                                          self._labels(mb))
        return (loss if aux_loss is None else loss + aux_loss), extras

    def _custom_labels(self, mb: dict) -> torch.Tensor:
        if "labels" not in mb:
            raise ValueError(
                "a custom loss_fn under context parallelism reads the "
                "unshifted labels: the batch must hold each rank's sequence "
                "shard of them beside the targets ('labels': "
                "data/loader.py:local_batch)")
        return mb["labels"]

    def _pipeline_head_loss(self):
        """The last stage's loss of one microbatch (``Pipeline``'s
        ``head_loss``): the fused loss under ``loss_chunks`` (vocab not on
        tp), a custom loss on the microbatch's gathered logits, or None for
        the plan's causal-LM loss."""
        cfg = self.trainer.bundle.config
        if self.fused_loss is not None:
            return lambda nl, h, labels: self.fused_loss(cfg, nl, h, labels)
        if self.custom_loss:
            return lambda nl, h, labels: self.trainer.loss_fn(
                self.global_logits(nl, h), self._global_labels(labels))
        return None

    def pipeline_backward(self, params: dict, leaves: dict,
                          mb: dict) -> torch.Tensor:
        """The pipeline's value-and-grad on one (accumulation) microbatch:
        its grads added into each leaf's ``.grad`` (as ``backward`` would),
        its loss summed over the stages (the last stage's)."""
        from ..ops import collectives as C

        labels = (self._custom_labels(mb) if self.custom_loss
                  else self._labels(mb))
        loss, (grads,) = self.pipeline.value_and_grad(
            [params], mb["input_ids"], labels)
        for path, p in leaves.items():
            g = grads.get(path)
            if g is None:
                g = torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
            g = g.to(p.dtype)
            p.grad = g if p.grad is None else p.grad + g
        return C.all_reduce_(loss, self.plan.group("pp"))

    # ---- the grad collectives ----------------------------------------------
    @torch.no_grad()
    def scatter(self, path: str, g: torch.Tensor) -> torch.Tensor:
        """ZeRO-2: a microbatch grad onto this rank's optimizer shard. A
        replicated param's is reduce-scattered (outer axis first) and
        summed over the other axes its grad needs; a sharded param's (fsdp
        or tp beside ZeRO) is summed over its grad axes and cut to the
        optimizer's shard."""
        from ..ops import collectives as C
        from ..parallel.plans import entry_axes

        if any(self.specs[path]):
            return self.reduce_grad(path, g, False)
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

    @torch.no_grad()
    def reduce_grad(self, path: str, g: torch.Tensor,
                    scattered: bool) -> torch.Tensor:
        """A leaf's summed grad as the optimizer steps it: summed over the
        leaf's grad axes, then cut to its optimizer shard under ZeRO
        (``scattered``: zero2 did both per microbatch)."""
        from ..ops import collectives as C

        if scattered:
            return g
        for a in self.layout.grad_axes(path):
            C.all_reduce_(g, self.plan.group(a))
        if path in self.zero_set:
            g = self.plan.reshard(g, self.specs[path],
                                  self.opt_specs[path]).contiguous()
        return g


def _check_pp_tp(trainer) -> None:
    """The JAX pipeline's refusals under pp x tp
    (``distributed_training_guide_tpu/parallel/pipeline.py``): a custom
    loss, ``loss_chunks``, and heads or a vocab that tp does not divide."""
    tp = trainer.plan.sizes["tp"]
    cfg = trainer.bundle.config
    if trainer.loss_fn is not causal_lm_loss:
        raise NotImplementedError(
            "pp x tp hardwires the vocab-parallel causal-LM loss; drop "
            "the custom loss_fn or tp")
    if trainer.loss_chunks > 0:
        raise NotImplementedError(
            "loss_chunks is redundant under pp x tp: the vocab-parallel "
            "head already never materializes full logits")
    n_kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
    if n_kv % tp or cfg.num_heads % tp:
        raise ValueError(f"num_heads={cfg.num_heads}/num_kv_heads="
                         f"{n_kv} not divisible by tp={tp}")
    if cfg.vocab_size % tp:
        raise ValueError(
            f"vocab_size={cfg.vocab_size} not divisible by tp={tp}: the "
            f"manual vocab-parallel embed/head needs equal vocab shards "
            f"(gpt2's 50257 never divides — pad the vocab, e.g. "
            f"vocab_size=50304, or run pp with tp=1)")


# ---------------------------------------------------------------------------
# Post-training: masked ragged rollout objectives (post/loop.py's update)
# ---------------------------------------------------------------------------

POST_OBJECTIVES = ("reinforce", "distill_kl")
POST_BASELINES = ("batch", "group", "none")


def _pack_ragged(values: torch.Tensor, prompt_lens: torch.Tensor,
                 group_sizes: torch.Tensor, s: int) -> tuple:
    """Pack per-token values of B ragged continuations into ONE [M, 1]
    buffer in group order, the ``ops/grouped_matmul.py`` row layout.

    ``values`` is [B, S] (a value per SOURCE position: the logits row that
    predicts the next token); continuation g occupies packed rows
    ``offs[g-1]:offs[g]``, reading source positions ``prompt_lens[g]-1 ..
    prompt_lens[g]-1+group_sizes[g]-1``. Rows past ``sum(group_sizes)`` are
    zero, the tail K5 gives zeros (and zero grads) for, so the static
    packed width B * (S - 1) carries no pad into the objective. Returns
    (packed [M, 1], group index per row [M], valid mask [M])."""
    b = values.shape[0]
    m_pad = b * (s - 1)
    sizes = group_sizes.to(torch.int64)
    offs = torch.cumsum(sizes, 0)
    starts = offs - sizes
    rows = torch.arange(m_pad, device=values.device)
    g = torch.searchsorted(offs, rows, right=True).clamp(0, b - 1)
    j = rows - starts[g]
    valid = rows < offs[-1]
    src = (prompt_lens.to(torch.int64)[g] - 1 + j).clamp(0, s - 2)
    packed = torch.where(valid, values.reshape(-1)[g * s + src], 0.0)
    return packed[:, None], g, valid


def post_loss(logits: torch.Tensor, tokens: torch.Tensor,
              prompt_lens: torch.Tensor, total_lens: torch.Tensor, *,
              objective: str = "reinforce", advantages=None,
              teacher_logprobs=None, gmm_impl: str = "auto") -> tuple:
    """The one post-training loss: REINFORCE with a baseline and
    distillation KL over RAGGED variable-length rollouts.

    ``tokens`` is [B, S] (prompt + sampled continuation, zero-padded);
    source position p carries gradient iff it predicts a SAMPLED token,
    ``prompt_lens[b]-1 <= p < total_lens[b]-1``, so prompt tokens and the
    pad tail give exactly zero loss and zero gradient. The per-token values
    pack into one [M, 1] buffer with ``group_sizes`` = the continuation
    lengths, and the per-sequence scalar (the advantage, or the KL's
    1 / length) rides ``rhs`` [B, 1, 1]: one grouped GEMM (K5 at K = N = 1
    on the card) broadcasts it onto its ragged block, and its backward is
    K5's d_lhs against ``rhs^T``. The scalars take no gradient, so K6 never
    runs here.

    - ``reinforce``: loss = -(1/B) sum_b adv_b * sum_t log pi(y_t | ...).
    - ``distill_kl``: loss = (1/B) sum_b (1/|y_b|) sum_t
      KL(teacher_t || student_t), the teacher's full-vocab log-probs
      aligned at source positions (``teacher_logprobs`` [B, S, V]).

    Returns (loss, extras): ``post_tokens`` and ``post_logprob_mean``,
    detached fp32 scalars."""
    from ..ops.grouped_matmul import grouped_matmul

    if objective not in POST_OBJECTIVES:
        raise ValueError(f"unknown post objective {objective!r}; choose "
                         f"from {POST_OBJECTIVES}")
    b, s, _ = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    group_sizes = (total_lens - prompt_lens).to(torch.int32)
    # token logprob at source position p (predicting tokens[:, p+1]); the
    # last column has no next token: zero, never packed
    tok_lp = torch.gather(logp[:, :-1], 2,
                          tokens[:, 1:, None].to(torch.int64))[..., 0]
    tok_lp = torch.nn.functional.pad(tok_lp, (0, 1))
    packed_lp, _, _ = _pack_ragged(tok_lp, prompt_lens, group_sizes, s)
    n_tok = group_sizes.sum().clamp(min=1)
    extras = {
        "post_tokens": group_sizes.sum().to(torch.float32),
        "post_logprob_mean": (packed_lp.detach().sum() / n_tok).to(
            torch.float32),
    }
    if objective == "reinforce":
        if advantages is None:
            raise ValueError("objective='reinforce' needs advantages")
        adv = advantages.detach().to(torch.float32)
        out = grouped_matmul(packed_lp, adv[:, None, None], group_sizes,
                             impl=gmm_impl)
        return -out.sum() / b, extras
    if teacher_logprobs is None:
        raise ValueError("objective='distill_kl' needs teacher_logprobs "
                         "[B, S, V] aligned at source positions")
    t_lp = teacher_logprobs.detach().to(torch.float32)
    kl_tok = torch.sum(torch.exp(t_lp) * (t_lp - logp), dim=-1)   # [B, S]
    packed_kl, _, _ = _pack_ragged(kl_tok, prompt_lens, group_sizes, s)
    inv_len = 1.0 / group_sizes.to(torch.float32).clamp(min=1.0)
    out = grouped_matmul(packed_kl, inv_len[:, None, None], group_sizes,
                         impl=gmm_impl)
    return out.sum() / b, extras


def _advantages(rewards: torch.Tensor, group_ids: torch.Tensor,
                baseline: str) -> torch.Tensor:
    """The per-rollout advantage under ``baseline``: "batch" subtracts the
    batch-mean reward; "group" is GRPO's (arXiv:2402.03300)
    (r - mean_g) / (std_g + 1e-4) over rollouts sharing a prompt; "none"
    the raw reward."""
    if baseline == "batch":
        return rewards - rewards.mean()
    if baseline == "group":
        b = rewards.shape[0]
        gids = group_ids.to(torch.int64)
        onehot = (gids[:, None] == torch.arange(
            b, device=rewards.device)[None, :]).to(torch.float32)
        cnt = onehot.sum(dim=0).clamp(min=1.0)
        mean_g = (rewards @ onehot) / cnt
        var_g = ((rewards ** 2) @ onehot) / cnt - mean_g ** 2
        return ((rewards - mean_g[gids])
                / (torch.sqrt(var_g[gids].clamp(min=0.0)) + 1e-4))
    return rewards


def make_post_step(trainer: Trainer, *, objective: str = "reinforce",
                   baseline: str = "batch", gmm_impl: str = "auto"):
    """The post-training step for a Trainer: ``post_step(state, batch)``
    consumes a packed rollout batch

        {"tokens" [B, S] int, "prompt_lens" [B], "total_lens" [B],
         "rewards" [B] fp32, "group_ids" [B] (baseline="group"),
         "teacher_logprobs" [B, S, V] fp32 (objective="distill_kl")}

    (numpy or tensors) and returns ``(state, metrics)`` like
    ``Trainer.step_fn``: the same optimizer (the adapters alone under
    ``lora_only``), precision policy, offload and guard (``notfinite``;
    under ``guard_policy="skip"`` a non-finite update is not applied, and
    ``post/loop.py`` gates the publish on the flag), and the
    ``DTG_FAULT_NAN_LOSS_STEP`` drill, through the Trainer's one step
    loop with ``post_loss`` as its microbatch loss. ``baseline`` is one of
    ``POST_BASELINES`` (``_advantages``). Under a plan the batch is the
    global one: the advantages come from the whole ``rewards`` /
    ``group_ids``, each rank runs the forward on its rows (its sequence
    shard under cp), and ``post_loss`` reads the gathered global logits
    (``PlanState.global_logits``: B x S x V fp32 on every rank), so its
    token counts and means are global and K5 launches twice an update (its
    forward and d_lhs). Under pipeline parallelism or with a callable
    ``attn_impl`` it refuses, as the JAX package does."""
    if objective not in POST_OBJECTIVES:
        raise ValueError(f"unknown post objective {objective!r}; choose "
                         f"from {POST_OBJECTIVES}")
    if baseline not in POST_BASELINES:
        raise ValueError(f"unknown post baseline {baseline!r}; choose "
                         f"from {POST_BASELINES}")
    if trainer.plan is not None and trainer.plan.sizes["pp"] > 1:
        raise ValueError(
            "post-training steps are not implemented under pipeline "
            "parallelism (the hand-differentiated 1F1B schedule has no "
            "ragged-objective form); use dp/fsdp/tp plans")
    if callable(trainer.attn_impl):
        raise ValueError(
            "post-training steps do not support a user-supplied callable "
            "attn_impl — silently substituting 'auto' would optimize a "
            "different model function than the one generating the "
            "rollouts; use a named attn_impl on the Trainer")
    cfg = trainer.bundle.config
    apply = trainer.bundle.apply
    dev = trainer.device
    ps = trainer.plan_state

    def as_tensor(x, dtype):
        return torch.as_tensor(x).to(device=dev, dtype=dtype)

    def post_step(state: TrainState, batch: dict) -> tuple:
        tokens = as_tensor(batch["tokens"], torch.int64)
        prompt_lens = as_tensor(batch["prompt_lens"], torch.int64)
        total_lens = as_tensor(batch["total_lens"], torch.int64)
        rewards = as_tensor(batch["rewards"], torch.float32)
        gids = batch.get("group_ids")
        # from the whole [B] vectors: a group may span the data ranks
        adv = _advantages(rewards, None if gids is None
                          else as_tensor(gids, torch.int64), baseline)
        teacher = batch.get("teacher_logprobs")
        if teacher is not None:
            teacher = as_tensor(teacher, torch.float32)

        def loss_hook(params, mb):
            if ps is None:
                logits = apply(cfg, params, tokens, remat=trainer.remat,
                               remat_policy=trainer.remat_policy,
                               attn_impl=trainer.attn_impl)
            else:
                hidden, _, _ = ps.forward(params, ps.local_rows(tokens),
                                          with_aux=False)
                logits = ps.global_logits(
                    params["base"] if trainer.lora else params, hidden)
            loss, extras = post_loss(
                logits, tokens, prompt_lens, total_lens,
                objective=objective, advantages=adv,
                teacher_logprobs=teacher, gmm_impl=gmm_impl)
            return loss, {"reward_mean": rewards.mean(),
                          "advantage_std": adv.std(correction=0), **extras}

        return trainer._run(state, batch, loss_hook, n_acc=1)

    return post_step
