"""Optimizers + LR schedule.

Counterpart of ``distributed_training_guide_tpu/train/optimizer.py``: the
JAX package's warmup + cosine (or linear) decay to ``lr * eta_min_ratio``
over ``t_max`` steps, flat after, through a ``LambdaLR``, and three
optimizers:

- ``adamw_cosine`` (optax ``adamw``; ``grad_clip`` clips by the global
  norm first, as ``optax.clip_by_global_norm`` does). With fp32 params and
  the fp32 policy it is ``torch.optim.AdamW`` (fused on the card);
  otherwise the port's own AdamW below.
- ``adafactor_cosine``: the JAX package's explicit chain, factored RMS
  (``min_dim_size_to_factor`` 128) -> ``clip_by_block_rms(1.0)`` ->
  decoupled weight decay -> the learning rate. ``torch.optim.Adafactor`` is
  not that chain and is not used.
- ``lion_cosine``: ``optax.lion`` (b1 0.9, b2 0.99, decoupled decay).

optax reads the schedule at the update count before its increment, so
update 0 uses ``lr(0)``: the optimizer steps first and the scheduler after.
Weight decay is decoupled and applies to every leaf, norms included
(optax's unmasked transforms), and Adam's ``eps`` sits outside the square
root.

The port's own optimizers (``AdamW``, ``Adafactor``, ``Lion``) keep their
state in a precision policy's storage (``train/precision.py``) and compute
each update in fp32, leaf by leaf: a leaf's param, grad and state slots are
upcast, the optax arithmetic runs in optax's order, and the results are
rounded back to storage, so the fp32 transient is one leaf's and not the
model's. Under the no-op ``fp32`` policy they are optax itself: every slot
is kept in its param's dtype and the update is computed in that dtype, the
scalars rounded to it first as jax's weak types are (a bf16 leaf of
``--param-dtype bfloat16`` keeps bf16 moments and bf16 arithmetic).
``count`` is the shared update count (optax's ``count``).

Under a sharding plan (``parallel/plans.py``) each leaf may be a shard:
``layouts`` maps a leaf to its ``LeafLayout``, whose global shape decides
adafactor's factoring and whose groups make its means (and the clip's
global norm, passed in by the Trainer) global.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from .precision import ADAM_MU, ADAM_NU, OTHER, PrecisionPolicy, Quantized


def make_schedule(lr: float, t_max: int = 1000, eta_min_ratio: float = 0.01,
                  warmup_steps: int = 0,
                  decay: str = "cosine") -> Callable[[int], float]:
    """step -> learning rate: warmup, then decay to ``lr*eta_min_ratio``
    over ``t_max`` steps ("cosine", the reference's CosineAnnealingLR, or
    "linear"), flat after."""
    if decay not in ("cosine", "linear"):
        raise ValueError(f"decay must be cosine|linear, got {decay!r}")
    eta_min = lr * eta_min_ratio

    def schedule(step: int) -> float:
        warm = (min(step / max(warmup_steps, 1), 1.0) if warmup_steps
                else 1.0)
        t = min(max(step - warmup_steps, 0), t_max)
        if decay == "cosine":
            val = eta_min + (lr - eta_min) * 0.5 * (
                1 + math.cos(math.pi * t / t_max))
        else:
            val = eta_min + (lr - eta_min) * (1 - t / t_max)
        return warm * val

    return schedule


def cosine_schedule(lr: float, t_max: int = 1000,
                    eta_min_ratio: float = 0.01,
                    warmup_steps: int = 0) -> Callable[[int], float]:
    return make_schedule(lr, t_max, eta_min_ratio, warmup_steps, "cosine")


def lr_at_step(step: int, lr: float, t_max: int = 1000,
               eta_min_ratio: float = 0.01, warmup_steps: int = 0) -> float:
    """Host-side value of the cosine schedule for logging."""
    return cosine_schedule(lr, t_max, eta_min_ratio, warmup_steps)(step)


def _clip_denominator(grads: list, max_norm: float,
                      norm: Optional[torch.Tensor] = None) -> tuple:
    """optax ``clip_by_global_norm``'s factors as device scalars, with no
    host read: (divisor, multiplier) = (1, 1) when the global norm is below
    ``max_norm``, else (norm, max_norm), so ``g / d * m`` is optax's
    ``select(norm < max_norm, g, (g / norm) * max_norm)``. ``norm`` (the
    global norm of sharded grads) replaces the norm of ``grads``."""
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in grads]))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    return (torch.where(keep, one, norm),
            torch.where(keep, one, torch.full_like(norm, max_norm)))


@dataclasses.dataclass
class OptState:
    """The optimizer and its schedule: what optax keeps as one state.
    ``grad_clip`` (torch's AdamW only; the port's own optimizers clip
    their fp32 grads themselves) clips ``.grad`` in place before the
    update."""

    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    grad_clip: Optional[float] = None

    def step(self, grads: Optional[list] = None,
             norm: Optional[torch.Tensor] = None) -> None:
        """One update and one schedule step. ``grads`` (the port's own
        optimizers only) replaces the leaves' ``.grad``, in their order:
        the Trainer's accumulation buffers when their dtype is not the
        params'. ``norm``: the global grad norm of sharded leaves, for the
        clip."""
        if grads is not None or not isinstance(self.optimizer,
                                               torch.optim.AdamW):
            self.optimizer.step(grads=grads, norm=norm)
            self.scheduler.step()
            return
        if self.grad_clip:
            grads = [p.grad for g in self.optimizer.param_groups
                     for p in g["params"] if p.grad is not None]
            div, mul = _clip_denominator(grads, self.grad_clip, norm)
            torch._foreach_div_(grads, div)
            torch._foreach_mul_(grads, mul)
        self.optimizer.step()
        self.scheduler.step()

    @property
    def count(self) -> int:
        """Updates applied (the schedule's count)."""
        return self.scheduler.last_epoch

    def set_count(self, count: int) -> None:
        """Move the schedule (and the learning rates) to update ``count``:
        the restore path."""
        sch = self.scheduler
        sch.last_epoch = int(count)
        lrs = [base * fn(sch.last_epoch)
               for base, fn in zip(sch.base_lrs, sch.lr_lambdas)]
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        sch._last_lr = lrs


def _scheduler(opt, lr: float, schedule) -> torch.optim.lr_scheduler.LambdaLR:
    factor = ((lambda step: schedule(step) / lr) if lr
              else (lambda step: 0.0))
    return torch.optim.lr_scheduler.LambdaLR(opt, factor)


class _Fp32Update(torch.optim.Optimizer):
    """Base of the port's own optimizers. ``SLOTS`` maps each per-leaf
    state slot to its kind (``precision.ADAM_MU`` / ``ADAM_NU`` /
    ``OTHER``); every slot is created at init in its storage form, so a
    fresh state is also the restore target. ``step`` takes one leaf at a
    time in its compute dtype (fp32, or the leaf's own dtype under the
    no-op policy), calls ``_leaf(group, g, p, slots)`` -> (update, new
    slots), stores the slots and writes ``p + update`` rounded to the
    param's dtype."""

    SLOTS: dict = {}

    def __init__(self, params, defaults: dict, policy: PrecisionPolicy,
                 grad_clip: Optional[float], layouts: Optional[dict] = None):
        super().__init__(params, defaults)
        self.policy = policy
        self.native = policy.is_noop    # optax's own dtypes (see module)
        self.grad_clip = grad_clip
        self.layouts = layouts or {}
        self.count = 0
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {k: self._store(v, k, p)
                                 for k, v in self._init_leaf(p).items()}

    def _store(self, x: torch.Tensor, slot: str, p):
        if self.native:
            return x.to(p.dtype)
        return self.policy.store_moment(x, self.SLOTS[slot])

    def _load(self, stored, slot: str, cdt) -> torch.Tensor:
        if self.native:
            return stored.to(cdt)
        return self.policy.load_moment(stored, self.SLOTS[slot])

    @staticmethod
    def _scalar(cdt, device):
        """A constant in the compute dtype: a Python float for fp32 (the
        fp32 arithmetic of torch and optax alike), else a 0-d tensor of
        ``cdt``, rounded first as a jax weak-typed scalar is."""
        if cdt == torch.float32:
            return float
        return lambda x: torch.tensor(x, dtype=cdt, device=device)

    def _shape(self, p) -> tuple:
        layout = self.layouts.get(p)
        return tuple(p.shape) if layout is None else layout.global_shape

    def _mean(self, x, dim: int, p, keepdim: bool = False):
        """``x.mean(dim)`` over the global leaf: a sum all-reduced over
        the axes that shard ``dim`` of ``p`` (``x`` keeps ``p``'s dims)."""
        layout = self.layouts.get(p)
        if layout is None:
            return x.mean(dim, keepdim=keepdim)
        return layout.mean(x, dim, keepdim=keepdim)

    def _init_leaf(self, p) -> dict:
        """fp32 zeros of ``p``'s shape for every slot."""
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k in self.SLOTS}

    def _leaf(self, group, g, p, slots) -> tuple:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[list] = None,
             norm: Optional[torch.Tensor] = None):
        """One update of every leaf with a gradient: ``grads`` (in the
        leaves' order) or each leaf's ``.grad``; ``norm`` is the global
        norm for the clip (default: the norm of these grads)."""
        if closure is not None:
            raise ValueError("closures are not supported")
        leaves = [p for g in self.param_groups for p in g["params"]]
        grads = [p.grad for p in leaves] if grads is None else list(grads)
        live = [g for g in grads if g is not None]
        clip = (_clip_denominator(live, self.grad_clip, norm)
                if self.grad_clip and live else None)
        it = iter(grads)
        for group in self.param_groups:
            for p in group["params"]:
                g = next(it)
                if g is None:
                    continue
                cdt = p.dtype if self.native else torch.float32
                g = g.to(cdt)
                if clip is not None:
                    g = ((g.float() / clip[0]) * clip[1]).to(cdt)
                slots = {k: self._load(v, k, cdt)
                         for k, v in self.state[p].items()}
                pc = p.to(cdt)
                u, slots = self._leaf(group, g, pc, slots)
                self.state[p] = {k: self._store(v, k, p)
                                 for k, v in slots.items()}
                p.copy_(pc + u)
                del g, pc, u, slots
        self.count += 1
        return None


class AdamW(_Fp32Update):
    """optax ``adamw`` (``scale_by_adam`` -> ``add_decayed_weights`` ->
    ``scale_by_learning_rate``) in fp32 over policy storage: the bias
    corrections divide by ``1 - b**count`` computed in fp32, the update is
    ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` and the new param is
    ``p + update``."""

    SLOTS = {"exp_avg": ADAM_MU, "exp_avg_sq": ADAM_NU}

    def __init__(self, params, lr: float, *, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 policy: PrecisionPolicy, grad_clip: Optional[float] = None,
                 layouts: Optional[dict] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay),
                         policy, grad_clip, layouts)

    def _leaf(self, group, g, p, slots) -> tuple:
        b1, b2 = group["betas"]
        c = self._scalar(g.dtype, g.device)
        n = np.float32(self.count + 1)
        m = c(1 - b1) * g + c(b1) * slots["exp_avg"]
        v = c(1 - b2) * (g * g) + c(b2) * slots["exp_avg_sq"]
        m_hat = m / c(float(np.float32(1) - np.float32(b1) ** n))
        v_hat = v / c(float(np.float32(1) - np.float32(b2) ** n))
        u = m_hat / (torch.sqrt(v_hat) + c(group["eps"]))
        del m_hat, v_hat
        if group["weight_decay"]:
            u = u + c(group["weight_decay"]) * p
        return u * c(-group["lr"]), {"exp_avg": m, "exp_avg_sq": v}


class Lion(_Fp32Update):
    """optax ``lion`` (``scale_by_lion`` -> ``add_decayed_weights`` ->
    ``scale_by_learning_rate``): the update is ``-lr * (sign((1 - b1) g +
    b1 mu) + wd * p)``, then ``mu = (1 - b2) g + b2 mu``."""

    SLOTS = {"mu": OTHER}

    def __init__(self, params, lr: float, *, betas=(0.9, 0.99),
                 weight_decay: float = 0.01, policy: PrecisionPolicy,
                 grad_clip: Optional[float] = None,
                 layouts: Optional[dict] = None):
        super().__init__(params, dict(lr=lr, betas=betas,
                                      weight_decay=weight_decay),
                         policy, grad_clip, layouts)

    def _leaf(self, group, g, p, slots) -> tuple:
        b1, b2 = group["betas"]
        c = self._scalar(g.dtype, g.device)
        mu = slots["mu"]
        u = torch.sign(c(1.0 - b1) * g + c(b1) * mu)
        if group["weight_decay"]:
            u = u + c(group["weight_decay"]) * p
        return u * c(-group["lr"]), {"mu": c(1 - b2) * g + c(b2) * mu}


def factored_dims(shape, min_dim_size_to_factor: int) -> Optional[tuple]:
    """optax's ``_factored_dims``: the two largest axes (second largest,
    largest) when the second largest is at least the threshold, else None
    (the leaf keeps a full second moment)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Fp32Update):
    """The JAX package's ``adafactor_cosine`` chain: optax
    ``scale_by_factored_rms`` (decay ``1 - (count + 1)**-0.8``, epsilon
    1e-30 added to g^2; a leaf whose two largest axes are both at least
    ``min_dim_size_to_factor`` keeps row and column accumulators, any
    other leaf a full one) -> ``clip_by_block_rms(1.0)`` -> ``+ wd * p``
    -> ``* -lr``."""

    SLOTS = {"v_row": OTHER, "v_col": OTHER, "v": OTHER}
    EPS = 1e-30
    DECAY = 0.8

    def __init__(self, params, lr: float, *, weight_decay: float = 0.01,
                 min_dim_size_to_factor: int = 128,
                 policy: PrecisionPolicy, grad_clip: Optional[float] = None,
                 layouts: Optional[dict] = None):
        self.min_dim = min_dim_size_to_factor
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay),
                         policy, grad_clip, layouts)

    def _init_leaf(self, p) -> dict:
        dims = factored_dims(self._shape(p), self.min_dim)
        kw = dict(dtype=torch.float32, device=p.device)
        if dims is None:
            return {"v": torch.zeros(p.shape, **kw)}
        d1, d0 = dims
        shape = list(p.shape)
        return {"v_row": torch.zeros(shape[:d0] + shape[d0 + 1:], **kw),
                "v_col": torch.zeros(shape[:d1] + shape[d1 + 1:], **kw)}

    def _leaf(self, group, g, p, slots) -> tuple:
        # optax keeps the decay an fp32 array: its products with the slots
        # are fp32 whatever the leaf's dtype, rounded once into the slot
        c = self._scalar(g.dtype, g.device)
        t = np.float32(self.count + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-self.DECAY))
        g2 = g * g + c(self.EPS)
        dims = factored_dims(self._shape(p), self.min_dim)
        if dims is None:
            v = (decay * slots["v"].float()
                 + (1.0 - decay) * g2.float()).to(g.dtype)
            u = g * v ** -0.5
            new = {"v": v}
        else:
            d1, d0 = dims
            v_row = (decay * slots["v_row"].float() + (1.0 - decay)
                     * self._mean(g2, d0, p).float()).to(g.dtype)
            v_col = (decay * slots["v_col"].float() + (1.0 - decay)
                     * self._mean(g2, d1, p).float()).to(g.dtype)
            layout = self.layouts.get(p)
            if layout is None:
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = v_row.mean(reduced_d1, keepdim=True)
            else:       # v_row keeps p's dims but d0
                row_col_mean = layout.mean(v_row.unsqueeze(d0), d1,
                                           keepdim=True).squeeze(d0)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            new = {"v_row": v_row, "v_col": v_col}
        del g2
        layout = self.layouts.get(p)
        ms = (torch.mean(u * u) if layout is None
              else layout.mean_all(u * u))
        u = u / torch.clamp(torch.sqrt(ms), min=1.0)
        if group["weight_decay"]:
            u = u + c(group["weight_decay"]) * p
        return u * c(-group["lr"]), new


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """An optimizer's name and hyper-parameters; ``init(params, policy)``
    builds the state (``OptState``) around a list of leaf tensors, storing
    it under ``policy`` (default fp32)."""

    name: str
    lr: float
    schedule: Callable[[int], float]
    weight_decay: float
    grad_clip: Optional[float]
    hyper: tuple = ()           # (key, value) pairs of the optimizer's own

    @property
    def kwargs(self) -> dict:
        return dict(self.hyper)

    def init(self, params: list,
             policy: Optional[PrecisionPolicy] = None,
             layouts: Optional[dict] = None) -> OptState:
        """``layouts`` (sharded leaves only): leaf -> ``LeafLayout``."""
        from .precision import resolve_policy

        policy = resolve_policy(policy)
        kw = self.kwargs
        if self.name == "adamw" and policy.is_noop and all(
                p.dtype == torch.float32 for p in params):
            opt = torch.optim.AdamW(
                params, lr=self.lr, betas=(kw["b1"], kw["b2"]),
                eps=kw["eps"], weight_decay=self.weight_decay,
                fused=all(p.is_cuda for p in params) or None)
            for p in params:        # eager state: the restore target
                opt.state[p] = _adamw_zero_state(opt.param_groups[0], p)
            return OptState(opt, _scheduler(opt, self.lr, self.schedule),
                            self.grad_clip)
        if self.name != "adamw" and policy.quantize_moments:
            raise ValueError(
                f"precision policy {policy.name!r} quantizes Adam moments "
                f"but --optimizer {self.name} has none (use adamw, or drop "
                f"the adam8bit policy)")
        common = dict(weight_decay=self.weight_decay, policy=policy,
                      grad_clip=self.grad_clip, layouts=layouts)
        if self.name == "adamw":
            opt = AdamW(params, self.lr, betas=(kw["b1"], kw["b2"]),
                        eps=kw["eps"], **common)
        elif self.name == "lion":
            opt = Lion(params, self.lr, betas=(kw["b1"], kw["b2"]), **common)
        else:
            opt = Adafactor(params, self.lr,
                            min_dim_size_to_factor=kw[
                                "min_dim_size_to_factor"], **common)
        return OptState(opt, _scheduler(opt, self.lr, self.schedule))


def _adamw_zero_state(group: dict, p) -> dict:
    """The state ``torch.optim.AdamW`` creates for ``p`` at its first step
    (its ``_init_group``), made ahead of time."""
    on_device = group["fused"] or group["capturable"]
    step = (torch.zeros((), dtype=torch.float32, device=p.device)
            if on_device else torch.tensor(0.0, dtype=torch.float32))
    return {"step": step,
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(
                p, memory_format=torch.preserve_format)}


def adamw_cosine(lr: float, *, t_max: int = 1000,
                 eta_min_ratio: float = 0.01, warmup_steps: int = 0,
                 weight_decay: float = 0.01, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: Optional[float] = None,
                 decay: str = "cosine") -> OptimizerSpec:
    return OptimizerSpec("adamw", lr, make_schedule(
        lr, t_max, eta_min_ratio, warmup_steps, decay), weight_decay,
        grad_clip, (("b1", b1), ("b2", b2), ("eps", eps)))


def adafactor_cosine(lr: float, *, t_max: int = 1000,
                     eta_min_ratio: float = 0.01, warmup_steps: int = 0,
                     weight_decay: float = 0.01,
                     grad_clip: Optional[float] = None,
                     min_dim_size_to_factor: int = 128,
                     decay: str = "cosine") -> OptimizerSpec:
    """Adafactor with the shared schedule: the second moment stored
    factored (row + column accumulators, Shazeer & Stern 2018) and no first
    moment, so its state is a small fraction of AdamW's. Decay sits before
    the learning-rate scaling (the update is ``-lr * (rms_grad + wd * p)``),
    as in ``optax.adamw``."""
    return OptimizerSpec("adafactor", lr, make_schedule(
        lr, t_max, eta_min_ratio, warmup_steps, decay), weight_decay,
        grad_clip, (("min_dim_size_to_factor", min_dim_size_to_factor),))


def lion_cosine(lr: float, *, t_max: int = 1000,
                eta_min_ratio: float = 0.01, warmup_steps: int = 0,
                weight_decay: float = 0.01, b1: float = 0.9,
                b2: float = 0.99, grad_clip: Optional[float] = None,
                decay: str = "cosine") -> OptimizerSpec:
    """Lion (Chen et al. 2023) with the shared schedule: one momentum slot
    and sign updates whose size is set by ``lr`` alone."""
    return OptimizerSpec("lion", lr, make_schedule(
        lr, t_max, eta_min_ratio, warmup_steps, decay), weight_decay,
        grad_clip, (("b1", b1), ("b2", b2)))


# name -> constructor, the dispatch of the CLI's --optimizer
OPTIMIZERS = {"adamw": adamw_cosine, "adafactor": adafactor_cosine,
              "lion": lion_cosine}


def state_slots(opt: torch.optim.Optimizer, p) -> dict:
    """``p``'s optimizer state as flat named tensors: a ``Quantized`` slot
    as ``<slot>.q`` and ``<slot>.scale``."""
    out = {}
    for k, v in opt.state[p].items():
        if isinstance(v, Quantized):
            out[f"{k}.q"], out[f"{k}.scale"] = v.q, v.scale
        else:
            out[k] = v
    return out
