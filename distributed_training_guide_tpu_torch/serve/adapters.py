"""Multi-tenant LoRA adapter pool for the serving plane.

Counterpart of ``distributed_training_guide_tpu/serve/adapters.py``.
S-LoRA (Sheng et al., arXiv:2311.03285) and Punica (Chen et al.,
arXiv:2310.18547) serve N fine-tunes from ONE base model: the low-rank
delta ``scale * (x @ A) @ B`` is added per target projection as a ragged
grouped GEMM over the batch rows sorted by adapter, the
``ops/grouped_matmul.py`` kernel (K5) applied to decode slots instead of
MoE tokens. This module owns the serving-side state:

- **Stacked device buffers** (``init_adapter_stacks``): every adapter
  slot's ``A`` / ``B`` for every target lives in ONE fp32 tensor per
  target on the engine's device, ``a [L, max_adapters, in, r]`` / ``b [L,
  max_adapters, r, out]``: the layer axis leads like every stacked param
  leaf, and the adapter axis is the grouped GEMM's group axis once a layer
  is sliced. An insert writes one slot's rows in place, so the stacks keep
  their storage across publishes (the port's analogue of the JAX
  package's flat jit cache).
- **Slot 0 is the zero adapter** (``ZERO_ADAPTER``): its rows are zeros
  and never written, so base-only requests co-batch with adapted ones and
  their delta is an exact ``+0`` (A @ B with B = 0): the adapter-0 ==
  base-engine bitwise identity.
- **Host-side refcounts** (:class:`AdapterPool`, a host-only copy of the
  JAX class): all-or-nothing alloc, retain / release per in-flight
  request, eviction refused while any request references the slot, LRU
  among idle adapters under pressure, validation before mutation,
  ``describe()`` diagnostics.

The grouped-GEMM application itself lives in ``models/llama.py``
(``paged_decode_step(..., lora=)`` / ``prefill(..., lora=)``): models do
not import serve; the engine builds the lora context from these stacks.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.lora import DEFAULT_TARGETS, TARGET_PATHS, _get

# slot 0 never holds a tenant adapter: its rows stay exactly zero, so a
# base-only request's delta is an exact +0 and mixed batches need no
# special case anywhere
ZERO_ADAPTER = 0


def _check_targets(targets) -> None:
    unknown = [t for t in targets if t not in TARGET_PATHS]
    if unknown:
        raise ValueError(f"unknown adapter targets {unknown}; choose from "
                         f"{sorted(TARGET_PATHS)}")


def _check_slots(max_adapters: int) -> None:
    if max_adapters < 2:
        raise ValueError(f"max_adapters must be >= 2 (slot 0 is reserved "
                         f"for the zero adapter), got {max_adapters}")


def adapter_shapes(config, *, rank: int,
                   targets: Sequence[str] = DEFAULT_TARGETS,
                   bundle=None) -> dict:
    """One adapter's per-target leaf shapes in the POOL INSERT layout,
    ``{t: {"a": (L, in, r), "b": (L, r, out)}}``: exactly the leaves
    ``models/lora.py`` trains (``params["lora"]``), so a trained adapter
    publishes without reshaping."""
    _check_targets(targets)
    if rank < 1:
        raise ValueError(f"adapter rank must be >= 1, got {rank}")
    if bundle is None:
        from ..models.llama import param_shapes

        shapes = param_shapes(config)
    else:
        base = getattr(bundle, "lora_base", None) or bundle
        shapes = base.shapes()
    out = {}
    for t in targets:
        l, fan_in, fan_out = _get(shapes, TARGET_PATHS[t])
        out[t] = {"a": (l, fan_in, rank), "b": (l, rank, fan_out)}
    return out


def adapter_nbytes(config, *, rank: int,
                   targets: Sequence[str] = DEFAULT_TARGETS,
                   bundle=None) -> int:
    """Bytes ONE adapter occupies in the pool (fp32: adapters stay fp even
    over an int8 base). Also the payload of one adapter publish: it moves
    one slot's leaves, never the base weights."""
    shapes = adapter_shapes(config, rank=rank, targets=targets,
                            bundle=bundle)
    return sum(4 * math.prod(shape) for pair in shapes.values()
               for shape in pair.values())


def adapter_pool_bytes(config, *, max_adapters: int, rank: int,
                       targets: Sequence[str] = DEFAULT_TARGETS,
                       bundle=None) -> int:
    """Device-resident bytes of the whole stacked pool, slot 0 included
    (it is real device memory)."""
    _check_slots(max_adapters)
    return max_adapters * adapter_nbytes(config, rank=rank, targets=targets,
                                         bundle=bundle)


def init_adapter_stacks(config, *, max_adapters: int, rank: int,
                        targets: Sequence[str] = DEFAULT_TARGETS,
                        bundle=None, device=None) -> dict:
    """The zeroed stacked pool on ``device``:
    ``{t: {"a": [L, G, in, r], "b": [L, G, r, out]}}`` fp32."""
    _check_slots(max_adapters)
    shapes = adapter_shapes(config, rank=rank, targets=targets,
                            bundle=bundle)
    stacks = {}
    for t, pair in shapes.items():
        (l, fan_in, r), (_, _, fan_out) = pair["a"], pair["b"]
        stacks[t] = {
            "a": torch.zeros((l, max_adapters, fan_in, r),
                             dtype=torch.float32, device=device),
            "b": torch.zeros((l, max_adapters, r, fan_out),
                             dtype=torch.float32, device=device),
        }
    return stacks


def _is_floating(x) -> bool:
    """A torch tensor's or a numpy array's dtype is floating (ml_dtypes'
    bfloat16 included)."""
    if isinstance(x, torch.Tensor):
        return x.dtype.is_floating_point
    dtype = np.asarray(x).dtype
    return np.issubdtype(dtype, np.floating) or dtype.name == "bfloat16"


def validate_adapter_params(expected_shapes: dict, adapter_params) -> None:
    """Loud, per-leaf validation of an insert payload against the pool's
    ``(rank, targets)`` geometry: a wrong tenant artifact fails HERE with
    the leaf named, never as a shape error inside a forward."""
    if not isinstance(adapter_params, dict):
        raise ValueError(
            f"adapter params must be {{target: {{'a', 'b'}}}} "
            f"(models/lora.py params['lora'] layout), got "
            f"{type(adapter_params).__name__}")
    exp_t, got_t = sorted(expected_shapes), sorted(adapter_params)
    if exp_t != got_t:
        raise ValueError(
            f"adapter targets mismatch: pool serves {exp_t}, payload has "
            f"{got_t} — the pool's (rank, targets) geometry is fixed at "
            f"engine construction")
    for t in exp_t:
        pair = adapter_params[t]
        if sorted(pair) != ["a", "b"]:
            raise ValueError(f"adapter target {t!r} must hold leaves "
                             f"{{'a', 'b'}}, got {sorted(pair)}")
        for leaf in ("a", "b"):
            want = tuple(expected_shapes[t][leaf])
            got = tuple(pair[leaf].shape)
            if want != got:
                raise ValueError(
                    f"adapter leaf {t}/{leaf} shape mismatch: pool expects "
                    f"{want}, payload has {got} (rank and targets are "
                    f"pool geometry — retrain or re-export to match)")
            if not _is_floating(pair[leaf]):
                raise ValueError(
                    f"adapter leaf {t}/{leaf} must be floating "
                    f"(fp deltas ride over the base, quantized or not); "
                    f"got {pair[leaf].dtype}")


class AdapterPool:
    """Host-side bookkeeping for the stacked adapter slots: the
    ``kv_pages.PagePool`` discipline, one slot per tenant adapter.

    Slot 0 is :data:`ZERO_ADAPTER` and is never allocated, refcounted or
    evicted. Refcounts track IN-FLIGHT REQUESTS (the scheduler retains on
    submit / requeue / adopt and releases when the request leaves), so
    eviction refuses while a tenant's generation is mid-stream. ``alloc``
    is all-or-nothing: it returns a free slot or evicts exactly one LRU
    idle adapter to make room; if every live adapter is referenced it
    returns ``None`` and mutates NOTHING.
    """

    def __init__(self, max_adapters: int, *, rank: int,
                 alpha: float = 16.0,
                 targets: Sequence[str] = DEFAULT_TARGETS):
        _check_slots(max_adapters)
        if rank < 1:
            raise ValueError(f"adapter rank must be >= 1, got {rank}")
        _check_targets(targets)
        self.max_adapters = max_adapters
        self.rank = rank
        self.alpha = float(alpha)
        self.targets = tuple(targets)
        # LIFO free list + membership set, like PagePool
        self._free = list(range(max_adapters - 1, 0, -1))
        self._free_set = set(self._free)
        self._refs = [0] * max_adapters
        self._names: dict[int, Optional[str]] = {}   # live slot -> label
        self._tick = 0                               # LRU clock
        self._last_used = [0] * max_adapters
        self.stats = {"inserts": 0, "updates": 0, "evictions": 0,
                      "lru_evictions": 0, "spill_evictions": 0}
        # optional spill hook, called as ``on_evict(slot, name)`` BEFORE an
        # LRU victim's slot is recycled (the host tier's, 'Serve fleet')
        self.on_evict = None

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    @property
    def capacity(self) -> int:
        """Tenant slots (slot 0 excluded)."""
        return self.max_adapters - 1

    @property
    def n_live(self) -> int:
        return len(self._names)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def live_slots(self) -> list[int]:
        return sorted(self._names)

    def name_of(self, slot: int) -> Optional[str]:
        return self._names.get(slot)

    def is_live(self, slot) -> bool:
        """Whether ``slot`` is servable: the zero adapter always, a tenant
        slot iff inserted and not evicted."""
        if not isinstance(slot, int) or isinstance(slot, bool):
            return False
        return slot == ZERO_ADAPTER or slot in self._names

    def refcount(self, slot: int) -> int:
        self._check_range(slot)
        return self._refs[slot]

    def _check_range(self, slot: int) -> None:
        if not 0 <= slot < self.max_adapters:
            raise ValueError(f"adapter slot {slot} out of range "
                             f"[0, {self.max_adapters})")

    def _touch(self, slot: int) -> None:
        self._tick += 1
        self._last_used[slot] = self._tick

    def alloc(self, name: Optional[str] = None) -> Optional[int]:
        """Claim a slot for a new adapter: a free slot if any, else evict
        the least-recently-used IDLE (refcount-0) live adapter. Returns the
        slot (refcount 0: requests retain separately), or ``None`` when
        every live adapter is referenced (nothing mutated). ``name`` is a
        diagnostic label."""
        if self._free:
            slot = self._free.pop()
            self._free_set.discard(slot)
        else:
            idle = [s for s in self._names if self._refs[s] == 0]
            if not idle:
                return None
            slot = min(idle, key=lambda s: self._last_used[s])
            victim_name = self._names[slot]
            if self.on_evict is not None and victim_name is not None:
                self.on_evict(slot, victim_name)
                self.stats["spill_evictions"] += 1
            del self._names[slot]
            self.stats["evictions"] += 1
            self.stats["lru_evictions"] += 1
        self._names[slot] = name
        self._touch(slot)
        self.stats["inserts"] += 1
        return slot

    def retain(self, slot: int) -> None:
        """One more in-flight request on ``slot`` (a no-op for the zero
        adapter: it is never evictable)."""
        self._check_range(slot)
        if slot == ZERO_ADAPTER:
            return
        if slot not in self._names:
            raise ValueError(f"retain of adapter slot {slot} which is not "
                             f"live (free or evicted)")
        self._refs[slot] += 1
        self._touch(slot)

    def release(self, slot: int) -> None:
        self._check_range(slot)
        if slot == ZERO_ADAPTER:
            return
        if slot not in self._names:
            raise ValueError(f"release of adapter slot {slot} which is "
                             f"not live")
        if self._refs[slot] <= 0:
            raise ValueError(f"release of adapter slot {slot} with "
                             f"refcount 0 (double release)")
        self._refs[slot] -= 1

    def evict(self, slot: int) -> None:
        """Explicitly retire a tenant adapter. Refuses (mutating nothing)
        while requests reference it: drain the tenant first."""
        self._check_range(slot)
        if slot == ZERO_ADAPTER:
            raise ValueError("adapter slot 0 is the zero adapter and is "
                             "never evictable")
        if slot not in self._names:
            raise ValueError(f"evict of adapter slot {slot} which is not "
                             f"live")
        if self._refs[slot] > 0:
            raise ValueError(
                f"evict of adapter slot {slot} with {self._refs[slot]} "
                f"in-flight request(s) — finish or drain the tenant "
                f"first")
        del self._names[slot]
        self._free.append(slot)
        self._free_set.add(slot)
        self.stats["evictions"] += 1

    def mark_update(self, slot: int) -> None:
        """Record an in-place republish into a live slot (continual
        tuning: same tenant, refreshed weights)."""
        self._check_range(slot)
        if slot != ZERO_ADAPTER and slot not in self._names:
            raise ValueError(f"update of adapter slot {slot} which is not "
                             f"live")
        self._touch(slot)
        self.stats["updates"] += 1

    def describe(self, slot: int) -> str:
        self._check_range(slot)
        if slot == ZERO_ADAPTER:
            return "slot 0: the zero adapter (reserved, refcount-free)"
        if slot in self._free_set:
            return f"slot {slot}: free"
        name = self._names.get(slot)
        label = f" name={name!r}" if name else ""
        return (f"slot {slot}: live{label} refs={self._refs[slot]} "
                f"last_used={self._last_used[slot]}")
