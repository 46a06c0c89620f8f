"""Precision policies: what dtype each piece of training state is STORED in.

Counterpart of ``distributed_training_guide_tpu/train/precision.py``. With
the default policy every parameter costs 4 B of storage + 8 B of fp32 Adam
moments + 4 B of gradient buffer = 16 B/param, so device memory, not
FLOPs, caps the micro-batch. A named policy changes the storage:

    policy        params  opt state             grad buffer  total
    fp32          4 B     8 B (fp32 mu+nu)      4 B          16 B
    bf16-master   2 B     4 B (bf16 mu+nu)      2 B           8 B
    adam8bit      4 B     ~2.06 B (int8+scales) 4 B          ~10 B

- ``fp32``: the optimizer runs as it always did (``torch.optim.AdamW``,
  fused on the card).
- ``bf16-master``: params, moments and the gradient buffer are stored
  bf16; the update runs in fp32 (params, grads and moments are upcast
  leaf by leaf inside the step, Adam's arithmetic, the weight decay and
  ``p + u`` happen in fp32, and only the results are rounded back to bf16
  storage), so the fp32 master copy exists only transiently.
- ``adam8bit`` (Dettmers et al., 8-bit Optimizers via Block-wise
  Quantization): params stay fp32, both Adam moments are stored int8 with
  one fp32 scale per block of ~128 elements of the trailing axis. ``nu`` is
  quantized in the sqrt domain, so an element survives quantization in
  ``nu`` exactly when it survives in ``mu``.

Policies compose with ``+`` (``bf16-master+adam8bit``: bf16 params, int8
moments). The optax wrapper of the JAX package becomes the storage half of
the port's own optimizers (``train/optimizer.py``): they keep each state
slot in ``store_moment``'s form and compute on ``load_moment``'s fp32.

``quantize_blockwise`` and ``dequantize_blockwise`` (also the int8 KV pool's
and the int8 serve weights') are the JAX functions' arithmetic in the same
order; both frameworks round half to even, so the int8 payloads and scales
agree bit for bit on equal inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F


class Quantized(NamedTuple):
    """Block-quantized tensor: int8 payload ``q`` in the source shape and
    one fp32 ``scale`` per block of the trailing axis
    (``q.shape[:-1] + (nblocks,)``); the block size is ``ceil(d /
    nblocks)``, recoverable from the two shapes."""

    q: torch.Tensor
    scale: torch.Tensor


def block_geometry(d: int, block_size: int) -> tuple:
    """(nblocks, effective block size) for a trailing axis of length d:
    the fixed point of ``ceil(d / ceil(d / bs))``, so dequantize re-derives
    it from shapes alone."""
    nblocks = -(-d // max(block_size, 1))
    bs = -(-d // nblocks)
    return -(-d // bs), bs


def quantize_blockwise(x: torch.Tensor, block_size: int = 128,
                       sqrt_domain: bool = False):
    """Absmax int8 quantization per block of the trailing axis.
    ``sqrt_domain`` quantizes ``sqrt(x)`` (non-negative tensors such as
    Adam's ``nu``). A 0-d tensor passes through in fp32."""
    x = x.to(torch.float32)
    if x.ndim == 0:
        return x
    if sqrt_domain:
        x = torch.sqrt(x)
    d = x.shape[-1]
    nblocks, bs = block_geometry(d, block_size)
    pad = nblocks * bs - d
    xb = F.pad(x, (0, pad)) if pad else x
    xb = xb.reshape(*x.shape[:-1], nblocks, bs)
    amax = torch.amax(torch.abs(xb), dim=-1)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    q = q.to(torch.int8).reshape(*x.shape[:-1], nblocks * bs)[..., :d]
    return Quantized(q=q, scale=scale)


def straddles_shards(layout, block_size: int) -> bool:
    """True when a sharded leaf's shards do not tile its trailing axis's
    global blocks (``layout``: ``parallel/plans.py:LeafLayout``): a shard
    boundary falls inside a block, so quantizing each shard on its own
    would tile it otherwise, and ``quantize_sharded`` keeps the global
    tiling."""
    if layout is None or not layout.axes_of(len(layout.global_shape) - 1):
        return False
    bs = block_geometry(layout.global_shape[-1], block_size)[1]
    local = layout.plan.local_shape(layout.spec, layout.global_shape)[-1]
    return bool(local % bs or block_geometry(local, block_size)[1] != bs)


def _shard_blocks(layout, w: int, block_size: int) -> tuple:
    """(nblocks, bs, first block, blocks touched, left pad, right pad) of
    this rank's ``w`` columns within the global block tiling."""
    d = layout.global_shape[-1]
    nblocks, bs = block_geometry(d, block_size)
    lo = layout.plan.rank_over(layout.axes_of(len(layout.global_shape) - 1)
                               ) * w
    b0, b1 = lo // bs, (lo + w - 1) // bs
    return nblocks, bs, b0, b1 - b0 + 1, lo - b0 * bs, (b1 + 1) * bs - lo - w


def quantize_sharded(x: torch.Tensor, block_size: int, sqrt_domain: bool,
                     layout) -> Quantized:
    """``quantize_blockwise`` of the global leaf, from this rank's shard
    ``x`` of a trailing axis its shards split mid-block: each block's
    absmax is the max of its parts over the ranks that hold one (an
    all-reduce MAX over the trailing axis's mesh axes), so ``q`` is this
    rank's columns of the global ``q`` and ``scale`` the global scales
    ``[..., nblocks]``, whole on every rank (the JAX layout: the block
    axis replicated where the tiling does not align with the shards)."""
    import torch.distributed as dist

    x = x.to(torch.float32)
    if sqrt_domain:
        x = torch.sqrt(x)
    w = x.shape[-1]
    nblocks, bs, b0, nb, left, right = _shard_blocks(layout, w, block_size)
    xb = F.pad(x, (left, right)).reshape(*x.shape[:-1], nb, bs)
    amax = torch.zeros(*x.shape[:-1], nblocks, dtype=torch.float32,
                       device=x.device)
    amax[..., b0:b0 + nb] = torch.amax(torch.abs(xb), dim=-1)
    for a in layout.axes_of(x.ndim - 1):
        dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                        group=layout.plan.group(a))
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(xb / scale[..., b0:b0 + nb, None]),
                    -127, 127)
    q = q.to(torch.int8).reshape(*x.shape[:-1], nb * bs)[..., left:left + w]
    return Quantized(q=q, scale=scale)


def dequantize_sharded(qt: Quantized, sqrt_domain: bool, layout,
                       block_size: int) -> torch.Tensor:
    """The inverse of ``quantize_sharded`` on this rank's columns."""
    w = qt.q.shape[-1]
    _, bs, b0, nb, left, _ = _shard_blocks(layout, w, block_size)
    scale = torch.repeat_interleave(qt.scale[..., b0:b0 + nb], bs,
                                    dim=-1)[..., left:left + w]
    x = qt.q.to(torch.float32) * scale
    return x * x if sqrt_domain else x


def dequantize_blockwise(qt: Quantized, sqrt_domain: bool = False,
                         dtype=torch.float32) -> torch.Tensor:
    d = qt.q.shape[-1]
    bs = -(-d // qt.scale.shape[-1])
    scale = torch.repeat_interleave(qt.scale, bs, dim=-1)[..., :d]
    x = qt.q.to(torch.float32) * scale
    if sqrt_domain:
        x = x * x
    return x.to(dtype)


def cast_floats(tree, dtype):
    """Cast the floating-point leaves of a nested dict to ``dtype``;
    integer leaves pass through untouched."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


# the state slots of the port's optimizers, by how a policy stores them:
# Adam's first moment (linear), its second moment (sqrt domain), and every
# other float slot (lion's momentum, adafactor's factored accumulators)
ADAM_MU, ADAM_NU, OTHER = "adam_mu", "adam_nu", "other"


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One storage policy for the whole train state. ``param_dtype=None``
    means "inherit the model's storage dtype" (so the default policy
    composes with ``--param-dtype``)."""

    name: str
    param_dtype: Optional[Any] = None    # param storage dtype
    moment_dtype: Any = torch.float32    # stored dtype of optimizer state
    quantize_moments: bool = False       # int8 block quantization of mu/nu
    block_size: int = 128
    accum_dtype: Any = torch.float32     # grad-accumulation buffer dtype

    @property
    def is_noop(self) -> bool:
        """True when the policy changes nothing (the fp32 behavior)."""
        return (self.param_dtype is None and not self.quantize_moments
                and self.moment_dtype == torch.float32)

    def cast_params(self, params):
        if self.param_dtype is None:
            return params
        return cast_floats(params, self.param_dtype)

    def store_moment(self, x: torch.Tensor, kind: str, layout=None):
        """fp32 optimizer-state slot -> its storage form: a ``Quantized``
        for Adam's moments under a quantizing policy (``nu`` in the sqrt
        domain), else the tensor in ``moment_dtype``. ``layout``: the
        ``LeafLayout`` of a sharded leaf, whose blocks are the global
        leaf's where its shards split them (``quantize_sharded``)."""
        if self.quantize_moments and kind in (ADAM_MU, ADAM_NU):
            if straddles_shards(layout, self.block_size):
                return quantize_sharded(x, self.block_size, kind == ADAM_NU,
                                        layout)
            return quantize_blockwise(x, self.block_size,
                                      sqrt_domain=kind == ADAM_NU)
        return x.to(self.moment_dtype)

    def load_moment(self, stored, kind: str, layout=None) -> torch.Tensor:
        """Storage form -> the fp32 slot the update computes on."""
        if isinstance(stored, Quantized):
            if straddles_shards(layout, self.block_size):
                return dequantize_sharded(stored, kind == ADAM_NU, layout,
                                          self.block_size)
            return dequantize_blockwise(stored, sqrt_domain=kind == ADAM_NU)
        return stored.to(torch.float32)

    def store_opt_state(self, state: dict, kinds: dict) -> dict:
        """fp32 per-leaf state ``{leaf: {slot: tensor}}`` -> storage form;
        ``kinds`` names each slot's kind (``ADAM_MU`` / ``ADAM_NU`` /
        ``OTHER``)."""
        return {leaf: {k: self.store_moment(v, kinds[k])
                       for k, v in slots.items()}
                for leaf, slots in state.items()}

    def load_opt_state(self, state: dict, kinds: dict) -> dict:
        return {leaf: {k: self.load_moment(v, kinds[k])
                       for k, v in slots.items()}
                for leaf, slots in state.items()}


POLICIES: dict = {
    "fp32": PrecisionPolicy(name="fp32"),
    "bf16-master": PrecisionPolicy(
        name="bf16-master", param_dtype=torch.bfloat16,
        moment_dtype=torch.bfloat16, accum_dtype=torch.bfloat16),
    "adam8bit": PrecisionPolicy(name="adam8bit", quantize_moments=True),
}


def resolve_policy(spec) -> PrecisionPolicy:
    """Name, ``+``-composition of names, or an explicit PrecisionPolicy
    (None: fp32). ``bf16-master+adam8bit`` composes storage dtypes and
    quantization: bf16 params and buffer with int8 moments."""
    if isinstance(spec, PrecisionPolicy):
        return spec
    if spec is None:
        return POLICIES["fp32"]
    parts = [p.strip() for p in str(spec).split("+") if p.strip()]
    unknown = [p for p in parts if p not in POLICIES]
    if unknown or not parts:
        raise ValueError(
            f"unknown precision policy {spec!r}; use one of "
            f"{sorted(POLICIES)} or a '+' composition of them")
    merged = POLICIES[parts[0]]
    for name in parts[1:]:
        nxt = POLICIES[name]
        merged = PrecisionPolicy(
            name="+".join(parts),
            param_dtype=nxt.param_dtype or merged.param_dtype,
            moment_dtype=(nxt.moment_dtype
                          if nxt.moment_dtype != torch.float32
                          else merged.moment_dtype),
            quantize_moments=merged.quantize_moments or nxt.quantize_moments,
            block_size=merged.block_size,
            accum_dtype=(nxt.accum_dtype if nxt.accum_dtype != torch.float32
                         else merged.accum_dtype),
        )
    return merged
