"""Mesh-layout stamps and the reshard-compatibility check for restore.

A copy of ``distributed_training_guide_tpu/checkpoint/reshard.py`` (it
needs only the standard library), with ``mesh_descriptor`` reading the
port's trainer. Every save stamps a small **mesh descriptor** into the manifest's
host_state (next to the precision-policy stamp), and
``restore_train_state`` compares it against the restoring trainer's:
benign refactorizations (dp/fsdp/tp/cp factor changes, fewer or more
devices) log a loud "resharding A -> B" line and proceed; the layout
family that breaks across a mesh change raises
:class:`ReshardIncompatibleError` naming both layouts:

- **quantized opt-state block tilings**: adam8bit moments are int8
  payloads + one fp32 scale per block of the trailing axis
  (``train/precision.py``); the scale shapes encode the block size.

Unlike the JAX package, a **pipeline stage split** is not refused: DCP
stores each stacked ``[L]`` leaf whole (its pp shards are the stages'
layer ranges of one global tensor), so a state saved under pp 2 x fsdp 2
restores under fsdp 4 or another split (``tests/test_torch_cp_pp.py``
holds the restored step to the straight run's).

A trainer without a plan stamps ``{"axes": {}, "device_count": 1,
"strategy": "single", "pp_stages": 1, ...}``; under a sharding plan the
stamp carries the plan's non-trivial axes, the ranks and the strategy, as
the JAX package's does, so a stamp reads the same in both. DCP reshards
the stored shards into the restoring plan's layout (a checkpoint saved
under fsdp 4 restores under tp 2 x fsdp 2).
"""
from __future__ import annotations

from typing import Optional


class ReshardIncompatibleError(ValueError):
    """The checkpoint's recorded layout cannot restore into the target
    trainer's layout by resharding alone (the quantized block tiling
    changed). Carries both descriptors."""

    def __init__(self, message: str, *, saved: dict, target: dict):
        super().__init__(message)
        self.saved = dict(saved)
        self.target = dict(target)


def mesh_descriptor(trainer) -> dict:
    """The layout stamp for one trainer: the mesh's non-trivial axes, the
    device count, the sharding strategy, the pipeline stage split, and the
    quantized-moment block size (None for unquantized policies). Small,
    JSON-safe, and sufficient for :func:`check_reshard_compatibility`."""
    policy = trainer.precision
    plan = trainer.plan
    sizes = {} if plan is None else plan.sizes
    return {
        "axes": {k: int(v) for k, v in sizes.items() if int(v) > 1},
        "device_count": 1 if plan is None else plan.size(),
        "strategy": "single" if plan is None else plan.strategy,
        "pp_stages": int(sizes.get("pp", 1)),
        "quant_block": (int(policy.block_size)
                        if policy.quantize_moments else None),
    }


def describe_layout(desc: dict) -> str:
    """One human line for a descriptor (error messages and reshard logs)."""
    axes = desc.get("axes") or {}
    axes_s = ("x".join(f"{k}={v}" for k, v in sorted(axes.items()))
              or "single")
    parts = [f"{desc.get('strategy', '?')}[{axes_s}]",
             f"{desc.get('device_count', '?')} devices"]
    if desc.get("pp_stages", 1) > 1:
        parts.append(f"pp_stages={desc['pp_stages']}")
    if desc.get("quant_block") is not None:
        parts.append(f"quant_block={desc['quant_block']}")
    return ", ".join(parts)


def check_reshard_compatibility(saved: Optional[dict], target: dict) -> bool:
    """True when restoring ``saved`` -> ``target`` is a mesh CHANGE that
    plain resharding covers (the caller logs it); False when the layouts
    match (nothing to say). Raises :class:`ReshardIncompatibleError` for
    a changed quantized block tiling, naming both layouts.

    ``saved=None`` (pre-stamp checkpoint) is treated as unknown-but-
    allowed — exactly the old behavior."""
    if not saved:
        return False
    saved_block = saved.get("quant_block")
    target_block = target.get("quant_block")
    if (saved_block is not None and target_block is not None
            and int(saved_block) != int(target_block)):
        raise ReshardIncompatibleError(
            f"checkpoint holds quantized optimizer moments tiled at block "
            f"size {saved_block} ({describe_layout(saved)}) but this run's "
            f"precision policy tiles at block size {target_block} "
            f"({describe_layout(target)}); the per-block scale arrays have "
            f"different shapes, so this cannot restore by resharding — use "
            f"a policy with block_size={saved_block}, or restore with the "
            f"original policy and re-encode", saved=saved, target=target)
    return (saved.get("axes") != target.get("axes")
            or saved.get("device_count") != target.get("device_count"))
