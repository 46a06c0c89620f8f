"""Mesh-layout stamps and the reshard-compatibility check for restore.

A copy of ``distributed_training_guide_tpu/checkpoint/reshard.py`` (it
needs only the standard library), with ``mesh_descriptor`` reading the
port's trainer. Every save stamps a small **mesh descriptor** into the manifest's
host_state (next to the precision-policy stamp), and
``restore_train_state`` compares it against the restoring trainer's:
benign refactorizations (dp/fsdp/tp factor changes, fewer or more devices)
log a loud "resharding A -> B" line and proceed; the two layout families
that break across a mesh change raise :class:`ReshardIncompatibleError`
naming both layouts:

- **pipeline stage splits** (the stage-owned layer ranges are a function of
  ``pp``);
- **quantized opt-state block tilings**: adam8bit moments are int8
  payloads + one fp32 scale per block of the trailing axis
  (``train/precision.py``); the scale shapes encode the block size.

The port trains on one device only (the single-device plan), so its own
descriptor is always ``{"axes": {}, "device_count": 1, "strategy":
"single", "pp_stages": 1, ...}``: the cross-mesh paths stay inert until
ROADMAP.md queue 1, 'Distributed plans'. The descriptor equals the JAX
package's on one device, so a checkpoint's stamp reads the same in both.
"""
from __future__ import annotations

from typing import Optional


class ReshardIncompatibleError(ValueError):
    """The checkpoint's recorded layout cannot restore into the target
    trainer's layout by resharding alone (pp stage split or quantized
    block tiling changed). Carries both descriptors."""

    def __init__(self, message: str, *, saved: dict, target: dict):
        super().__init__(message)
        self.saved = dict(saved)
        self.target = dict(target)


def mesh_descriptor(trainer) -> dict:
    """The layout stamp for one trainer: the mesh's non-trivial axes, the
    device count, the sharding strategy, the pipeline stage split, and the
    quantized-moment block size (None for unquantized policies). Small,
    JSON-safe, and sufficient for :func:`check_reshard_compatibility`.
    The port's trainer runs the single-device plan: no non-trivial axis,
    one device, one stage."""
    policy = trainer.precision
    return {
        "axes": {},
        "device_count": 1,
        "strategy": "single",
        "pp_stages": 1,
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
    the two known-breaking families, naming both layouts.

    ``saved=None`` (pre-stamp checkpoint) is treated as unknown-but-
    allowed — exactly the old behavior."""
    if not saved:
        return False
    saved_pp = int(saved.get("pp_stages", 1))
    target_pp = int(target.get("pp_stages", 1))
    if saved_pp != target_pp:
        raise ReshardIncompatibleError(
            f"checkpoint was saved under a {saved_pp}-stage pipeline split "
            f"({describe_layout(saved)}) but this run uses {target_pp} "
            f"stage(s) ({describe_layout(target)}); pipeline stage splits "
            f"are not reshard-compatible — restore with the matching "
            f"pipeline_parallel, or export through the fp32/HF path and "
            f"re-import", saved=saved, target=target)
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
