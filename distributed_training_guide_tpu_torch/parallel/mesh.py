"""Device-mesh construction.

Counterpart of ``distributed_training_guide_tpu/parallel/mesh.py``: one
mesh with six named axes is the single abstraction behind every chapter,

    dp    pure data parallelism (replica groups)
    pp    pipeline parallelism (layer stages)
    fsdp  parameter-sharded data parallelism (ZeRO-3 / FULL_SHARD axis)
    ep    expert parallelism (MoE expert dim)
    tp    tensor parallelism (collectives per layer)
    cp    context parallelism (sequence-dim sharding)

and axes of size 1 stay in it, so every plan runs on the same mesh type.
Here the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the process group, one rank per device. There is no ICI / DCN
topology to map it onto, so the JAX module's multi-slice branch
(``create_hybrid_device_mesh``) has no counterpart: rank order is mesh
order, tp innermost but for cp.
"""
from __future__ import annotations

from typing import Optional

AXIS_NAMES = ("dp", "pp", "fsdp", "ep", "tp", "cp")


def mesh_shape_for(n_devices: int, *, fsdp: int = 1, tp: int = 1, cp: int = 1,
                   pp: int = 1, ep: int = 1, dp: Optional[int] = None) -> tuple[int, ...]:
    """Fill in the dp axis so dp*pp*fsdp*ep*tp*cp == n_devices."""
    denom = pp * fsdp * ep * tp * cp
    if n_devices % denom != 0:
        raise ValueError(f"{n_devices} devices not divisible by pp*fsdp*ep*tp*cp={denom}")
    inferred_dp = n_devices // denom
    if dp is not None and dp != inferred_dp:
        raise ValueError(f"dp={dp} inconsistent: need {inferred_dp}")
    return (inferred_dp, pp, fsdp, ep, tp, cp)


def make_mesh(*, fsdp: int = 1, tp: int = 1, cp: int = 1, pp: int = 1,
              ep: int = 1, dp: Optional[int] = None, device=None):
    """The six-axis ``DeviceMesh`` over every rank of the process group
    (``launch.maybe_initialize_distributed`` starts it), on ``cuda``
    unless ``device="cpu"``. The world size fills in dp."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .._device import resolve_device

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "launch.maybe_initialize_distributed() first (under torchrun or "
            "launch.local, or alone for a world of one)")
    shape = mesh_shape_for(dist.get_world_size(), fsdp=fsdp, tp=tp, cp=cp,
                           pp=pp, ep=ep, dp=dp)
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=AXIS_NAMES)
