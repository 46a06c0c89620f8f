"""Process guards: who writes, and barriers between processes.

Counterpart of ``distributed_training_guide_tpu/utils/procguards.py``,
which the checkpoint writer calls so that only process 0 writes the
manifest and ``state.json``. A process here is a ``torch.distributed``
rank when a process group is up; without one (every single-device run)
``is_process0()`` is true and ``sync_processes`` does nothing.
"""
from __future__ import annotations

import torch.distributed as dist


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _group_up() else 0


def process_count() -> int:
    return dist.get_world_size() if _group_up() else 1


def is_process0() -> bool:
    return process_index() == 0


def sync_processes(name: str = "barrier") -> None:
    """Barrier across all processes (no-op without a process group).
    ``name`` is the JAX package's barrier label; torch's barrier takes
    none."""
    if process_count() > 1:
        dist.barrier()
