"""Process guards: who writes, and barriers between processes.

Counterpart of ``distributed_training_guide_tpu/utils/procguards.py``,
which the checkpoint writer calls so that only process 0 writes the
manifest and ``state.json``, and of the reference's ``rank0_first`` /
``rank_ordered`` context managers (``process0_first`` /
``process_ordered``: one rank downloads while the others wait, then read
the warm cache). A process here is a ``torch.distributed`` rank when a
process group is up; without one (every single-device run)
``is_process0()`` is true and the barriers do nothing.
"""
from __future__ import annotations

from contextlib import contextmanager

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


@contextmanager
def process_ordered(should_go_first: bool):
    """First the processes with ``should_go_first``, then the rest."""
    if should_go_first:
        yield
        sync_processes("process_ordered_first")
        sync_processes("process_ordered_second")
    else:
        sync_processes("process_ordered_first")
        yield
        sync_processes("process_ordered_second")


@contextmanager
def process0_first():
    with process_ordered(is_process0()):
        yield
