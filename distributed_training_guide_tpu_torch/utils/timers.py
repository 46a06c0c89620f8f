"""Phase timers.

Counterpart of ``distributed_training_guide_tpu/utils/timers.py`` (the
reference's ``LocalTimer``): wall time of a repeated phase, with an
optional device fence on entry and exit. ``device_sync`` is
``torch.cuda.synchronize``; without a sync function the timer relies on the
measured region ending in a host read (the training loop's loss read).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def device_sync() -> None:
    """Device fence: wait for all work queued on the current card."""
    torch.cuda.synchronize()


class LocalTimer:
    """Average wall time of a repeated phase (data / step / ...)."""

    def __init__(self, sync_fn: Optional[Callable[[], None]] = None):
        self.synchronize = sync_fn or (lambda: None)
        self.measurements: list[float] = []
        self.start_time: Optional[float] = None

    def __enter__(self) -> "LocalTimer":
        self.synchronize()
        self.start_time = time.perf_counter()
        return self

    def __exit__(self, exc_type, value, traceback) -> None:
        if traceback is None:
            self.synchronize()
            self.measurements.append(time.perf_counter() - self.start_time)
        self.start_time = None

    def avg_elapsed_ms(self) -> float:
        if not self.measurements:
            return 0.0
        return 1000.0 * (sum(self.measurements) / len(self.measurements))

    def reset(self) -> None:
        self.measurements = []
        self.start_time = None
