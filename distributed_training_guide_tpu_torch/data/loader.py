"""Single-device batch loader.

Counterpart of ``distributed_training_guide_tpu/data/loader.py``'s
``ShardedBatchLoader`` on one device: the same per-epoch shuffle
(``RandomState(seed + 1000003 * epoch)``), ``drop_last`` batches, the same
ascending order inside a batch, and ``start_step`` fast-forward, so the
batches equal the JAX loader's. Yields ``{"input_ids", "labels"}`` int64
tensors on the device, [B, S], or [A, B / A, S] under grad accumulation.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


class BatchLoader:
    def __init__(self, dataset: np.ndarray, batch_size: int, *, device,
                 grad_accum: int = 1, seed: int = 0):
        if batch_size % max(grad_accum, 1) != 0:
            raise ValueError("batch_size must be divisible by grad_accum")
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.grad_accum = grad_accum
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        np.random.RandomState(self.seed + 1000003 * self.epoch).shuffle(order)
        return order

    def _leading_shape(self) -> tuple:
        if self.grad_accum > 1:
            return (self.grad_accum, self.batch_size // self.grad_accum)
        return (self.batch_size,)

    def epoch_batches(self, start_step: int = 0) -> Iterator[dict]:
        """Yields this epoch's batches from ``start_step`` on."""
        order = self._epoch_order()
        for step in range(start_step, len(self)):
            idx = np.sort(order[step * self.batch_size:
                                (step + 1) * self.batch_size])
            rows = np.asarray(self.dataset[idx], dtype=np.int64)
            ids = torch.from_numpy(rows.reshape(
                self._leading_shape() + rows.shape[-1:])).to(self.device)
            yield {"input_ids": ids, "labels": ids}
