"""Batch loader.

Counterpart of ``distributed_training_guide_tpu/data/loader.py``'s
``ShardedBatchLoader``: the same per-epoch shuffle
(``RandomState(seed + 1000003 * epoch)``), ``drop_last`` global batches,
the same ascending order inside a batch, and ``start_step`` fast-forward,
so the batches equal the JAX loader's. Yields ``{"input_ids", "labels"}``
int64 tensors on the device, [B, S], or [A, B / A, S] under grad
accumulation. Under a sharding plan each rank materializes only the rows
of its data coordinate (``data_rank`` of ``data_size``): the JAX loader's
shard of the batch dim, each microbatch's rows split alike; the ranks of
one tp group share a coordinate and read the same rows.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


class BatchLoader:
    def __init__(self, dataset: np.ndarray, batch_size: int, *, device,
                 grad_accum: int = 1, seed: int = 0, data_rank: int = 0,
                 data_size: int = 1):
        """``batch_size`` is the global batch (every rank's rows, every
        microbatch)."""
        if batch_size % max(grad_accum, 1) != 0:
            raise ValueError("batch_size must be divisible by grad_accum")
        if (batch_size // max(grad_accum, 1)) % data_size != 0:
            raise ValueError(f"a microbatch of {batch_size // max(grad_accum, 1)} "
                             f"rows does not split over {data_size} data ranks")
        self.data_rank = data_rank
        self.data_size = data_size
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
            idx = idx.reshape(self._leading_shape())
            n = idx.shape[-1] // self.data_size
            idx = idx[..., self.data_rank * n:(self.data_rank + 1) * n]
            rows = np.asarray(self.dataset[idx.ravel()], dtype=np.int64)
            ids = torch.from_numpy(rows.reshape(
                idx.shape + rows.shape[-1:])).to(self.device)
            yield {"input_ids": ids, "labels": ids}
