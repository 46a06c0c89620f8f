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
one tp group share a coordinate and read the same rows. ``microbatches``
(the pipeline's M) splits each batch into M microbatches first and each
microbatch's rows over the data ranks, as the JAX pipeline shards them.
Under context parallelism (``seq_size`` > 1) the targets are shifted over
the whole sequence first (``shift_targets``: the last position ignored)
and each rank gets its contiguous shard of both: ``{"input_ids",
"targets"}``, so a shard's last row is scored against the next shard's
first token. With ``native=True`` the C++ loader of
``data/native_loader.py`` assembles each global batch instead (its own
shuffle, the JAX native path's batches), mmapping a ``--mmap-data`` file
in place or a temporary token file it writes and removes on ``close``;
without g++ it warns and keeps the Python assembly. ``backend`` says
which one runs.
"""
from __future__ import annotations

import logging
import os
import tempfile
from typing import Iterator

import numpy as np
import torch

LOGGER = logging.getLogger(__name__)


IGNORE_INDEX = -100


def shift_targets(labels):
    """Next-token targets of ``labels`` [..., S] (a tensor or an array):
    position j holds label j + 1, the last position ``IGNORE_INDEX``."""
    if isinstance(labels, np.ndarray):
        out = np.full_like(labels, IGNORE_INDEX)
        out[..., :-1] = labels[..., 1:]
        return out
    return torch.nn.functional.pad(labels[..., 1:], (0, 1),
                                   value=IGNORE_INDEX)


def seq_shard(x, rank: int, size: int):
    """Shard ``rank`` of ``size`` contiguous shards of the last dim."""
    n = x.shape[-1] // size
    return x[..., rank * n:(rank + 1) * n]


def local_rows(idx: np.ndarray, data_rank: int, data_size: int,
               microbatches: int = 1) -> np.ndarray:
    """This data rank's rows of ``idx`` [..., B]: each of ``microbatches``
    consecutive microbatches split over the data ranks."""
    lead = idx.shape[:-1]
    idx = idx.reshape(lead + (microbatches, -1))
    n = idx.shape[-1] // data_size
    idx = idx[..., data_rank * n:(data_rank + 1) * n]
    return idx.reshape(lead + (-1,))


def local_batch(ids, labels, *, data_rank: int = 0, data_size: int = 1,
                microbatches: int = 1, seq_rank: int = 0,
                seq_size: int = 1) -> dict:
    """A global batch ``ids`` / ``labels`` ([..., B, S] arrays) as one rank
    holds it: its rows (``local_rows``), and under context parallelism
    its sequence shard with the targets shifted first."""
    rows = local_rows(np.arange(ids.shape[-2]), data_rank, data_size,
                      microbatches)
    ids, labels = ids[..., rows, :], labels[..., rows, :]
    if seq_size == 1:
        return {"input_ids": torch.as_tensor(ids).long(),
                "labels": torch.as_tensor(labels).long()}
    return {"input_ids": torch.as_tensor(np.ascontiguousarray(seq_shard(
                ids, seq_rank, seq_size))).long(),
            "targets": torch.as_tensor(np.ascontiguousarray(seq_shard(
                shift_targets(labels), seq_rank, seq_size))).long()}


class BatchLoader:
    def __init__(self, dataset: np.ndarray, batch_size: int, *, device,
                 grad_accum: int = 1, seed: int = 0, data_rank: int = 0,
                 data_size: int = 1, microbatches: int = 1,
                 seq_rank: int = 0, seq_size: int = 1,
                 native: bool = False):
        """``batch_size`` is the global batch (every rank's rows, every
        microbatch)."""
        if batch_size % max(grad_accum, 1) != 0:
            raise ValueError("batch_size must be divisible by grad_accum")
        rows = batch_size // max(grad_accum, 1)
        if rows % microbatches != 0:
            raise ValueError(f"global batch {rows} not divisible by "
                             f"microbatches={microbatches}")
        if (rows // microbatches) % data_size != 0:
            raise ValueError(f"a microbatch of {rows // microbatches} "
                             f"rows does not split over {data_size} data ranks")
        self.data_rank = data_rank
        self.data_size = data_size
        self.microbatches = microbatches
        self.seq_rank, self.seq_size = seq_rank, seq_size
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.grad_accum = grad_accum
        self.seed = seed
        self.epoch = 0
        self._native = None
        self._native_path = None      # a temp token file this loader owns
        if native:
            self._native = self._make_native()
        self.backend = "python" if self._native is None else "native"

    def _native_compatible_backing(self):
        """Path of the dataset's own backing file when the C++ loader can
        mmap it in place (a raw int32 token file that is the whole
        dataset: ``--mmap-data``); None asks for a temp-file copy."""
        ds = self.dataset
        filename = getattr(ds, "filename", None)
        if (isinstance(ds, np.memmap) and filename
                and ds.dtype == np.int32 and ds.flags["C_CONTIGUOUS"]
                and getattr(ds, "offset", 1) == 0
                and ds.size * 4 == os.path.getsize(filename)):
            return filename
        return None

    def _make_native(self):
        """The C++ loader over the dataset's backing file, or over a temp
        token file written here; None (with a warning) without g++."""
        from .native_loader import (NativeTokenLoader, native_available,
                                    write_token_file)

        if not native_available():
            LOGGER.warning("native loader unavailable (no g++); using "
                           "python assembly")
            return None
        path = self._native_compatible_backing()
        if path is None:
            tmp = tempfile.NamedTemporaryFile(suffix=".tokens.bin",
                                              delete=False)
            tmp.close()   # the C++ side reopens it by path
            self._native_path = tmp.name
            write_token_file(self.dataset, tmp.name)
            path = tmp.name
        return NativeTokenLoader(path, seq_len=self.dataset.shape[1],
                                 batch=self.batch_size, seed=self.seed)

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
            self._native = None
        if self._native_path is not None:
            try:
                os.unlink(self._native_path)
            except OSError:
                pass
            self._native_path = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

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

    def _host_batches(self, start_step: int) -> Iterator[np.ndarray]:
        """This rank's rows of each batch from ``start_step`` on, [A, B,
        S] or [B, S] int64 on the host."""
        if self._native is not None:
            rows = local_rows(np.arange(self.batch_size).reshape(
                self._leading_shape()), self.data_rank, self.data_size,
                self.microbatches)
            for batch in self._native.epoch_batches(self.epoch, start_step):
                yield batch.astype(np.int64)[rows]
            return
        order = self._epoch_order()
        for step in range(start_step, len(self)):
            idx = np.sort(order[step * self.batch_size:
                                (step + 1) * self.batch_size])
            idx = local_rows(idx.reshape(self._leading_shape()),
                             self.data_rank, self.data_size,
                             self.microbatches)
            rows = np.asarray(self.dataset[idx.ravel()], dtype=np.int64)
            yield rows.reshape(idx.shape + rows.shape[-1:])

    def epoch_batches(self, start_step: int = 0) -> Iterator[dict]:
        """Yields this epoch's batches from ``start_step`` on."""
        for rows in self._host_batches(start_step):
            ids = torch.from_numpy(rows).to(self.device)
            if self.seq_size == 1:
                yield {"input_ids": ids, "labels": ids}
                continue
            yield {"input_ids": seq_shard(ids, self.seq_rank,
                                          self.seq_size).contiguous(),
                   "targets": seq_shard(shift_targets(ids), self.seq_rank,
                                        self.seq_size).contiguous()}
