"""ctypes bindings and on-demand build of the C++ token loader.

Counterpart of ``distributed_training_guide_tpu/data/native_loader.py``:
``csrc/token_loader.cpp`` (the port's own copy, byte for byte the JAX
package's) mmaps a flat int32 token file and assembles shuffled
``[batch, seq_len]`` batches on C++ threads, with no GIL and a bounded
prefetch queue; the Python side stays a thin iterator. The batches are
byte-equal to the JAX package's for the same file, seed, epoch and
``start_step`` (the shuffle is the C++ side's mt19937_64, not numpy's, so
they differ from ``data/loader.py``'s Python assembly).

Where the port differs: the library is compiled with g++ at first use into
``build/native/`` at the repository root (``.gitignore`` lists
``build/``), named by a hash of the source and the flags, never into a
source directory. A machine without a toolchain has no native loader:
``native_available()`` is False and the training loader falls back to the
Python assembly with a warning.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

LOGGER = logging.getLogger(__name__)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIB: Optional[ctypes.CDLL] = None
_BUILD_FAILED = False


def library_path() -> Path:
    """The library of ``csrc/token_loader.cpp``, named by a hash of the
    source and the flags."""
    h = hashlib.sha256((_CSRC / "token_loader.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtokenloader-{h.hexdigest()[:16]}.so"


def _build_library() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp),
           str(_CSRC / "token_loader.cpp"), "-lpthread"]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)      # a concurrent build never loads a torn file
        return out
    except (OSError, subprocess.SubprocessError) as e:
        LOGGER.warning(f"native loader build failed ({e}); using python "
                       f"loader")
        tmp.unlink(missing_ok=True)
        return None


def get_library() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_FAILED
    if _LIB is not None or _BUILD_FAILED:
        return _LIB
    path = _build_library()
    try:
        lib = ctypes.CDLL(str(path)) if path is not None else None
    except OSError as e:
        LOGGER.warning(f"native loader library {path} failed to load ({e}); "
                       f"using python loader")
        lib = None
    if lib is None:
        _BUILD_FAILED = True
        return None
    lib.tl_open.restype = ctypes.c_void_p
    lib.tl_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
    lib.tl_num_batches.restype = ctypes.c_int64
    lib.tl_num_batches.argtypes = [ctypes.c_void_p]
    lib.tl_num_sequences.restype = ctypes.c_int64
    lib.tl_num_sequences.argtypes = [ctypes.c_void_p]
    lib.tl_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int64]
    lib.tl_next_batch.restype = ctypes.c_int
    lib.tl_next_batch.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.tl_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def native_available() -> bool:
    return get_library() is not None


def write_token_file(dataset: np.ndarray, path: str | Path) -> Path:
    """Flat int32 token file: the native loader's (and ``--mmap-data``'s)
    format."""
    path = Path(path)
    np.ascontiguousarray(dataset, dtype=np.int32).tofile(path)
    return path


class NativeTokenLoader:
    """Iterator over [batch, seq_len] int32 host batches assembled in C++,
    deterministic per (seed, epoch), resumable by ``start_step``."""

    def __init__(self, token_file: str | Path, seq_len: int, batch: int,
                 seed: int = 0, threads: int = 2, prefetch: int = 4):
        lib = get_library()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++?)")
        self._lib = lib
        self._handle = lib.tl_open(str(token_file).encode(), seq_len, batch,
                                   seed, threads, prefetch)
        if not self._handle:
            raise OSError(f"tl_open failed for {token_file}")
        self.seq_len = seq_len
        self.batch = batch

    def __len__(self) -> int:
        return self._lib.tl_num_batches(self._handle)

    @property
    def num_sequences(self) -> int:
        return self._lib.tl_num_sequences(self._handle)

    def epoch_batches(self, epoch: int = 0,
                      start_step: int = 0) -> Iterator[np.ndarray]:
        self._lib.tl_start_epoch(self._handle, epoch, start_step)
        out = np.empty((self.batch, self.seq_len), dtype=np.int32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        while self._lib.tl_next_batch(self._handle, ptr):
            yield out.copy()

    def close(self) -> None:
        if self._handle:
            self._lib.tl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
