"""Build and load the port's CUDA kernels from the sources in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into ``build/kernels/lib<name>-<hash>.so`` at the repository
root (``.gitignore`` lists ``build/``), keyed by a hash of the source,
every shared header ``csrc/*.cuh`` and the flags, then loaded with
``ctypes``. Nothing is fetched: the CUDA
toolkit is found from ``CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``. A
failed build raises; no caller falls back to a plain path on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# ``--split-compile 0``: each nvcc optimizes and assembles its kernels in
# parallel over every core (the sources differ in size: one long source
# would otherwise hold the whole build)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0")

_libs: dict = {}        # name -> loaded ctypes.CDLL
build_logs: dict = {}   # name -> nvcc's stderr (ptxas registers and spills)


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda/bin, "
                       "PATH): the CUDA kernels cannot be built here")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source,
    of every ``csrc/*.cuh`` (a header edit rebuilds each library that may
    include it) and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile every named source that has no up-to-date library yet, one
    ``nvcc`` per source, all started together. Returns name -> path."""
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        build_logs[name] = err
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
    return lib


def all_sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
