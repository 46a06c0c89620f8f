"""Per-checkpoint integrity manifests.

A copy of ``distributed_training_guide_tpu/checkpoint/manifest.py`` (it
needs only the standard library), so that both packages write the same
manifest, field for field, for the same directory.

A manifest is written next to every published checkpoint dir
(``checkpoint-<step>.manifest.json``) recording the step, the host-side loop
state, and every file's size + CRC32. Restore verifies the manifest before
trusting a checkpoint and falls back through the retention chain
(``orbax_io.CheckpointIO``) when verification fails: a writer that dies
mid-write or a torn close can leave a checkpoint that loads without error
into garbage weights.

CRC32 (zlib) rather than sha256: the point is detecting torn/partial/bit-rotted
writes, not adversarial tampering, and CRC streams at memory bandwidth.

Files beyond ``SAMPLE_THRESHOLD`` get a *sampled* CRC by default: head + tail
+ evenly strided interior windows (deterministic in the file size, so
verification recomputes the identical byte set), capping per-file manifest
I/O at a few MiB while still catching truncation (size check), torn
head/tail writes, and stride-scale corruption. ``full_crc=True`` (CLI
``--checkpoint-full-crc``) restores the exhaustive scan.
"""
from __future__ import annotations

import json
import logging
import os
import time
import zlib
from pathlib import Path
from typing import Optional

LOGGER = logging.getLogger(__name__)

MANIFEST_FORMAT = 1
# manifests containing sampled-CRC entries declare format 2: their crc32
# values cover only the sampled windows, which a format-1 verifier would
# full-scan and misread as corruption. (A pre-sampling release rolled back
# onto format-2 manifests still fails verification — loudly, via the
# retention-chain fallback — since it never reads the format field; that
# one-way hazard is inherent to any manifest extension.)
MANIFEST_FORMAT_SAMPLED = 2
_CHUNK = 1 << 20
# files larger than this get the sampled CRC (unless full_crc); the cap
# bounds a sampled file's manifest read at _SAMPLE_WINDOWS * _CHUNK bytes
SAMPLE_THRESHOLD = 64 << 20
_SAMPLE_WINDOWS = 8  # head + tail + up to 6 strided interior windows


def manifest_path(exp_dir: Path, ckpt_name: str) -> Path:
    """Manifest lives BESIDE the checkpoint dir, not inside it: it must
    survive the dir being corrupted, and the storage layer owns the dir's
    contents."""
    return Path(exp_dir) / f"{ckpt_name}.manifest.json"


def _crc32_file(path: Path) -> int:
    crc = 0
    with open(path, "rb") as fp:
        while True:
            chunk = fp.read(_CHUNK)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _sample_offsets(size: int, chunk: int = _CHUNK,
                    windows: int = _SAMPLE_WINDOWS) -> list[int]:
    """Window start offsets for the sampled CRC — a pure function of the
    file SIZE and the (chunk, windows) parameters, so verification
    recomputes the exact byte set: first and last ``chunk`` plus evenly
    strided interior windows. The parameters are recorded in the manifest
    (``sample_params``) so manifests stay verifiable if the module
    defaults ever change."""
    last = max(size - chunk, 0)
    offsets = {0, last}
    interior = windows - 2
    for i in range(1, interior + 1):
        offsets.add(min((size * i) // (interior + 1), last))
    return sorted(offsets)


def _crc32_file_sampled(path: Path, size: int, chunk: int = _CHUNK,
                        windows: int = _SAMPLE_WINDOWS) -> tuple[int, int]:
    """(crc, bytes_read) over the deterministic sample windows."""
    crc = 0
    read = 0
    with open(path, "rb") as fp:
        for off in _sample_offsets(size, chunk, windows):
            fp.seek(off)
            data = fp.read(chunk)
            crc = zlib.crc32(data, crc)
            read += len(data)
    return crc, read


def _entry_crc(path: Path, size: int, full_crc: bool) -> dict:
    if full_crc or size <= SAMPLE_THRESHOLD:
        return {"crc32": _crc32_file(path)}
    crc, read = _crc32_file_sampled(path, size)
    return {"crc32": crc, "crc_mode": "sampled", "sampled_bytes": read}


def _walk_files(ckpt_dir: Path) -> list[Path]:
    return sorted(p for p in Path(ckpt_dir).rglob("*") if p.is_file())


def write_manifest(ckpt_dir: Path, step: int, host_state: dict, *,
                   full_crc: bool = False) -> Path:
    """Checksum every file under ``ckpt_dir`` (as it is enumerated — one
    pass) and write the manifest. Files beyond ``SAMPLE_THRESHOLD`` get the
    size-capped sampled CRC unless ``full_crc``.

    Called by process 0 after the write committed (the dir rename) and
    before state.json publishes the checkpoint — a crash in between leaves an
    orphan (dir + manifest) that the startup sweep collects, never a published
    checkpoint without a manifest.
    """
    ckpt_dir = Path(ckpt_dir)
    files = []
    for p in _walk_files(ckpt_dir):
        size = p.stat().st_size
        files.append({"path": str(p.relative_to(ckpt_dir)), "size": size,
                      **_entry_crc(p, size, full_crc)})
    sampled = any(f.get("crc_mode") == "sampled" for f in files)
    payload = {
        "format": MANIFEST_FORMAT_SAMPLED if sampled else MANIFEST_FORMAT,
        # the window schedule the sampled entries were computed with —
        # verification uses THESE, not the module defaults, so changing
        # the defaults never invalidates existing manifests
        **({"sample_params": {"chunk": _CHUNK,
                              "windows": _SAMPLE_WINDOWS}} if sampled
           else {}),
        "checkpoint": ckpt_dir.name,
        "step": int(step),
        "host_state": dict(host_state),
        "files": files,
        "created": int(time.time()),
    }
    path = manifest_path(ckpt_dir.parent, ckpt_dir.name)
    tmp = path.with_suffix(".json.tmp")
    with open(tmp, "w") as fp:
        json.dump(payload, fp)
    os.replace(tmp, path)  # atomic on POSIX
    return path


def load_manifest(exp_dir: Path, ckpt_name: str) -> Optional[dict]:
    """The manifest for ``ckpt_name``, or None if absent/unreadable (legacy
    checkpoints predate manifests; an unreadable one reads as absent so the
    caller decides whether to trust the checkpoint anyway)."""
    path = manifest_path(exp_dir, ckpt_name)
    try:
        with open(path) as fp:
            payload = json.load(fp)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(payload, dict) or "files" not in payload:
        return None
    return payload


def verify_manifest(ckpt_dir: Path, manifest: dict) -> list[str]:
    """Problems found checking ``ckpt_dir`` against ``manifest`` (empty list
    = intact). Reports every divergence, cheapest checks first: existence and
    size before CRC, so a missing shard is named without reading gigabytes."""
    ckpt_dir = Path(ckpt_dir)
    problems: list[str] = []
    if not ckpt_dir.is_dir():
        return [f"checkpoint dir missing: {ckpt_dir}"]
    expected = {e["path"]: e for e in manifest.get("files", [])}
    for rel, entry in expected.items():
        p = ckpt_dir / rel
        if not p.is_file():
            problems.append(f"missing file: {rel}")
            continue
        size = p.stat().st_size
        if size != entry["size"]:
            problems.append(f"size mismatch: {rel} ({size} != {entry['size']})")
            continue
        if entry.get("crc_mode") == "sampled":
            # recompute over the identical window set: offsets derive from
            # the recorded size (which just matched) and the manifest's own
            # recorded sample parameters (module defaults may have moved)
            sp = manifest.get("sample_params", {})
            crc, _ = _crc32_file_sampled(
                p, size, sp.get("chunk", _CHUNK),
                sp.get("windows", _SAMPLE_WINDOWS))
        else:
            crc = _crc32_file(p)
        if crc != entry["crc32"]:
            problems.append(f"checksum mismatch: {rel}")
    extra = {str(p.relative_to(ckpt_dir)) for p in _walk_files(ckpt_dir)} - set(expected)
    if extra:
        # extra files are logged but not fatal: the storage layer may add metadata across
        # versions, and restore ignores files it doesn't know
        LOGGER.info("checkpoint %s has %d file(s) not in manifest: %s",
                    ckpt_dir.name, len(extra), sorted(extra)[:5])
    return problems
