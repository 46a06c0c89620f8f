"""Checkpoint + resume, stored with ``torch.distributed.checkpoint``.

Counterpart of ``distributed_training_guide_tpu/checkpoint/orbax_io.py``
(the name is kept so the two are found together; nothing here uses Orbax).
A checkpoint is the train state as a flat dict of named tensors
(``train/state.py:state_tensors``: parameter paths, never optimizer
indices), written by ``torch.distributed.checkpoint`` (DCP) into
``<exp_dir>/checkpoint-<step>``, the format of the reference guide's
chapters 04 and 06: with no process group by the one process; under a
sharding plan by every rank, each writing its shards of the ``DTensor``
entries, so a read into another plan's layout reshards
(``checkpoint/reshard.py`` checks the two layouts first). Only process 0
writes the manifest and ``state.json``. The resume trigger is the
reference's ``state.json`` contract: resumable iff ``<exp_dir>/state.json``
exists.

The fault-tolerance layer is the JAX module's:

- the write goes into ``checkpoint-<step>.tmp`` and is renamed to
  ``checkpoint-<step>`` when it completes (the commit);
- every published checkpoint gets an integrity manifest (sizes + CRC32 +
  the host loop state, ``manifest.py``), written before state.json swings;
- ``keep_n`` checkpoints are retained (state.json carries the chain,
  newest first), and everything outside the chain is pruned at publish;
- restore checks the manifest and the stored layout (every name, shape and
  dtype) and falls back through the retention chain past corrupt, missing
  or unreadable checkpoints, logging what it skipped;
- transient filesystem errors during a synchronous save are retried with
  bounded exponential backoff;
- unreferenced ``checkpoint-*`` orphans (a crash between the commit and
  the state.json swing) and stale ``.tmp`` writes are swept by the WRITER
  at its first ``save()`` and at every publish; a restore-only reader
  never deletes anything.

With more than one process, restore follows the JAX module: process 0
verifies the chain and broadcasts the one candidate every rank reads, and
a read error fails the gang instead of falling back on one rank.

The port's optimizer updates params and moments in place, so
``async_save`` (one process, no sharding plan) first copies the state to
host memory (pinned buffers,
reused across saves, then a device sync) before ``save()`` returns; only
the file write overlaps the following steps, on one background thread. A
write that fails raises at the next ``save()``, ``flush()`` or
``close()``, with the previous checkpoint still the referenced one. Each
save's bytes and seconds are logged and kept in ``save_log``.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import torch

from ..utils.procguards import is_process0, process_count, sync_processes
from . import manifest as manifest_mod

LOGGER = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^checkpoint-\d+$")
_TMP_RE = re.compile(r"^checkpoint-\d+\.tmp$")
_WRITE_THREADS = 4          # DCP writer threads (one file each)


class CheckpointCorruptionError(RuntimeError):
    """Every checkpoint in the retention chain failed verification/restore."""


def _oserror_in(exc: BaseException) -> Optional[OSError]:
    """The OSError behind ``exc``: itself, or one a DCP
    ``CheckpointException`` wraps (its ``failures`` values are
    (exception, traceback) pairs)."""
    if isinstance(exc, OSError):
        return exc
    for failure in getattr(exc, "failures", {}).values():
        inner = failure[0] if isinstance(failure, tuple) else failure
        if isinstance(inner, OSError):
            return inner
    return None


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


def _no_dist() -> bool:
    """DCP without collectives: no process group is up."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized())


class CheckpointIO:
    """Crash-safe checkpoints of one experiment directory (see the module
    docstring). ``async_save`` overlaps the file write with the following
    steps; its state.json swing and pruning wait for the write and are
    finalized at the next ``save()``, ``flush()`` or ``close()``, so an
    unfinished save is invisible to resume."""

    def __init__(self, exp_dir: str | Path, *, async_save: bool = False,
                 keep_n: int = 2, save_retries: int = 2,
                 retry_backoff_s: float = 0.5, full_crc: bool = False):
        self.exp_dir = Path(exp_dir)
        self.async_save = async_save
        self.full_crc = bool(full_crc)
        self.keep_n = max(1, int(keep_n))
        self.save_retries = max(0, int(save_retries))
        self.retry_backoff_s = retry_backoff_s
        self._executor: Optional[ThreadPoolExecutor] = None
        self._pending = None     # (future, path, host_state, retained, log)
        self._pinned: dict = {}  # name -> reused pinned host buffer
        self._swept = False
        self.save_log: list = []

    # ---- paths -------------------------------------------------------------
    @property
    def state_json(self) -> Path:
        return self.exp_dir / "state.json"

    def _ckpt_dir(self, step: int) -> Path:
        return (self.exp_dir / f"checkpoint-{step}").absolute()

    def _read_state_json(self) -> Optional[dict]:
        if not self.state_json.exists():
            return None
        try:
            with open(self.state_json) as fp:
                return json.load(fp)
        except (json.JSONDecodeError, OSError):
            return None

    def _retained_names(self) -> list:
        """Retention chain (newest first) from state.json; a file with
        only ``checkpoint`` is a one-entry chain."""
        payload = self._read_state_json()
        if not payload:
            return []
        names = payload.get("retained")
        if not isinstance(names, list) or not names:
            names = [payload.get("checkpoint")]
        return [n for n in names if n]

    def _retention_chain(self) -> list:
        return [p for n in self._retained_names()
                if (p := (self.exp_dir / n).absolute()).exists()]

    def can_resume(self) -> bool:
        return bool(self._retention_chain())

    # ---- orphan sweep ------------------------------------------------------
    def _sweep_orphans(self) -> None:
        """Collect ``checkpoint-*`` dirs (and stray manifests) that no
        state.json references, and stale ``.tmp`` writes: the leftovers of
        a writer that died. Called only from the write path (the first
        ``save()``), which owns the exp_dir."""
        if not self.exp_dir.is_dir() or not is_process0():
            return
        referenced = set(self._retained_names())
        for entry in self.exp_dir.iterdir():
            if entry.is_dir() and _TMP_RE.match(entry.name):
                LOGGER.warning("sweeping unfinished checkpoint write %s",
                               entry.name)
                shutil.rmtree(entry, ignore_errors=True)
                continue
            if entry.is_dir() and _CKPT_RE.match(entry.name):
                name = entry.name
            elif entry.is_file() and entry.name.endswith(".manifest.json"):
                name = entry.name[:-len(".manifest.json")]
                if (self.exp_dir / name).exists():
                    continue  # its dir decides; swept together below
            else:
                continue
            if name in referenced:
                continue
            LOGGER.warning("sweeping orphaned checkpoint artifact %s "
                           "(unreferenced by state.json)", entry.name)
            self._remove_checkpoint(name)

    def _remove_checkpoint(self, name: str) -> None:
        shutil.rmtree(self.exp_dir / name, ignore_errors=True)
        try:
            manifest_mod.manifest_path(self.exp_dir, name).unlink()
        except OSError:
            pass

    # ---- the write ---------------------------------------------------------
    def _stage(self, flat: dict) -> dict:
        """The state's tensors copied to host memory: device tensors into
        pinned buffers (reused across saves), then one device sync; host
        tensors cloned. After this the training step may update the state
        in place."""
        out = {}
        on_device = False
        for name, t in flat.items():
            if t.is_cuda:
                buf = self._pinned.get(name)
                if (buf is None or buf.shape != t.shape
                        or buf.dtype != t.dtype):
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                    self._pinned[name] = buf
                buf.copy_(t, non_blocking=True)
                out[name] = buf
                on_device = True
            else:
                out[name] = t.detach().clone()
        if on_device:
            torch.cuda.synchronize()
        return out

    def _write(self, path: Path, flat: dict) -> None:
        """DCP-write ``flat`` into ``<path>.tmp``, then rename it to
        ``path`` (the commit)."""
        from torch.distributed.checkpoint import FileSystemWriter

        tmp = path.with_name(path.name + ".tmp")
        if is_process0():
            shutil.rmtree(tmp, ignore_errors=True)
        sync_processes("ckpt_tmp_clear")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                _dcp().save(flat, storage_writer=FileSystemWriter(
                    tmp, thread_count=_WRITE_THREADS), no_dist=_no_dist())
        except Exception as exc:  # noqa: BLE001 — OSErrors become OSError
            cause = _oserror_in(exc)
            if cause is not None and cause is not exc:
                raise OSError(cause.errno, f"checkpoint write failed: "
                              f"{cause}") from exc
            raise
        sync_processes("ckpt_written")
        if is_process0():
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
        sync_processes("ckpt_committed")

    def _write_with_retry(self, path: Path, flat: dict) -> None:
        """Bounded-backoff retry around a synchronous write for transient
        filesystem errors (the partial output of a failed attempt is
        removed first). Single-process only: with more processes the error
        propagates, and recovery belongs to the restart layer."""
        delay = self.retry_backoff_s
        for attempt in range(self.save_retries + 1):
            try:
                self._write(path, flat)
                return
            except OSError as exc:
                if attempt >= self.save_retries or process_count() > 1:
                    raise
                LOGGER.warning(
                    "checkpoint save attempt %d/%d failed (%s); retrying "
                    "in %.2fs", attempt + 1, self.save_retries + 1, exc,
                    delay)
                shutil.rmtree(path.with_name(path.name + ".tmp"),
                              ignore_errors=True)
                time.sleep(delay)
                delay *= 2

    # ---- save --------------------------------------------------------------
    def _finalize(self, path: Path, host_state: dict,
                  retained_before: list, log: dict,
                  future=None) -> None:
        """Wait for the write, then atomically publish + prune."""
        if future is not None:
            t0 = time.perf_counter()
            future.result()      # a failed background write raises here
            log["wait_s"] = time.perf_counter() - t0
        sync_processes("ckpt_saved")
        if is_process0():
            step = int(host_state.get("global_step", 0))
            # manifest before state.json: a crash in between leaves an
            # unreferenced dir+manifest pair (swept later), never a
            # referenced checkpoint without integrity data
            manifest_mod.write_manifest(path, step, host_state,
                                        full_crc=self.full_crc)
            retained = [path.name] + [n for n in retained_before
                                      if n != path.name]
            keep = retained[:self.keep_n]
            tmp = self.state_json.with_suffix(".json.tmp")
            with open(tmp, "w") as fp:
                json.dump({**host_state, "checkpoint": path.name,
                           "retained": keep}, fp)
            tmp.replace(self.state_json)  # atomic on POSIX
            keep_set = set(keep)
            for entry in self.exp_dir.iterdir():
                if (entry.is_dir() and _CKPT_RE.match(entry.name)
                        and entry.name not in keep_set):
                    self._remove_checkpoint(entry.name)
            from ..utils import faults

            faults.maybe_corrupt_checkpoint(path, step)
        sync_processes("ckpt_state_json")
        log["published"] = True
        LOGGER.info("checkpoint %s published: %s", path.name, log)

    def flush(self) -> None:
        """Finalize any in-flight async save (publishes its state.json)."""
        if self._pending is not None:
            future, path, host_state, retained, log = self._pending
            self._pending = None
            self._finalize(path, host_state, retained, log, future)

    def close(self) -> None:
        try:
            self.flush()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None
            self._pinned.clear()

    def save(self, train_state: Any, host_state: dict) -> None:
        """Crash-safe save of ``train_state`` (a ``train.state.TrainState``)
        as ``checkpoint-<global_step>``; then the manifest, the state.json
        swing and pruning beyond ``keep_n``. A crash at any point leaves
        the previous chain referenced by a valid state.json."""
        from ..train.state import state_tensors

        self.flush()
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        if not self._swept:
            self._sweep_orphans()
            self._swept = True
        from ..utils import faults

        faults.maybe_save_latency()
        t0 = time.perf_counter()
        step = int(host_state.get("global_step", 0))
        path = self._ckpt_dir(step)
        retained_before = self._retained_names()
        flat = state_tensors(train_state)
        log = {"step": step, "async": self.async_save,
               "bytes": sum(t.numel() * t.element_size()
                            for t in flat.values())}
        if self.async_save:
            if process_count() > 1 or train_state.sharding is not None:
                raise NotImplementedError(
                    "async checkpoints of a sharded state: ROADMAP.md "
                    "queue 1, 'Distributed plans, the rest'")
            staged = self._stage(flat)
            if self._executor is None:
                self._executor = ThreadPoolExecutor(max_workers=1)
            log["blocking_s"] = time.perf_counter() - t0

            def write():
                t1 = time.perf_counter()
                self._write(path, staged)
                log["write_s"] = time.perf_counter() - t1

            self._pending = (self._executor.submit(write), path,
                             dict(host_state), retained_before, log)
        else:
            self._write_with_retry(path, flat)
            log["write_s"] = log["blocking_s"] = time.perf_counter() - t0
            self._finalize(path, dict(host_state), retained_before, log)
        self.save_log.append(log)

    # ---- restore -----------------------------------------------------------
    def _host_state_for(self, path: Path, manifest: Optional[dict]) -> dict:
        if manifest is not None and isinstance(manifest.get("host_state"),
                                               dict):
            return dict(manifest["host_state"])
        # no manifest: state.json's counters describe the NEWEST checkpoint
        host_state = dict(self._read_state_json() or {})
        host_state.pop("checkpoint", None)
        host_state.pop("retained", None)
        if path.name != (self._retained_names() or [path.name])[0]:
            LOGGER.warning(
                "restored %s without a manifest; host counters from "
                "state.json may describe a newer checkpoint", path.name)
        return host_state

    def _verified_candidate(self, chain: list, failures: list) -> int:
        """Index of the newest chain entry whose manifest verifies
        (entries without a manifest are trusted with a warning), or -1."""
        for i, path in enumerate(chain):
            if not path.exists():
                LOGGER.warning("skipping checkpoint %s: referenced by "
                               "state.json but missing on disk", path.name)
                failures.append(f"{path.name}: missing")
                continue
            manifest = manifest_mod.load_manifest(self.exp_dir, path.name)
            if manifest is None:
                LOGGER.warning("checkpoint %s has no manifest; restoring "
                               "unverified", path.name)
                return i
            problems = manifest_mod.verify_manifest(path, manifest)
            if not problems:
                return i
            LOGGER.warning("skipping checkpoint %s: failed integrity check "
                           "(%s)", path.name, "; ".join(problems[:3]))
            failures.append(f"{path.name}: {problems[0]}")
        return -1

    @staticmethod
    def _read(path: Path, flat: dict) -> None:
        """Read checkpoint ``path`` into the tensors of ``flat`` in place,
        after checking that it holds exactly these names, each with the
        same shape and dtype (a layout mismatch raises ValueError)."""
        from torch.distributed.checkpoint import FileSystemReader

        md = FileSystemReader(path).read_metadata().state_dict_metadata
        problems = [f"{k}: not in the target" for k in sorted(set(md)
                                                             - set(flat))]
        for k, t in flat.items():
            meta = md.get(k)
            if meta is None:
                problems.append(f"{k}: missing")
            elif (tuple(meta.size) != tuple(t.shape)
                  or meta.properties.dtype != t.dtype):
                problems.append(f"{k}: {meta.properties.dtype} "
                                f"{tuple(meta.size)}, target {t.dtype} "
                                f"{tuple(t.shape)}")
        if problems:
            raise ValueError(f"checkpoint {path.name} has another layout: "
                             + "; ".join(problems[:4]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            _dcp().load(flat, storage_reader=FileSystemReader(path),
                        no_dist=_no_dist())

    def restore(self, target_state: Any) -> tuple:
        """Read the newest verifiable checkpoint into ``target_state`` (a
        ``TrainState`` in the layout to restore into, filled in place).
        Walks the retention chain newest-first: a checkpoint whose
        manifest fails verification, or whose read raises, is skipped with
        a warning and the next-older one is tried. Returns (state,
        host_state); raises ``CheckpointCorruptionError`` when candidates
        existed but none survived, ``FileNotFoundError`` when there was
        nothing to resume."""
        from ..train.state import load_state_tensors, state_tensors

        self.flush()
        names = self._retained_names()
        if not names:
            raise FileNotFoundError(
                f"no resumable checkpoint in {self.exp_dir}")
        if process_count() > 1:
            return self._agreed_restore(target_state, names)
        chain = self._retention_chain()
        if not chain:
            raise FileNotFoundError(
                f"no resumable checkpoint in {self.exp_dir}")
        failures: list = []
        start = 0
        while True:
            idx = self._verified_candidate(chain[start:], failures)
            if idx < 0:
                raise CheckpointCorruptionError(
                    f"no checkpoint in {self.exp_dir} survived "
                    f"verification: " + "; ".join(failures))
            path = chain[start + idx]
            manifest = manifest_mod.load_manifest(self.exp_dir, path.name)
            flat = state_tensors(target_state)
            try:
                self._read(path, flat)
            except Exception as exc:  # noqa: BLE001 — any read error falls back
                LOGGER.warning("skipping checkpoint %s: restore failed (%s)",
                               path.name, exc)
                failures.append(f"{path.name}: {exc}")
                start += idx + 1
                continue
            if failures:
                LOGGER.warning("fell back to checkpoint %s after skipping: "
                               "%s", path.name, "; ".join(failures))
            return (load_state_tensors(target_state, flat),
                    self._host_state_for(path, manifest))


    def _agreed_restore(self, target_state: Any, names: list) -> tuple:
        """Multi-process: process 0 verifies the manifests and broadcasts
        the chosen candidate, so ranks can never restore different
        checkpoints. The index space is the state.json name list itself,
        not each rank's view of the filesystem. A read error then fails
        the gang (the restart layer retries the same candidate)."""
        import torch.distributed as dist

        from ..train.state import load_state_tensors, state_tensors

        chain = [(self.exp_dir / n).absolute() for n in names]
        failures: list = []
        idx = [self._verified_candidate(chain, failures)
               if is_process0() else 0]
        dist.broadcast_object_list(idx, src=0)
        if idx[0] < 0:
            raise CheckpointCorruptionError(
                f"no checkpoint in {self.exp_dir} survived verification: "
                + "; ".join(failures))
        path = chain[idx[0]]
        if idx[0] > 0:
            LOGGER.warning("process 0 chose fallback checkpoint %s",
                           path.name)
        flat = state_tensors(target_state)
        self._read(path, flat)
        manifest = manifest_mod.load_manifest(self.exp_dir, path.name)
        return (load_state_tensors(target_state, flat),
                self._host_state_for(path, manifest))


def abstract_train_state(trainer, *, fp32_reference: bool = False):
    """The restore target for ``trainer``: a state in its layout, every
    tensor allocated (a fresh state, filled in place by the read).
    ``fp32_reference=True`` builds the layout before any precision policy
    (fp32 params, the base optimizer's fp32 state): the target of a
    checkpoint written by an fp32 run."""
    if fp32_reference:
        return trainer.fp32_reference_state()
    return trainer.init_state(0)


def _recorded_host_state(io: CheckpointIO) -> dict:
    """The newest retained checkpoint's manifest host_state (it carries the
    stamps restore checks: precision policy, mesh descriptor); empty for
    an unstamped save."""
    for path in io._retention_chain()[:1]:
        manifest = manifest_mod.load_manifest(io.exp_dir, path.name)
        if manifest and isinstance(manifest.get("host_state"), dict):
            return manifest["host_state"]
    return {}


def stamp_host_state(host_state: dict, trainer) -> dict:
    """Stamp the layout facts ``restore_train_state`` verifies into a
    host_state dict (mutates and returns it): the precision-policy name
    and the mesh descriptor (``checkpoint/reshard.py``)."""
    from .reshard import mesh_descriptor

    host_state["precision_policy"] = trainer.precision.name
    host_state["mesh"] = mesh_descriptor(trainer)
    return host_state


def restore_train_state(io: CheckpointIO, trainer) -> tuple:
    """Policy-aware restore: the one entry point train loops use.

    Restores into the trainer's precision-policy storage layout. An fp32
    checkpoint restored into a policy run is re-encoded (params cast,
    moments stored, quantized, in the policy's form) with a logged
    warning, since re-quantized moments are not bit-identical to ones
    carried through a quantized checkpoint. Every other policy change is a
    loud failure naming both policies, never a silent fallback to an older
    checkpoint. A checkpoint without the stamp is tried in the policy
    layout, then the fp32 one. A mesh change is checked for reshard
    compatibility first (``checkpoint/reshard.py``)."""
    from .reshard import (check_reshard_compatibility, describe_layout,
                          mesh_descriptor)

    policy = trainer.precision
    stamps = _recorded_host_state(io)
    target_layout = mesh_descriptor(trainer)
    recorded_layout = stamps.get("mesh")
    if check_reshard_compatibility(recorded_layout, target_layout):
        LOGGER.warning(
            "cross-mesh restore: resharding checkpoint saved on [%s] onto "
            "[%s]", describe_layout(recorded_layout),
            describe_layout(target_layout))
    recorded = stamps.get("precision_policy")
    if recorded and recorded != policy.name:
        if recorded == "fp32" and not policy.is_noop:
            state32, host = io.restore(
                abstract_train_state(trainer, fp32_reference=True))
            LOGGER.warning(
                "checkpoint in %s holds fp32 (pre-policy) state; re-encoding "
                "into precision policy '%s' — quantized moments are "
                "re-quantized, so they will not be bit-identical to a native "
                "policy checkpoint", io.exp_dir, policy.name)
            return trainer.encode_fp32_state(state32), host
        raise ValueError(
            f"checkpoint in {io.exp_dir} was written under precision policy "
            f"{recorded!r} but this run is configured for {policy.name!r}; "
            f"restore with the matching --precision-policy (fp32 "
            f"checkpoints re-encode into policy runs automatically; other "
            f"conversions are not performed silently)")
    try:
        return io.restore(abstract_train_state(trainer))
    except FileNotFoundError:
        raise
    except Exception as exc:  # noqa: BLE001 — unstamped layout mismatch
        if policy.is_noop:
            raise
        try:
            state32, host = io.restore(
                abstract_train_state(trainer, fp32_reference=True))
        except Exception:
            raise exc  # the original (policy-layout) failure is the story
        LOGGER.warning(
            "checkpoint in %s holds fp32 (pre-policy) state; re-encoding "
            "into precision policy '%s' — quantized moments are "
            "re-quantized, so they will not be bit-identical to a native "
            "policy checkpoint", io.exp_dir, policy.name)
        return trainer.encode_fp32_state(state32), host
