"""Deterministic fault injection for failure drills.

A copy of ``distributed_training_guide_tpu/utils/faults.py`` (standard
library only): the same ``DTG_FAULT_*`` variables. The port's training loop
consumes the training drills (crash, NaN loss, corrupt checkpoint, save
latency); the serve-fleet and elastic drills stay inert until their modules
are ported.

The reference teaches failure *diagnosis* (``diagnosing-errors/README.md``)
but gives no way to rehearse a failure on purpose; every restart/resume path
in this repo would otherwise only be exercised by real crashes. These env-var
driven faults make failures reproducible — the chaos tests
(``tests/test_chaos.py``) and operators running fire drills on a real pod use
the same switches:

- ``DTG_FAULT_CRASH_STEP=N`` [+ ``DTG_FAULT_CRASH_MODE=kill|exc``]: die at
  the end of global step N — SIGKILL (default; no cleanup, the supervisor's
  worst case) or a raised exception (exercises the ``@record`` error file).
- ``DTG_FAULT_NAN_LOSS_STEP=N``: overwrite the loss with NaN inside the
  train step when ``state.step == N`` (drives ``train/guards.py`` policies).
- ``DTG_FAULT_CORRUPT_CKPT_STEP=N``: after the step-N checkpoint publishes,
  flip bytes in its largest shard file — the manifest then catches it and
  restore falls back through the retention chain.
- ``DTG_FAULT_SAVE_LATENCY_S=X``: sleep X seconds inside every checkpoint
  save (slow-NFS simulation; exercises async-save overlap and heartbeats).

Serve-plane faults (the multi-host fabric's drills — serve/transport.py
and serve/router.py consume these; ``tests/test_chaos_serve.py`` is the
executable documentation):

- ``DTG_FAULT_HANDOFF_CRASH_XFER=N``: the Nth cross-host page handoff
  (0-indexed transfer id) tears mid-flight — the payload bytes on the
  wire are corrupted the way a sender crash mid-write leaves them, the
  receiver's CRC rejects the frame, and the protocol's only outcome is
  "payload dropped, sender pages freed, request requeued at the prefill
  queue's head".
- ``DTG_FAULT_HANDOFF_TIMEOUT_XFER=N``: the receiver sits on transfer N
  past the sender's ack timeout; the sender aborts the transfer with the
  same drop-free-requeue outcome (the late ack is discarded by id).
- ``DTG_FAULT_REPLICA_KILL=<name>@<step>``: SIGKILL-shaped replica death
  — at router iteration ``step``, replica ``name`` stops instantly with
  NO cleanup (no drain, no handoff); the router fences it on the next
  health check and resubmits its in-flight requests.
- ``DTG_FAULT_REPLICA_WEDGE=<name>@<step>``: the wedged-but-alive case —
  the replica stops stepping AND stops heartbeating (a stuck device op),
  while its process would still answer liveness; only the heartbeat-age
  fence catches it.
- ``DTG_FAULT_ARRIVAL_BURST=<mult>@<start>:<end>``: traffic-shape fault
  for the open-loop load harness — the arrival rate is multiplied by
  ``mult`` for offsets in ``[start, end)`` seconds from the start of the
  trace (``serve/loadgen.py`` consumes it when building Poisson
  schedules). A flash crowd on demand, deterministic per seed.
- ``DTG_FAULT_REPLICA_SLOW=<name>@<delay_s>``: the gray-failure case the
  kill/wedge drills cannot produce — replica ``name`` keeps stepping and
  heartbeating but every iteration is inflated by ``delay_s`` seconds (a
  thermally throttled chip, a noisy co-tenant). Nothing fences it; only
  load-aware routing and the controller's SLO loop notice.

Elastic-fleet faults (the renegotiation and generation-swap drills —
``launch/elastic.py`` members and ``serve/elastic.py`` swaps consume
these; ``tests/test_elastic_train.py`` / ``test_elastic_serve.py``):

- ``DTG_FAULT_SLICE_LOSS=<member>@<beat>``: slice loss — the named
  elastic member stops writing its membership heartbeat after its Nth
  beat and exits without retiring its file (the no-cleanup death of a
  whole slice); the surviving supervisors' liveness scan ages it out and
  the leader renegotiates the world without it.
- ``DTG_FAULT_SWAP_DROP_SEQ=<n>``: during an engine-generation swap, the
  Nth resident sequence's gathered k/v payload is dropped (a torn
  device-to-host read); the swap falls back to requeue-and-replay for
  that sequence — recompute through the prefill path plus the bitwise
  decode replay, so the continuation is still token-identical.

All faults are deterministic functions of (env, step): a drill that kills a
run at step N kills every rerun at step N too, so kill -> restart -> resume
trajectories can be compared bit-for-bit against an uninterrupted run.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import signal
from pathlib import Path
from typing import Optional

LOGGER = logging.getLogger(__name__)

ENV_CRASH_STEP = "DTG_FAULT_CRASH_STEP"
ENV_CRASH_MODE = "DTG_FAULT_CRASH_MODE"
ENV_NAN_LOSS_STEP = "DTG_FAULT_NAN_LOSS_STEP"
ENV_CORRUPT_CKPT_STEP = "DTG_FAULT_CORRUPT_CKPT_STEP"
ENV_SAVE_LATENCY_S = "DTG_FAULT_SAVE_LATENCY_S"
ENV_HANDOFF_CRASH_XFER = "DTG_FAULT_HANDOFF_CRASH_XFER"
ENV_HANDOFF_TIMEOUT_XFER = "DTG_FAULT_HANDOFF_TIMEOUT_XFER"
ENV_REPLICA_KILL = "DTG_FAULT_REPLICA_KILL"
ENV_REPLICA_WEDGE = "DTG_FAULT_REPLICA_WEDGE"
ENV_ARRIVAL_BURST = "DTG_FAULT_ARRIVAL_BURST"
ENV_REPLICA_SLOW = "DTG_FAULT_REPLICA_SLOW"
ENV_SLICE_LOSS = "DTG_FAULT_SLICE_LOSS"
ENV_SWAP_DROP_SEQ = "DTG_FAULT_SWAP_DROP_SEQ"

_CORRUPT_BYTES = 256


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        LOGGER.warning("ignoring non-integer %s=%r", name, raw)
        return None


def _env_target(name: str) -> Optional[tuple[str, int]]:
    """Parse a ``<replica_name>@<step>`` fault target."""
    raw = os.environ.get(name)
    if not raw:
        return None
    target, _, step = raw.partition("@")
    try:
        return (target, int(step))
    except ValueError:
        LOGGER.warning("ignoring malformed %s=%r (want <name>@<step>)",
                       name, raw)
        return None


def _env_burst(name: str) -> Optional[tuple[float, float, float]]:
    """Parse a ``<mult>@<start>:<end>`` arrival-burst window."""
    raw = os.environ.get(name)
    if not raw:
        return None
    mult, _, window = raw.partition("@")
    start, _, end = window.partition(":")
    try:
        return (float(mult), float(start), float(end))
    except ValueError:
        LOGGER.warning("ignoring malformed %s=%r (want <mult>@<start>:<end>)",
                       name, raw)
        return None


def _env_slow(name: str) -> Optional[tuple[str, float]]:
    """Parse a ``<replica_name>@<delay_s>`` slow-replica target."""
    raw = os.environ.get(name)
    if not raw:
        return None
    target, _, delay = raw.partition("@")
    try:
        return (target, float(delay))
    except ValueError:
        LOGGER.warning("ignoring malformed %s=%r (want <name>@<delay_s>)",
                       name, raw)
        return None


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    crash_step: Optional[int] = None
    crash_mode: str = "kill"          # "kill" (SIGKILL) or "exc" (raise)
    nan_loss_step: Optional[int] = None
    corrupt_ckpt_step: Optional[int] = None
    save_latency_s: float = 0.0
    handoff_crash_xfer: Optional[int] = None
    handoff_timeout_xfer: Optional[int] = None
    replica_kill: Optional[tuple[str, int]] = None    # (name, router step)
    replica_wedge: Optional[tuple[str, int]] = None
    arrival_burst: Optional[tuple[float, float, float]] = None  # (mult, t0, t1)
    replica_slow: Optional[tuple[str, float]] = None  # (name, delay seconds)
    slice_loss: Optional[tuple[str, int]] = None      # (member, beat count)
    swap_drop_seq: Optional[int] = None               # resident index in swap


def active_faults() -> FaultSpec:
    """Parse the fault env vars (re-read on every call: cheap, and lets tests
    monkeypatch the environment without import-order games)."""
    try:
        latency = float(os.environ.get(ENV_SAVE_LATENCY_S, 0) or 0)
    except ValueError:
        latency = 0.0
    return FaultSpec(
        crash_step=_env_int(ENV_CRASH_STEP),
        crash_mode=os.environ.get(ENV_CRASH_MODE, "kill"),
        nan_loss_step=_env_int(ENV_NAN_LOSS_STEP),
        corrupt_ckpt_step=_env_int(ENV_CORRUPT_CKPT_STEP),
        save_latency_s=latency,
        handoff_crash_xfer=_env_int(ENV_HANDOFF_CRASH_XFER),
        handoff_timeout_xfer=_env_int(ENV_HANDOFF_TIMEOUT_XFER),
        replica_kill=_env_target(ENV_REPLICA_KILL),
        replica_wedge=_env_target(ENV_REPLICA_WEDGE),
        arrival_burst=_env_burst(ENV_ARRIVAL_BURST),
        replica_slow=_env_slow(ENV_REPLICA_SLOW),
        slice_loss=_env_target(ENV_SLICE_LOSS),
        swap_drop_seq=_env_int(ENV_SWAP_DROP_SEQ),
    )


def handoff_fault(xfer_id: int) -> Optional[str]:
    """The injected failure for cross-host handoff transfer ``xfer_id``
    (a monotone 0-indexed id shared by sender and receiver — it IS the
    wire frame's id, so both ends agree on which transfer to break):
    "crash" (torn payload on the wire), "timeout" (receiver sits past the
    sender's ack window), or None."""
    spec = active_faults()
    if spec.handoff_crash_xfer is not None \
            and xfer_id == spec.handoff_crash_xfer:
        return "crash"
    if spec.handoff_timeout_xfer is not None \
            and xfer_id == spec.handoff_timeout_xfer:
        return "timeout"
    return None


def replica_fault(name: str, step: int) -> Optional[str]:
    """The injected failure for replica ``name`` at router iteration
    ``step``: "kill" (instant death, no cleanup), "wedge" (stops stepping
    and heartbeating but stays 'alive'), or None."""
    spec = active_faults()
    if spec.replica_kill is not None and spec.replica_kill == (name, step):
        return "kill"
    if spec.replica_wedge is not None and spec.replica_wedge == (name, step):
        return "wedge"
    return None


def arrival_burst(offset_s: float) -> float:
    """The arrival-rate multiplier at trace offset ``offset_s`` seconds —
    1.0 outside the injected burst window, ``mult`` inside it. The load
    generator folds this into its Poisson gap draws, so the burst is as
    deterministic as the schedule's seed."""
    spec = active_faults()
    if spec.arrival_burst is None:
        return 1.0
    mult, start, end = spec.arrival_burst
    return mult if start <= offset_s < end else 1.0


def replica_slow(name: str) -> float:
    """Injected per-iteration latency inflation (seconds) for replica
    ``name`` — 0.0 unless the slow-replica fault targets it. Unlike
    kill/wedge this is not a one-shot event: the drag applies to every
    iteration while the env var is set (gray failure, not death)."""
    spec = active_faults()
    if spec.replica_slow is not None and spec.replica_slow[0] == name:
        return max(0.0, spec.replica_slow[1])
    return 0.0


def slice_fault(member: str, beat: int) -> bool:
    """True when elastic member ``member`` should die (stop beating, no
    cleanup) at its ``beat``-th membership heartbeat — the slice-loss
    drill. Deterministic in (env, beat count), like every fault here."""
    spec = active_faults()
    return (spec.slice_loss is not None
            and spec.slice_loss[0] == member
            and beat >= spec.slice_loss[1])


def swap_fault(resident_index: int) -> bool:
    """True when the ``resident_index``-th resident sequence exported by
    an engine-generation swap should lose its gathered k/v payload (torn
    device-to-host read) and take the requeue-and-replay path instead."""
    spec = active_faults()
    return (spec.swap_drop_seq is not None
            and resident_index == spec.swap_drop_seq)


def maybe_crash(global_step: int) -> None:
    """Host-side crash fault, called at the end of each loop iteration (after
    any checkpoint for this step has published, so 'crash at step N' leaves
    the step-N checkpoint on disk when N is a checkpoint step)."""
    spec = active_faults()
    if spec.crash_step is None or global_step != spec.crash_step:
        return
    if spec.crash_mode == "exc":
        raise RuntimeError(
            f"injected fault: crash at global step {global_step} "
            f"({ENV_CRASH_STEP}={spec.crash_step})")
    LOGGER.warning("injected fault: SIGKILL at global step %d", global_step)
    os.kill(os.getpid(), signal.SIGKILL)


def maybe_save_latency() -> None:
    spec = active_faults()
    if spec.save_latency_s > 0:
        import time

        LOGGER.warning("injected fault: %.3fs checkpoint save latency",
                       spec.save_latency_s)
        time.sleep(spec.save_latency_s)


def corrupt_checkpoint_dir(ckpt_dir: Path) -> Optional[str]:
    """Flip the leading bytes of the largest file under ``ckpt_dir`` (the
    biggest data file — the array data, not tiny metadata). Returns
    the corrupted file's relative path, or None if the dir has no files."""
    ckpt_dir = Path(ckpt_dir)
    files = [p for p in ckpt_dir.rglob("*") if p.is_file()]
    if not files:
        return None
    victim = max(files, key=lambda p: p.stat().st_size)
    with open(victim, "r+b") as fp:
        chunk = fp.read(_CORRUPT_BYTES)
        fp.seek(0)
        fp.write(bytes(b ^ 0xFF for b in chunk))
    return str(victim.relative_to(ckpt_dir))


def maybe_corrupt_checkpoint(ckpt_dir: Path, step: int) -> None:
    """Checkpoint-corruption fault, applied AFTER the manifest + state.json
    published: the manifest holds the good checksums, the dir holds bad bytes
    — exactly what a post-publish partial write looks like to a restart."""
    spec = active_faults()
    if spec.corrupt_ckpt_step is None or step != spec.corrupt_ckpt_step:
        return
    victim = corrupt_checkpoint_dir(ckpt_dir)
    LOGGER.warning("injected fault: corrupted %s in checkpoint %s",
                   victim, Path(ckpt_dir).name)
