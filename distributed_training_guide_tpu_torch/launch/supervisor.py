"""Elastic supervisor: restart-on-failure for training workers.

Counterpart of ``distributed_training_guide_tpu/launch/supervisor.py``, with
the same flags, attempt dirs and restart policy; like it, this module
imports no torch: the worker is whatever command the user gives, usually
``python -m distributed_training_guide_tpu_torch.train ...`` or a
``launch.local`` gang of a chapter. torchrun's ``--max-restarts N``
(reference ``related-topics/elastic-training/README.md``): a failed worker
is restarted, and recovery comes from the normal resume path (``state.json``,
checkpoints, the loader's fast-forward), never from in-process state.
Per-attempt logs and error files live under ``<log_dir>/attempt_<n>/``
(torchrun's ``--redirects 3 --log-dir``).

Restart policy:

- **Exponential backoff** between restarts (``--restart-backoff``, doubled
  per attempt up to ``--backoff-cap``).
- **Poison pills**: after a failure the supervisor reads the worker's error
  file(s) (``ERROR_FILE`` and the per-rank ``.rankN`` files a gang writes)
  and classifies them (``launch/errors.py:classify_error``). An OOM, a
  shape error or a guard-abort NaN is a function of the config, so the
  supervisor stops instead of burning every attempt
  (``--restart-on-poison`` restarts anyway). Error files are unlinked
  before each (re)start and mtime-fenced against the worker's launch, so a
  stale preset ``$ERROR_FILE`` never classifies.

Hang detection: each worker gets ``HEARTBEAT_FILE`` in its attempt dir; the
training loop beats it (``utils/heartbeat.py``), and a beat older than
``--heartbeat-timeout`` seconds means the loop stopped (the collective stall
of the reference's ``diagnosing-errors``), so the worker is SIGKILLed and
the restart policy applies. A worker that never beats falls back to the
growth of its logs.

World renegotiation (``--elastic-dir``, ``launch/elastic.py``): the
supervisor joins a membership directory shared by every slice's
supervisor; a slice lost or gained SIGTERMs the worker, agrees the next
world (the leader proposes, all ack, a barrier'd ``world.json``) and
re-execs the worker on it. ``{world_devices}`` / ``{world_batch}`` in the
worker command are rendered per world (``launch.local --nproc
{world_devices}``: a torch rank is one device) and the env carries
``DTG_WORLD_*``; every renegotiation appends to ``elastic.jsonl``. A
renegotiation is not a failure: it takes no restart and no backoff. The
resume reshards the checkpoint onto the new world
(``checkpoint/reshard.py``).

Usage:
    python -m distributed_training_guide_tpu_torch.launch.supervisor \
        --max-restarts 3 --log-dir ./logs -- \
        python -m distributed_training_guide_tpu_torch.train ...

    # elastic: 2 slices x 2 ranks, global batch held at 8
    python -m distributed_training_guide_tpu_torch.launch.supervisor \
        --elastic-dir /shared/coord --slice-name slice0 \
        --devices-per-slice 2 --elastic-global-batch 8 -- \
        python -m distributed_training_guide_tpu_torch.launch.local \
        --nproc "{world_devices}" -- python -m \
        distributed_training_guide_tpu_torch.chapters.c02_ddp \
        -b "{world_batch}" ...
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from .errors import classify_error


def _error_file_candidates(error_file: Path) -> list[Path]:
    return [error_file] + sorted(
        error_file.parent.glob(error_file.name + ".rank*"))


def _fence_stale_error_files(error_file: Path) -> None:
    """Remove leftover error files BEFORE (re)starting a worker: when the
    operator presets ``$ERROR_FILE`` in the environment, the same path
    persists across attempts AND across supervisor incarnations, so a stale
    payload from a previous run would classify as a poison pill and wrongly
    stop the restart loop. Best-effort — an unremovable file is additionally
    fenced by mtime in ``_poison_reason``."""
    for path in _error_file_candidates(error_file):
        try:
            path.unlink()
        except OSError:
            pass


def _launch_stamp(attempt_dir: Path) -> float:
    """Filesystem timestamp of 'now', taken by touching a sentinel in the
    attempt dir: the fence below compares error-file mtimes against THIS
    (same filesystem, same clock), so an NFS server whose clock skews from
    the supervisor host can't make a genuine poison file look stale.
    Falls back to host time if the touch fails."""
    stamp = attempt_dir / ".launch_stamp"
    try:
        stamp.touch()
        return stamp.stat().st_mtime
    except OSError:
        return time.time()


def _poison_reason(error_file: Path, launched_at: float = 0.0) -> str | None:
    """First poison classification across the attempt's error files (the
    direct ERROR_FILE plus any per-rank suffixed files a gang produced).
    Files whose mtime predates ``launched_at`` are ignored: only errors the
    just-failed worker actually wrote may classify (the unlink fence above
    can fail on odd filesystems/permissions). ``launched_at`` comes from a
    sentinel touched on the same filesystem at launch, so the comparison is
    clock-consistent; a 2s slack absorbs coarse mtime granularity — worker
    writes are strictly after launch."""
    for path in _error_file_candidates(error_file):
        if not path.is_file():
            continue
        try:
            if path.stat().st_mtime < launched_at - 2.0:
                print(f"[supervisor] ignoring stale error file {path.name} "
                      f"(predates this worker's launch)", flush=True)
                continue
            with open(path) as fp:
                payload = json.load(fp)
        except (OSError, json.JSONDecodeError):
            continue
        reason = classify_error(payload)
        if reason:
            msg = (payload.get("message", payload)
                   if isinstance(payload, dict) else {})
            err = msg.get("error", "?") if isinstance(msg, dict) else str(msg)
            return f"{reason}: {err} ({path.name})"
    return None


def _renegotiate(rt, trigger: str) -> bool:
    """Establish the next world after ``trigger``; False means this slice
    was fenced out of the fleet (the caller exits cleanly — its work is
    covered by the new, smaller world's restore)."""
    from .elastic import FencedOutError

    try:
        world = rt.establish(trigger)
    except FencedOutError as exc:
        print(f"[supervisor] fenced out of the fleet ({exc}); exiting",
              flush=True)
        rt.retire()
        return False
    print(f"[supervisor] world {world['world_id']} agreed "
          f"({trigger}): members {world['members']} -> "
          f"{rt.world_devices()} devices", flush=True)
    return True


def run_supervised(cmd: list[str], max_restarts: int, log_dir: Path,
                   heartbeat_timeout: float | None = None, *,
                   restart_backoff: float = 1.0, backoff_cap: float = 60.0,
                   stop_on_poison: bool = True, elastic=None) -> int:
    rt = None
    if elastic is not None:
        from .elastic import ElasticRuntime

        rt = ElasticRuntime(elastic)
        if not _renegotiate(rt, "start"):
            return 0
    attempt = 0          # FAILURES only — renegotiations are free
    incarnation = 0      # every launch gets its own log dir
    while True:
        attempt_dir = log_dir / f"attempt_{incarnation}"
        attempt_dir.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ)
        env.setdefault("ERROR_FILE", str(attempt_dir / "error.json"))
        env["HEARTBEAT_FILE"] = str(attempt_dir / "heartbeat.json")
        _fence_stale_error_files(Path(env["ERROR_FILE"]))
        launch_cmd = cmd
        if rt is not None:
            from .elastic import render_worker_cmd, worker_world_env

            launch_cmd = render_worker_cmd(cmd, rt.world_devices(),
                                           elastic.global_batch)
            worker_world_env(env, rt.world, rt.world_devices())
        stdout = open(attempt_dir / "stdout.log", "ab")
        stderr = open(attempt_dir / "stderr.log", "ab")
        print(f"[supervisor] attempt {incarnation}: "
              f"{' '.join(launch_cmd)} -> {attempt_dir}", flush=True)
        launched_at = _launch_stamp(attempt_dir)
        proc = subprocess.Popen(launch_cmd, env=env, stdout=stdout,
                                stderr=stderr)

        trigger = None
        try:
            if rt is not None:
                trigger, rc = _wait_elastic(proc, attempt_dir,
                                            heartbeat_timeout, rt)
            elif heartbeat_timeout:
                rc = _wait_with_heartbeat(proc, attempt_dir, heartbeat_timeout)
            else:
                rc = proc.wait()
        except KeyboardInterrupt:
            proc.send_signal(signal.SIGTERM)
            proc.wait()
            if rt is not None:
                rt.retire()
            return 130
        finally:
            stdout.close()
            stderr.close()

        incarnation += 1
        if trigger is not None:
            # a renegotiation restart, NOT a failure: the world changed
            # under the worker - agree on the new one and re-exec on it
            # (no attempt consumed, no backoff)
            print(f"[supervisor] attempt {incarnation - 1} stopped for "
                  f"renegotiation ({trigger})", flush=True)
            if not _renegotiate(rt, trigger):
                return 0
            continue
        if rc == 0:
            print(f"[supervisor] attempt {incarnation - 1} exited cleanly",
                  flush=True)
            if rt is not None:
                rt.retire()
            return 0
        print(f"[supervisor] attempt {incarnation - 1} failed rc={rc} "
              f"(error file: {env['ERROR_FILE']})", flush=True)
        if stop_on_poison:
            reason = _poison_reason(Path(env["ERROR_FILE"]), launched_at)
            if reason:
                print(f"[supervisor] non-retryable failure ({reason}); "
                      f"not restarting — fix the config/data and relaunch",
                      flush=True)
                if rt is not None:
                    rt.retire()   # deliberate stop = clean departure: the
                return rc         # fleet shrinks now, not a timeout later
        if attempt >= max_restarts:
            print(f"[supervisor] max restarts ({max_restarts}) exhausted",
                  flush=True)
            if rt is not None:
                rt.retire()
            return rc
        delay = min(backoff_cap, restart_backoff * (2 ** attempt))
        if delay > 0:
            print(f"[supervisor] backing off {delay:.1f}s before attempt "
                  f"{incarnation}", flush=True)
            if rt is None:
                time.sleep(delay)
            else:
                # keep beating membership AND acking proposals through
                # the backoff: a silent backoff longer than the fleet's
                # liveness timeout would read as a lost slice, and a
                # beat without acks would get this live member dropped
                # as a straggler by any renegotiation that lands in the
                # window — both fence a healthy slice over a transient
                # worker crash
                end = time.time() + delay
                while time.time() < end:
                    rt.member.beat()
                    rt.negotiator.maybe_ack()
                    time.sleep(min(0.25, max(0.0, end - time.time())))
        attempt += 1
        if rt is not None:
            # the failure may BE a membership event (e.g. the gang lost a
            # peer slice and collapsed): re-check before relaunching so the
            # restart comes up on the world that actually exists
            change = rt.poll()
            if change is not None and not _renegotiate(rt, change):
                return 0


def _progress_stamp(attempt_dir: Path, logs: list[Path]) -> tuple:
    """Liveness observable for hang detection: the worker-written heartbeat
    file once it exists (the positive 'loop is advancing' signal), log sizes
    until then (legacy heuristic — quiet-but-healthy phases can false-
    positive, which is exactly why the heartbeat file exists)."""
    hb = attempt_dir / "heartbeat.json"
    try:
        st = hb.stat()
        return ("heartbeat", st.st_mtime_ns, st.st_size)
    except OSError:
        return ("logs", sum(p.stat().st_size for p in logs if p.exists()))


def _wait_with_heartbeat(proc: subprocess.Popen, attempt_dir: Path,
                         timeout: float) -> int:
    """Kill the worker if its liveness signal stops for `timeout` seconds
    (hang detection — the collective-stall case where the process never
    exits)."""
    logs = [attempt_dir / "stdout.log", attempt_dir / "stderr.log"]
    last_stamp = None
    last_change = time.time()
    while True:
        rc = proc.poll()
        if rc is not None:
            return rc
        stamp = _progress_stamp(attempt_dir, logs)
        now = time.time()
        if stamp != last_stamp:
            last_stamp, last_change = stamp, now
        elif now - last_change > timeout:
            kind = last_stamp[0] if last_stamp else "logs"
            print(f"[supervisor] no {kind} progress for {timeout}s -> "
                  f"SIGKILL (hang)", flush=True)
            proc.kill()
            return proc.wait() or -9
        time.sleep(min(5.0, timeout / 4))


def _wait_elastic(proc: subprocess.Popen, attempt_dir: Path,
                  heartbeat_timeout: float | None, rt) \
        -> tuple[str | None, int]:
    """The elastic wait loop: the normal hang detection, PLUS a
    membership tick (beat our member file, ack any live proposal, compare
    liveness against the agreed world). A world change SIGTERMs the
    worker and returns ``(trigger, rc)``; a normal exit returns
    ``(None, rc)``."""
    logs = [attempt_dir / "stdout.log", attempt_dir / "stderr.log"]
    last_stamp = None
    last_change = time.time()
    last_tick = 0.0
    while True:
        rc = proc.poll()
        if rc is not None:
            return None, rc
        now = time.time()
        if now - last_tick >= 0.25:
            last_tick = now
            trigger = rt.poll()
            if trigger is not None:
                print(f"[supervisor] membership changed ({trigger}); "
                      f"stopping worker for world renegotiation", flush=True)
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                return trigger, proc.returncode
        if heartbeat_timeout:
            stamp = _progress_stamp(attempt_dir, logs)
            if stamp != last_stamp:
                last_stamp, last_change = stamp, now
            elif now - last_change > heartbeat_timeout:
                kind = last_stamp[0] if last_stamp else "logs"
                print(f"[supervisor] no {kind} progress for "
                      f"{heartbeat_timeout}s -> SIGKILL (hang)", flush=True)
                proc.kill()
                return None, proc.wait() or -9
        time.sleep(0.2)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--max-restarts", type=int, default=3)
    parser.add_argument("--log-dir", default="./supervisor-logs")
    parser.add_argument("--heartbeat-timeout", type=float, default=None,
                        help="seconds without heartbeat-file (or, before the "
                             "first beat, log) progress before declaring a "
                             "hang and killing the worker")
    parser.add_argument("--restart-backoff", type=float, default=1.0,
                        help="seconds before the first restart; doubles per "
                             "attempt up to --backoff-cap. 0 disables")
    parser.add_argument("--backoff-cap", type=float, default=60.0)
    parser.add_argument("--restart-on-poison", action="store_true",
                        help="restart even when the error file classifies as "
                             "a deterministic poison pill (OOM, shape/"
                             "sharding, guard abort) — default is to stop")
    parser.add_argument("--elastic-dir", default=None,
                        help="shared coordination dir: join the elastic "
                             "fleet (membership heartbeats + barrier'd "
                             "world agreement + elastic.jsonl events); a "
                             "slice loss renegotiates the world and "
                             "re-execs the worker instead of crash-looping")
    parser.add_argument("--slice-name", default="slice0",
                        help="this supervisor's member name in the fleet")
    parser.add_argument("--devices-per-slice", type=int, default=1,
                        help="devices each live slice contributes; the "
                             "world total drives {world_devices} and "
                             "DTG_WORLD_DEVICES")
    parser.add_argument("--liveness-timeout", type=float, default=5.0,
                        help="seconds without a membership beat before a "
                             "slice counts as lost")
    parser.add_argument("--elastic-global-batch", type=int, default=None,
                        help="global batch to hold invariant across "
                             "worlds: {world_batch} in the worker command "
                             "renders as global_batch // world_devices")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- followed by the worker command")
    args = parser.parse_args()
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        parser.error("no worker command given "
                     "(use: supervisor [opts] -- cmd ...)")
    elastic = None
    if args.elastic_dir:
        from .elastic import ElasticConfig

        elastic = ElasticConfig(
            coord_dir=Path(args.elastic_dir), member=args.slice_name,
            devices_per_slice=args.devices_per_slice,
            liveness_timeout_s=args.liveness_timeout,
            global_batch=args.elastic_global_batch)
    sys.exit(run_supervised(cmd, args.max_restarts, Path(args.log_dir),
                            args.heartbeat_timeout,
                            restart_backoff=args.restart_backoff,
                            backoff_cap=args.backoff_cap,
                            stop_on_poison=not args.restart_on_poison,
                            elastic=elastic))


if __name__ == "__main__":
    main()
