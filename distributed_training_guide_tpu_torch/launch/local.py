"""Single-host multi-process gang launcher.

A copy of ``distributed_training_guide_tpu/launch/local.py`` (host code
only), without ``--devices-per-proc``: a torch rank is one device, and each
rank gets ``LOCAL_RANK`` (its card under ``nccl``) and, as under torchrun,
``OMP_NUM_THREADS=1`` unless the caller set it.

Parity with ``torchrun --standalone --nproc-per-node N`` (reference
``02-distributed-data-parallel/README.md:96``, ``03-job-launchers/README.md``):
spawn N copies of a worker command on this host with the rendezvous env
contract ``launch/distributed.py`` consumes (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), stream rank 0 through, and enforce **fail-fast gang
semantics**: the first worker to exit nonzero takes the whole gang down
(SIGTERM, then SIGKILL after a grace period). That is the local half of
torchrun's elastic agent — the restart-all half is ``launch/supervisor.py``
wrapping this launcher, so a crash of any rank becomes one nonzero gang exit
the supervisor restarts as a unit (reference ``related-topics/
elastic-training/README.md:5-16``).

Usage:
    python -m distributed_training_guide_tpu_torch.launch.local --nproc 4 \
        -- python -m distributed_training_guide_tpu_torch.chapters.c02_ddp \
        -m llama-debug --device cpu ...
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

GRACE_SECONDS = 10.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_gang(
    cmd: list[str],
    nproc: int,
    *,
    port: int | None = None,
    log_dir: str | os.PathLike | None = None,
    env_extra: dict[str, str] | None = None,
    poll_interval: float = 0.2,
) -> int:
    """Run ``nproc`` copies of ``cmd`` as one gang; return the gang exit code.

    0 iff every rank exited 0. On the first nonzero exit the remaining ranks
    are terminated (collectives on the survivors would otherwise stall — the
    reference's NCCL-hang failure mode, ``diagnosing-errors/README.md:7-19``).
    Rank 0 inherits this process's stdout/stderr; other ranks write to
    ``<log_dir>/rank<i>.{out,err}`` (or are silenced without a log_dir).
    """
    port = port or free_port()
    procs: list[subprocess.Popen] = []
    files: list = []
    log_path = Path(log_dir) if log_dir else None
    if log_path:
        log_path.mkdir(parents=True, exist_ok=True)
    try:
        for rank in range(nproc):
            env = dict(os.environ)
            env.update(env_extra or {})
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(nproc), RANK=str(rank),
                       LOCAL_RANK=str(rank))
            if nproc > 1:   # as torchrun: ranks do not fight over the cores
                env.setdefault("OMP_NUM_THREADS", "1")
            if env.get("ERROR_FILE"):   # per-rank error files, like torchelastic
                env["ERROR_FILE"] = f"{env['ERROR_FILE']}.rank{rank}"
            if rank == 0:
                stdout = stderr = None      # stream through
            elif log_path:
                stdout = open(log_path / f"rank{rank}.out", "ab")
                stderr = open(log_path / f"rank{rank}.err", "ab")
                files += [stdout, stderr]
            else:
                stdout = stderr = subprocess.DEVNULL
            procs.append(subprocess.Popen(cmd, env=env, stdout=stdout,
                                          stderr=stderr))

        gang_rc = 0
        while True:
            rcs = [p.poll() for p in procs]
            failed = [rc for rc in rcs if rc not in (None, 0)]
            if failed:
                gang_rc = failed[0]
                break
            if all(rc == 0 for rc in rcs):
                break
            time.sleep(poll_interval)
        return gang_rc
    finally:
        # runs on EVERY exit path — normal (no-op: all ranks reaped), gang
        # failure, spawn errors, or the launcher itself dying (SIGINT,
        # exception): spawned ranks must never be orphaned blocked in
        # rendezvous/collectives waiting for peers that will never come
        _terminate_survivors(procs)
        for f in files:
            f.close()


def _terminate_survivors(procs: list[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + GRACE_SECONDS
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def main():
    parser = argparse.ArgumentParser(
        description="single-host gang launcher (torchrun --standalone analogue)")
    parser.add_argument("--nproc", type=int, required=True)
    parser.add_argument("--port", type=int, default=None,
                        help="rendezvous port (default: pick a free one)")
    parser.add_argument("--log-dir", default=None,
                        help="per-rank logs for ranks > 0 (rank 0 streams)")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- followed by the worker command")
    args = parser.parse_args()
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        parser.error("no worker command given (use: local [opts] -- cmd ...)")
    # a supervisor stops the gang with SIGTERM (a world renegotiation):
    # exit through launch_gang's finally, which takes the ranks down too
    signal.signal(signal.SIGTERM,
                  lambda *_: sys.exit(128 + signal.SIGTERM))
    sys.exit(launch_gang(cmd, args.nproc, port=args.port,
                         log_dir=args.log_dir))


if __name__ == "__main__":
    main()
