"""Per-worker error capture (torchelastic's ``@record``) and the
supervisor's failure classification.

Counterpart of ``distributed_training_guide_tpu/launch/errors.py``: on an
uncaught exception, write a machine-readable error file (timestamp,
process index, exception, traceback) before re-raising. Env:
``ERROR_FILE``, else ``TORCHELASTIC_ERROR_FILE``. ``classify_error`` reads
such a file back for ``launch/supervisor.py``: oom, shape/sharding and
non-finite failures are poison pills, anything else is worth a restart.
"""
from __future__ import annotations

import functools
import json
import os
import time
import traceback


def error_file_path() -> str | None:
    return (os.environ.get("ERROR_FILE")
            or os.environ.get("TORCHELASTIC_ERROR_FILE"))


def write_error_file(exc: BaseException, path: str | None = None) -> None:
    path = path or error_file_path()
    if not path:
        return
    payload = {
        "message": {
            "error": repr(exc),
            # format the exception itself: the guard's abort builds the
            # exception outside any active except block
            "traceback": "".join(traceback.format_exception(exc)),
            "process_index": int(os.environ.get(
                "RANK", os.environ.get("PROCESS_ID", 0))),
            "timestamp": int(time.time()),
            "hostname": os.uname().nodename,
            "pid": os.getpid(),
        }
    }
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fp:
            json.dump(payload, fp, indent=2)
    except OSError:
        pass


def record(fn):
    """Decorator: write the error file on any uncaught exception."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 - re-raised after the file
            write_error_file(exc)
            raise

    return wrapper


# ---- failure classification (supervisor restart policy) ---------------------
# Poison pills: failures that are a deterministic function of (config, data,
# code), so a restart reproduces them and the supervisor stops instead of
# burning its restart budget. As in the JAX package, the patterns are matched
# against the error repr only (a traceback names files of unrelated
# modules), and only patterns specific to deterministic failures are kept: a
# rank whose gloo or NCCL peer died reports a collective error ("Connection
# closed by peer", "remote process exited") that must stay transient, since
# restarting after a peer's death is what the supervisor is for. The torch
# wordings after JAX's are the ones JAX's miss: the CPU allocator's refusal,
# and the shape errors of matmul, broadcasting and view.
POISON_PATTERNS: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("oom", ("RESOURCE_EXHAUSTED", "out of memory", "MemoryError",
             "hbm usage", "can't allocate memory")),
    ("shape/sharding", ("not divisible", "divisible by", "NamedSharding",
                        "incompatible shapes", "shape mismatch",
                        "shapes cannot be multiplied",
                        "must match the size of tensor",
                        "is invalid for input of size")),
    ("non-finite", ("NonFiniteLossError",)),
)


def classify_error(payload: dict) -> str | None:
    """Reason string when the error file describes a poison pill, else None
    (unknown or transient: a restart is worth trying). Tolerates foreign
    error files whose "message" is a plain string: the supervisor runs
    arbitrary worker commands."""
    msg = payload.get("message", payload) if isinstance(payload, dict) else {}
    if not isinstance(msg, dict):
        msg = {"error": str(msg)}
    lowered = str(msg.get("error", "")).lower()
    for reason, patterns in POISON_PATTERNS:
        if any(p.lower() in lowered for p in patterns):
            return reason
    return None
