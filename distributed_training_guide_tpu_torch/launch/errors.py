"""Per-worker error capture (torchelastic's ``@record``).

Counterpart of ``distributed_training_guide_tpu/launch/errors.py``: on an
uncaught exception, write a machine-readable error file (timestamp,
process index, exception, traceback) before re-raising. Env:
``ERROR_FILE``, else ``TORCHELASTIC_ERROR_FILE``.
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
