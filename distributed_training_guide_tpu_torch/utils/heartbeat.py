"""Worker-written heartbeat files for hang detection.

A copy of ``distributed_training_guide_tpu/utils/heartbeat.py`` (standard
library only).

The supervisor's original hang heuristic watches the worker's *log sizes* —
the process form of the reference's "power draw dropped" signal
(``diagnosing-errors/README.md``). That heuristic false-positives on healthy
quiet phases (``--log-freq 100`` at a slow step time looks exactly like a
hang) and false-negatives on chatty death spirals. The heartbeat file is the
positive signal: the training loop writes ``{"step", "time"}`` to
``$HEARTBEAT_FILE`` every iteration (throttled), so "file stopped changing"
means "the loop stopped", not "the loop went quiet".

``launch/supervisor.py`` points ``HEARTBEAT_FILE`` at
``<attempt_dir>/heartbeat.json`` and prefers it over log sizes as soon as it
appears; workers that predate the heartbeat (or crash before the first beat)
fall back to the log-size heuristic automatically.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional

HEARTBEAT_ENV = "HEARTBEAT_FILE"


def heartbeat_path() -> Optional[str]:
    return os.environ.get(HEARTBEAT_ENV) or None


def read_heartbeat(path: Path) -> Optional[dict]:
    try:
        with open(path) as fp:
            payload = json.load(fp)
    except (OSError, json.JSONDecodeError):
        return None
    return payload if isinstance(payload, dict) else None


class HeartbeatMonitor:
    """Reader side of the heartbeat file: the age of the most recent
    beat, for anyone deciding whether a worker is wedged. The training
    supervisor open-codes this check against attempt dirs; the serving
    fabric's router (``serve/router.py``) consumes it through this class
    — one definition of "stale" per file, not per caller."""

    def __init__(self, path):
        self.path = Path(path)

    def last_beat(self) -> Optional[dict]:
        return read_heartbeat(self.path)

    def age_s(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds since the last beat, or None when no beat has ever
        been written (a replica that died before its first beat falls to
        the caller's no-beat-yet grace policy, not to a fake huge age)."""
        payload = self.last_beat()
        if payload is None or "time" not in payload:
            return None
        return (time.time() if now is None else now) - float(payload["time"])


class HeartbeatWriter:
    """Throttled heartbeat writer; a no-op unless ``HEARTBEAT_FILE`` is set
    (or a path is given), so the train loop calls it unconditionally."""

    def __init__(self, path: Optional[str] = None, min_interval_s: float = 1.0):
        self.path = Path(path) if path else (
            Path(heartbeat_path()) if heartbeat_path() else None)
        self.min_interval_s = min_interval_s
        self._last = 0.0

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def beat(self, step: int, force: bool = False) -> bool:
        """Write the heartbeat if due; returns whether a write happened."""
        if self.path is None:
            return False
        now = time.time()
        if not force and now - self._last < self.min_interval_s:
            return False
        tmp = self.path.with_name(self.path.name + ".tmp")
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(tmp, "w") as fp:
                json.dump({"step": int(step), "time": now, "pid": os.getpid()}, fp)
            os.replace(tmp, self.path)  # atomic: readers never see torn JSON
        except OSError:
            return False  # heartbeat is advisory; never take the loop down
        self._last = now
        return True
