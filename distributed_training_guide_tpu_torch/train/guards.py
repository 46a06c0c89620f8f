"""Step-level non-finite guards: detect a NaN/Inf loss or grad norm.

Counterpart of ``distributed_training_guide_tpu/train/guards.py``:
- ``skip``: drop the poisoned update. Params and the whole optimizer state
  (the schedule's count included) stay as they were; ``state.step``
  advances. Consecutive skips past a threshold abort.
- ``abort``: fail fast, writing the error file that names the step.

``apply_step_guard`` runs inside ``Trainer.step_fn``. Where the JAX step
computes the update and selects the old state in the compiled program,
the port reads the flag on the host before the update and does not apply
it (one sync per step, under ``skip`` only): the result is the same.
``GuardMonitor`` runs host-side on the banked per-step flags.
"""
from __future__ import annotations

import logging

import torch

LOGGER = logging.getLogger(__name__)

GUARD_POLICIES = ("off", "skip", "abort")


class NonFiniteLossError(RuntimeError):
    """Raised (host-side) when the guard policy says training must stop."""

    def __init__(self, step: int, metrics: dict, reason: str):
        self.step = int(step)
        self.metrics = dict(metrics)
        super().__init__(
            f"non-finite training step {step}: {metrics} ({reason})")


def validate_guard_policy(policy: str) -> str:
    if policy not in GUARD_POLICIES:
        raise ValueError(f"unknown guard policy {policy!r}; "
                         f"choose from {GUARD_POLICIES}")
    return policy


def apply_step_guard(policy: str, metrics: dict) -> tuple:
    """Adds the ``notfinite`` 0/1 metric. Returns (metrics, apply_update):
    under ``skip`` a poisoned step's update must not be applied; under
    ``abort`` it is (``GuardMonitor`` stops the run host-side)."""
    ok = torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"])
    metrics = {**metrics, "notfinite": (~ok).to(torch.float32)}
    return metrics, (bool(ok) if policy == "skip" else True)


class GuardMonitor:
    """Host-side policy enforcement over the per-step ``notfinite`` flags.

    ``observe`` returns True when the step was skipped (callers keep
    skipped losses out of ``running_loss``). Raises ``NonFiniteLossError``,
    after writing the error file, under ``abort`` or once the
    consecutive-skip budget is spent."""

    def __init__(self, policy: str, max_consecutive_skips: int = 5):
        self.policy = validate_guard_policy(policy)
        self.max_consecutive_skips = max_consecutive_skips
        self.consecutive_skips = 0
        self.total_skipped = 0

    @property
    def enabled(self) -> bool:
        return self.policy != "off"

    def _abort(self, step: int, metrics: dict, reason: str) -> None:
        from ..launch.errors import write_error_file

        exc = NonFiniteLossError(step, metrics, reason)
        write_error_file(exc)
        raise exc

    def observe(self, notfinite: float, step: int,
                metrics: dict | None = None) -> bool:
        if not self.enabled or not notfinite:
            self.consecutive_skips = 0
            return False
        metrics = metrics or {}
        if self.policy == "abort":
            self._abort(step, metrics, "guard policy 'abort'")
        self.consecutive_skips += 1
        self.total_skipped += 1
        LOGGER.warning(
            "non-finite step %d skipped (%d consecutive, %d total)",
            step, self.consecutive_skips, self.total_skipped)
        if self.consecutive_skips > self.max_consecutive_skips:
            self._abort(step, metrics,
                        f"{self.consecutive_skips} consecutive skips "
                        f"exceed --guard-max-skips="
                        f"{self.max_consecutive_skips}")
        return True
