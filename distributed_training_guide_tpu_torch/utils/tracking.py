"""Experiment tracking (wandb) — live integration, soft dependency.

Counterpart of ``distributed_training_guide_tpu/utils/tracking.py`` without
jax: the process index comes from ``utils/procguards.py``, and ``wandb`` is
imported only when ``--wandb`` is set.

The reference ships working wandb code in its DeepSpeed variant
(``alternative-frameworks/deepspeed/train_llm.py:110-124,185-186``) and
documents three deployment patterns
(``related-topics/wandb-configurations/README.md:9-63``). This module is the
port's live implementation of those patterns, with "rank" mapped to the
process (``utils/procguards.process_index``):

- ``mode="process0"`` — one run, logged by process 0 only (the default);
- ``mode="per-host"`` — grouped runs, one per host, named ``proc-<i>``;
- resume — the run id is persisted next to ``state.json`` in the experiment
  dir, and re-used with ``resume="allow"`` so a restarted job continues the
  same curve (reference pattern 3).

wandb stays a *soft* dependency (zero-egress testbeds run without it):
``make_tracker`` returns a no-op tracker when the import fails, and the run
never touches the network when ``WANDB_MODE=offline``.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from .procguards import process_index

LOGGER = logging.getLogger(__name__)


class _NoopTracker:
    enabled = False

    def log(self, info: dict, step: Optional[int] = None) -> None:
        pass

    def finish(self) -> None:
        pass


class WandbTracker:
    """Thin wrapper owning the wandb run for this process (if any)."""

    enabled = True

    def __init__(self, wandb, run):
        self._wandb = wandb
        self._run = run

    def log(self, info: dict, step: Optional[int] = None) -> None:
        if self._run is not None:
            self._wandb.log(info, step=step)

    def finish(self) -> None:
        if self._run is not None:
            self._wandb.finish()


def _resume_id(exp_dir: Optional[Path], wandb) -> tuple:
    """(id, resume) — persist the run id beside state.json (pattern 3)."""
    if exp_dir is None:
        return None, None
    id_file = Path(exp_dir) / "wandb_id.txt"
    if id_file.exists():
        return id_file.read_text().strip(), "allow"
    run_id = wandb.util.generate_id()
    id_file.parent.mkdir(parents=True, exist_ok=True)
    id_file.write_text(run_id)
    return run_id, "allow"


def make_tracker(args, *, mode: str = "process0",
                 exp_dir: Optional[Path] = None, config: Optional[dict] = None):
    """Build the tracker for this process. Returns a no-op tracker when
    tracking is disabled or wandb is not installed."""
    if not getattr(args, "wandb", False):
        return _NoopTracker()
    try:
        import wandb
    except ImportError:
        LOGGER.warning("--wandb requested but wandb is not installed; "
                       "continuing without experiment tracking")
        return _NoopTracker()

    project = getattr(args, "wandb_project", None) or "distributed-training-guide-tpu"
    name = getattr(args, "experiment_name", None)
    if mode == "per-host":
        # pattern 2: grouped per-host runs (per-host HBM/throughput curves)
        run = wandb.init(project=project, group=name or "ungrouped",
                         name=f"proc-{process_index()}", config=config)
    elif process_index() == 0:
        # pattern 1 (+3): single resumable run on process 0
        run_id, resume = _resume_id(exp_dir, wandb)
        run = wandb.init(project=project, name=name, id=run_id, resume=resume,
                         config=config)
    else:
        return _NoopTracker()
    return WandbTracker(wandb, run)
