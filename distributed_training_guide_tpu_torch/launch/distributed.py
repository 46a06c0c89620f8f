"""Process-group initialization.

Counterpart of ``distributed_training_guide_tpu/launch/distributed.py``,
with the same env contract (the reference's torchrun variables, or the
JAX names):

    COORDINATOR_ADDRESS (or MASTER_ADDR:MASTER_PORT)
    NUM_PROCESSES       (or WORLD_SIZE)
    PROCESS_ID          (or RANK)
    LOCAL_RANK          (the card of this process; default: PROCESS_ID)

A torch rank is one device: ``nccl`` on ``cuda:LOCAL_RANK``, ``gloo`` only
when the caller passes ``device="cpu"``. With none of the variables set
the run is a world of one on an in-process store. Where the JAX function
logs a failed initialization and falls through, this one raises: a run
that then trained alone would hide the gang it was started in.
"""
from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from .._device import resolve_device

LOGGER = logging.getLogger(__name__)

_PG_TIMEOUT = datetime.timedelta(seconds=600)


def _env_contract() -> tuple:
    coord = os.environ.get("COORDINATOR_ADDRESS")
    if coord is None and os.environ.get("MASTER_ADDR"):
        coord = (f"{os.environ['MASTER_ADDR']}:"
                 f"{os.environ.get('MASTER_PORT', '29500')}")
    nproc = os.environ.get("NUM_PROCESSES") or os.environ.get("WORLD_SIZE")
    pid = os.environ.get("PROCESS_ID") or os.environ.get("RANK")
    return coord, nproc, pid


def maybe_initialize_distributed(device=None) -> None:
    """Idempotent: start the default process group from the env contract
    (see the module docstring), on ``cuda`` unless ``device="cpu"``."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    coord, nproc, pid = _env_contract()
    given = [v is not None for v in (coord, nproc, pid)]
    if any(given) and not all(given):
        raise RuntimeError(
            f"incomplete distributed env: coordinator={coord!r}, "
            f"world size={nproc!r}, rank={pid!r}; set all three (torchrun "
            f"and launch.local do) or none")
    if not any(given):
        coord, nproc, pid = None, "1", "0"
    rank, world = int(pid), int(nproc)
    kw = {}
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if coord is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=_PG_TIMEOUT, **kw)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                rank=rank, world_size=world,
                                timeout=_PG_TIMEOUT, **kw)
    LOGGER.info("distributed: process %d/%d, %s on %s", rank, world,
                backend, coord or "an in-process store")
