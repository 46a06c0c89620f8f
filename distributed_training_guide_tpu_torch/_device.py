"""The one place that decides which device an entry point runs on."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. Asking for a CUDA device on a machine
    without one raises: no entry point moves to the CPU unless the caller
    asked for it with ``device="cpu"``. ``"meta"`` (shapes only, nothing
    allocated or computed) is what the preflight budget runs on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def runs_plain(t: torch.Tensor) -> bool:
    """True for a tensor no kernel is launched on: a CPU tensor (the plain
    PyTorch path) or a meta tensor (shapes only: it has no memory to hand
    to a kernel, and never lies on the card)."""
    return t.device.type in ("cpu", "meta")
