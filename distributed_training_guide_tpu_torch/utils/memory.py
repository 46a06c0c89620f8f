"""Device memory statistics (the reference's ``get_mem_stats``): current
and peak allocated / reserved GB from PyTorch's CUDA caching allocator,
zeros on the CPU so the log dict keeps its keys."""
from __future__ import annotations

from typing import Optional

import torch


def get_mem_stats(device: Optional[torch.device] = None) -> dict:
    device = torch.device("cuda" if device is None else device)
    gb = 1e-9
    if device.type != "cuda":
        return {k: 0.0 for k in ("total_gb", "curr_alloc_gb",
                                 "peak_alloc_gb", "curr_resv_gb",
                                 "peak_resv_gb")}
    return {
        "total_gb": gb * torch.cuda.get_device_properties(device).total_memory,
        "curr_alloc_gb": gb * torch.cuda.memory_allocated(device),
        "peak_alloc_gb": gb * torch.cuda.max_memory_allocated(device),
        "curr_resv_gb": gb * torch.cuda.memory_reserved(device),
        "peak_resv_gb": gb * torch.cuda.max_memory_reserved(device),
    }
