"""Host utilities of the port: timers, MFU, memory stats, logging."""
from .logging import init_logging
from .memory import get_mem_stats
from .mfu import compute_mfu, device_peak_flops, transformer_flops_per_token
from .timers import LocalTimer, device_sync

__all__ = ["LocalTimer", "compute_mfu", "device_peak_flops", "device_sync",
           "get_mem_stats", "init_logging", "transformer_flops_per_token"]
