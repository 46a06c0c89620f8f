"""Host utilities of the port: timers, MFU, memory stats, logging, process
guards, fault drills, heartbeat and experiment tracking."""
from .logging import init_logging
from .memory import get_mem_stats
from .mfu import compute_mfu, device_peak_flops, transformer_flops_per_token
from .procguards import is_process0, sync_processes
from .timers import LocalTimer, device_sync

__all__ = ["LocalTimer", "compute_mfu", "device_peak_flops", "device_sync",
           "get_mem_stats", "init_logging", "is_process0", "sync_processes",
           "transformer_flops_per_token"]
