"""Host utilities of the port: timers, MFU, memory stats, logging, process
guards, fault drills, heartbeat and experiment tracking. Exports what the
JAX package's ``utils/__init__.py`` does, plus ``device_sync``."""
from .faults import FaultSpec, active_faults
from .heartbeat import HeartbeatWriter, heartbeat_path, read_heartbeat
from .logging import init_logging, log_dict
from .memory import get_mem_stats
from .mfu import compute_mfu, device_peak_flops, transformer_flops_per_token
from .procguards import (is_process0, process0_first, process_ordered,
                         sync_processes)
from .timers import LocalTimer, device_sync

__all__ = ["FaultSpec", "HeartbeatWriter", "LocalTimer", "active_faults",
           "compute_mfu", "device_peak_flops", "device_sync",
           "get_mem_stats", "heartbeat_path", "init_logging", "is_process0",
           "log_dict", "process0_first", "process_ordered",
           "read_heartbeat", "sync_processes",
           "transformer_flops_per_token"]
