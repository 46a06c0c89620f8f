"""Serving runtime of the port: iteration-level (Orca) scheduling over a
block-table paged KV cache (PagedAttention) with the hand-written CUDA
paged-attention kernel, refcounted copy-on-write prefix sharing,
optimistic admission with preemption-by-recompute, chunked prefill, int8
KV pages, speculative decoding, fused decode horizons and an HTTP
endpoint; and the serve fleet over it: the KV-page wire
(``serve/transport.py``), a host-RAM KV tier (``serve/tiering.py``),
disaggregated prefill / decode (``serve/disagg.py``), the replica router
with heartbeat fencing and bitwise replay (``serve/router.py``), elastic
engine generations (``serve/elastic.py``), the SLO controller
(``serve/controller.py``) and the open-loop load generator
(``serve/loadgen.py``).

    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, DisaggEngine, generate_many)
"""
from .api import generate_many, readiness, serve_http, throughput_stats
from .controller import SLO, Controller
from .disagg import DisaggEngine
from .elastic import new_generation, spawn_like, swap_engine, swap_generation
from .engine import ModelPrograms, ServeEngine
from .kv_pages import PagePool, kv_page_bytes, pages_for_tokens
from .loadgen import (LoadReport, Scenario, build_schedule, default_scenarios,
                      poisson_arrivals, run_open_loop, saturation_sweep,
                      trace_arrivals)
from .router import Replica, Router, local_fleet, prefix_affinity_key
from .scheduler import (PrefixCache, RefusalError, Request, RequestResult,
                        Scheduler)
from .spec import DraftModelDrafter, Drafter, NgramDrafter

__all__ = [
    "Controller", "DisaggEngine", "Drafter", "DraftModelDrafter",
    "LoadReport", "ModelPrograms", "NgramDrafter", "PagePool",
    "PrefixCache", "RefusalError", "Replica", "Request", "RequestResult",
    "Router", "SLO", "Scenario", "Scheduler", "ServeEngine",
    "build_schedule", "default_scenarios", "generate_many",
    "kv_page_bytes", "local_fleet", "new_generation", "pages_for_tokens",
    "poisson_arrivals", "prefix_affinity_key", "readiness",
    "run_open_loop", "saturation_sweep", "serve_http", "spawn_like",
    "swap_engine", "swap_generation", "throughput_stats",
    "trace_arrivals",
]
