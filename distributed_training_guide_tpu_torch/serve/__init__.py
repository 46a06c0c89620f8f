"""Serving runtime of the port: iteration-level (Orca) scheduling over a
block-table paged KV cache (PagedAttention) with the hand-written CUDA
paged-attention kernel, refcounted copy-on-write prefix sharing,
optimistic admission with preemption-by-recompute, chunked prefill, int8
KV pages, speculative decoding, fused decode horizons and an HTTP
endpoint.

    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many)
"""
from .api import generate_many, readiness, serve_http, throughput_stats
from .engine import ModelPrograms, ServeEngine
from .kv_pages import PagePool, kv_page_bytes, pages_for_tokens
from .scheduler import (PrefixCache, RefusalError, Request, RequestResult,
                        Scheduler)
from .spec import DraftModelDrafter, Drafter, NgramDrafter

__all__ = [
    "DraftModelDrafter", "Drafter", "ModelPrograms", "NgramDrafter",
    "PagePool", "PrefixCache", "RefusalError", "Request", "RequestResult",
    "Scheduler", "ServeEngine", "generate_many", "kv_page_bytes",
    "pages_for_tokens", "readiness", "serve_http", "throughput_stats",
]
