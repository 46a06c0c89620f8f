"""Serving runtime of the port: iteration-level (Orca) scheduling over a
block-table paged KV cache (PagedAttention) with the hand-written CUDA
paged-attention kernel, refcounted copy-on-write prefix sharing,
optimistic admission with preemption-by-recompute, chunked prefill and
int8 KV pages.

    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many)
"""
from .api import generate_many, throughput_stats
from .engine import ModelPrograms, ServeEngine
from .kv_pages import PagePool, kv_page_bytes, pages_for_tokens
from .scheduler import (PrefixCache, RefusalError, Request, RequestResult,
                        Scheduler)

__all__ = [
    "ModelPrograms", "PagePool", "PrefixCache", "RefusalError", "Request",
    "RequestResult", "Scheduler", "ServeEngine", "generate_many",
    "kv_page_bytes", "pages_for_tokens", "throughput_stats",
]
