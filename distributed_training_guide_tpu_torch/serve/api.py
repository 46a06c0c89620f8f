"""The offline batch front-end over the engine: ``generate_many`` and the
aggregate ``throughput_stats``.

Counterpart of ``distributed_training_guide_tpu/serve/api.py``. The HTTP
endpoint (``serve_http``) is not part of this slice.
"""
from __future__ import annotations

from typing import Optional

from .scheduler import Request, RequestResult


def generate_many(engine, requests: list,
                  max_iterations: Optional[int] = None) -> list:
    """Run a batch of requests to completion; results in submit order.
    ``max_iterations`` bounds the loop (a stall is a bug, not load)."""
    ids = [engine.submit(r) for r in requests]
    done: dict = {}
    iters = 0
    while engine.has_work:
        for res in engine.step():
            done[res.request_id] = res
        iters += 1
        if max_iterations is not None and iters > max_iterations:
            raise RuntimeError(
                f"generate_many exceeded {max_iterations} iterations with "
                f"{len(ids) - len(done)} requests unfinished — scheduler "
                f"stall (this is a bug, not load)")
    missing = [i for i in ids if i not in done]
    if missing:
        raise RuntimeError(f"engine drained but requests {missing} never "
                           f"finished")
    return [done[i] for i in ids]


def throughput_stats(results: list, wall_s: float, engine) -> dict:
    """Aggregate serving metrics for a completed batch (wall clock of the
    caller's host; ``wall_s`` must end after the device finished)."""
    gen = sum(len(r.generated_ids) for r in results)
    lat = sorted(r.latency_s for r in results)
    ttft = sorted(r.ttft_s for r in results if r.first_token_at)
    es = engine.stats()
    met = sum(1 for r in results if r.finish_reason in ("eos", "length"))
    return {
        "n_requests": len(results),
        "generated_tokens": gen,
        "wall_s": round(wall_s, 4),
        "tokens_per_s": round(gen / wall_s, 2) if wall_s else 0.0,
        "goodput_rps": round(met / wall_s, 3) if wall_s else 0.0,
        "deadline_met": met,
        "deadline_missed_queued": es.get("deadline_missed_queued", 0),
        "deadline_missed_running": es.get("deadline_missed_running", 0),
        "decode_steps": engine.decode_steps,
        "decode_occupancy": es["decode_occupancy"],
        "latency_s_p50": round(lat[len(lat) // 2], 4) if lat else 0.0,
        "latency_s_max": round(lat[-1], 4) if lat else 0.0,
        "ttft_s_p50": round(ttft[len(ttft) // 2], 4) if ttft else 0.0,
        "admission_blocked": es["admission_blocked"],
        "preempted": es["preempted"],
        "prefix_hits": es["prefix_hits"],
        "prefix_tokens_shared": es["prefix_tokens_shared"],
        "cow_forks": es["cow_forks"],
        "deadline_expired": es["deadline_expired"],
        "refused": es["refused"],
    }


__all__ = ["Request", "RequestResult", "generate_many", "throughput_stats"]
