"""Front-ends over the engine: the offline batch API (``generate_many``,
``throughput_stats``) and a stdlib HTTP endpoint with per-token
streaming (``serve_http``).

Counterpart of ``distributed_training_guide_tpu/serve/api.py``.
``serve_http`` is online continuous batching: ONE worker thread owns the
engine and every device call and loops over ``engine.step()``; handler
threads only submit and wait on a per-request event, or, with
``"stream": true``, read a per-request token queue the worker feeds from
``engine.partial_tokens()`` after every iteration (SSE over chunked
transfer-encoding, closed by a ``done`` event with the whole result).
Refusals keep their structure: the scheduler's ``RefusalError`` maps to
its HTTP status (429 backpressure, 503 draining, 400 never runnable)
with its ``reason`` and a ``Retry-After`` header where it has a hint.
``/healthz`` reads the engine's lock-free ``stats()``; ``/readyz`` runs
that snapshot through ``serve/router.py:readiness`` (re-exported here).
Any engine-shaped target serves: a ``ServeEngine``, a ``DisaggEngine``
or a fleet ``Router``.
"""
from __future__ import annotations

import json
import logging
import queue as queue_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .router import readiness  # noqa: F401  (re-exported: /readyz)
from .scheduler import RefusalError, Request, RequestResult

LOGGER = logging.getLogger(__name__)


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
        "spec_steps": es["spec_steps"],
        "spec_tokens_drafted": es["spec_tokens_drafted"],
        "spec_tokens_accepted": es["spec_tokens_accepted"],
        # absent (not 0.0) when nothing was drafted
        **({"spec_acceptance_rate": es["spec_acceptance_rate"]}
           if "spec_acceptance_rate" in es else {}),
        "decode_tokens_per_step": es["decode_tokens_per_step"],
        "decode_horizon": es.get("decode_horizon", 1),
        "host_dispatches": es.get("host_dispatches", 0),
        "tokens_per_dispatch": es.get("tokens_per_dispatch", 0.0),
        "horizon_effective": es.get("horizon_effective", 0.0),
    }


class _EngineWorker(threading.Thread):
    """The one thread that touches the device. Handlers submit (engine
    and futures under one lock) and wait on an event, or, streaming,
    read a per-request token queue the run loop feeds after every
    iteration."""

    def __init__(self, engine):
        super().__init__(daemon=True, name="serve-engine")
        self.engine = engine
        self.lock = threading.Lock()
        self.wakeup = threading.Event()
        self.futures: dict = {}
        self.dead: Optional[BaseException] = None
        self._stopping = False
        # the loop's heartbeat, read lock-free by /readyz: a wedged
        # iteration leaves it stale while /healthz keeps answering
        self.last_loop_at = time.monotonic()

    def submit(self, request: Request, stream: bool = False) -> dict:
        fut = {"event": threading.Event(), "result": None, "error": None,
               "submitted": time.monotonic(), "stream": stream,
               "queue": queue_mod.SimpleQueue() if stream else None,
               "sent": 0}
        with self.lock:
            if self.dead is not None:
                raise RuntimeError(f"engine thread died: {self.dead!r}")
            rid = self.engine.submit(request)   # raises -> 400 / 429 / 503
            self.futures[rid] = fut
        self.wakeup.set()
        return fut

    def _fail_all(self, exc: BaseException) -> None:
        self.dead = exc
        for fut in self.futures.values():
            fut["error"] = exc
            if fut["stream"]:
                fut["queue"].put(("error", exc))
            fut["event"].set()
        self.futures.clear()

    def _push_tokens(self) -> None:
        """Feed per-token deltas to streaming waiters, deduplicated by
        count (``partial_tokens`` lists only grow). Skipped while no
        streaming request is in flight."""
        if not any(f["stream"] for f in self.futures.values()):
            return
        for rid, toks in self.engine.partial_tokens().items():
            fut = self.futures.get(rid)
            if fut is None or not fut["stream"]:
                continue
            for tok in toks[fut["sent"]:]:
                fut["queue"].put(("token", int(tok)))
            fut["sent"] = max(fut["sent"], len(toks))

    def run(self) -> None:
        while not self._stopping:
            self.last_loop_at = time.monotonic()
            try:
                with self.lock:
                    busy = self.engine.has_work
                    finished = self.engine.step() if busy else []
                    if busy:
                        self._push_tokens()
                    for res in finished:
                        fut = self.futures.pop(res.request_id, None)
                        if fut is not None:
                            fut["result"] = res
                            if fut["stream"]:
                                for tok in res.generated_ids[fut["sent"]:]:
                                    fut["queue"].put(("token", int(tok)))
                                fut["queue"].put(("done", res))
                            fut["event"].set()
            except Exception as exc:
                # an engine error fails every waiter loudly: a silent
                # thread death would hang them while /healthz said ok
                LOGGER.exception("serve engine thread died")
                with self.lock:
                    self._fail_all(exc)
                return
            if not busy:
                self.wakeup.wait(timeout=0.05)
                self.wakeup.clear()
        # a clean stop fails whatever is still in flight
        with self.lock:
            if self.futures:
                self._fail_all(RuntimeError("server shutting down"))

    def stop(self, drain: bool = False, timeout_s: float = 30.0) -> None:
        """Stop the worker. ``drain=True`` (SIGTERM): the engine refuses
        new submits with a structured 503 but keeps stepping until every
        in-flight future has its result, for at most ``timeout_s``; what
        is still pending then fails through the clean-stop path."""
        if drain and self.dead is None:
            drain_fn = getattr(self.engine, "drain", None)
            if drain_fn is not None:
                drain_fn()
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                with self.lock:
                    if not self.futures:
                        break
                time.sleep(0.01)
        self._stopping = True
        self.wakeup.set()

    def stats(self) -> dict:
        """Worker and engine snapshot WITHOUT the engine lock (the run
        loop holds it for a whole iteration)."""
        return {
            "ok": self.dead is None,
            **({"error": repr(self.dead)} if self.dead is not None else {}),
            "pending_requests": len(self.futures),
            "loop_age_s": round(time.monotonic() - self.last_loop_at, 4),
            **self.engine.stats(),
        }


def serve_http(engine, host: str = "127.0.0.1", port: int = 8000,
               tokenizer=None):
    """Start the HTTP endpoint; returns (server, worker). Tear down with
    ``server.shutdown()`` and ``worker.stop()`` (``drain=True`` finishes
    the work in flight first). ``port=0`` lets the OS pick one
    (``server.server_address[1]``).

    POST /generate  {"prompt_ids": [...]} or {"prompt": "..."} (needs a
                    tokenizer), and optionally max_new_tokens /
                    temperature / top_k / top_p / seed / eos_id /
                    priority / deadline_s. ``"stream": true`` answers
                    with SSE: one ``data: {"token_id", "index"}`` event a
                    token as it is generated, then ``{"done": true, ...}``
                    with the whole result.
    GET  /healthz   liveness and the engine's lock-free stats().
    GET  /readyz    200 when a router should send traffic here, else 503
                    with the failing reasons (:func:`readiness`)."""
    worker = _EngineWorker(engine)

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 for chunked transfer-encoding (the streaming path)
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            LOGGER.debug("http: " + fmt, *args)

        def _reply(self, code: int, payload: dict,
                   headers: Optional[dict] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

        def _sse(self, payload: dict) -> None:
            self._chunk(b"data: " + json.dumps(payload).encode() + b"\n\n")

        def do_GET(self):
            if self.path == "/healthz":
                # not under worker.lock: the worker holds it a whole
                # iteration, and a probe must answer meanwhile
                return self._reply(200, worker.stats())
            if self.path == "/readyz":
                stats = worker.stats()
                ready, reasons = readiness(
                    stats, loop_age_s=stats.get("loop_age_s"))
                return self._reply(200 if ready else 503,
                                   {"ready": ready, "reasons": reasons})
            return self._reply(404, {"error": "unknown path"})

        def _result_payload(self, res: RequestResult) -> dict:
            payload = {
                "token_ids": res.token_ids,
                "generated_ids": res.generated_ids,
                "finish_reason": res.finish_reason,
                "latency_s": round(res.latency_s, 4),
                "queue_s": round(res.queue_s, 4),
                "ttft_s": round(res.ttft_s, 4),
                "itl_s": round(res.itl_s, 6),
            }
            if tokenizer is not None:
                payload["text"] = tokenizer.decode(res.token_ids)
            return payload

        def do_POST(self):
            if self.path != "/generate":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                prompt_ids = body.get("prompt_ids")
                if prompt_ids is None and body.get("prompt") is not None:
                    if tokenizer is None:
                        raise ValueError(
                            "text 'prompt' needs a tokenizer; pass "
                            "'prompt_ids' for the hermetic path")
                    prompt_ids = tokenizer(body["prompt"])["input_ids"]
                    if prompt_ids and isinstance(prompt_ids[0], list):
                        prompt_ids = prompt_ids[0]
                stream = bool(body.get("stream", False))
                req = Request(
                    prompt_ids=[int(t) for t in (prompt_ids or [])],
                    max_new_tokens=int(body.get("max_new_tokens", 32)),
                    temperature=float(body.get("temperature", 0.0)),
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 1.0)),
                    seed=int(body.get("seed", 0)),
                    eos_id=(int(body["eos_id"])
                            if body.get("eos_id") is not None else None),
                    priority=int(body.get("priority", 0)),
                    deadline_s=(float(body["deadline_s"])
                                if body.get("deadline_s") is not None
                                else None))
                fut = worker.submit(req, stream=stream)
            except RefusalError as exc:
                # the refusal verbatim, with the retry hint as a real
                # Retry-After header (whole seconds, RFC 9110; the float
                # rides in the body)
                headers = None
                if exc.retry_after_s is not None:
                    headers = {"Retry-After":
                               str(max(1, int(-(-exc.retry_after_s // 1))))}
                return self._reply(exc.http_status, {
                    "error": str(exc), "reason": exc.reason, **exc.detail},
                    headers)
            except (ValueError, KeyError, json.JSONDecodeError) as exc:
                return self._reply(400, {"error": str(exc)})
            except RuntimeError as exc:     # the worker already died
                return self._reply(503, {"error": str(exc)})
            if stream:
                return self._stream_response(fut)
            fut["event"].wait()
            if fut["error"] is not None:
                return self._reply(500, {"error": repr(fut["error"])})
            self._reply(200, self._result_payload(fut["result"]))

        def _stream_response(self, fut: dict) -> None:
            """SSE over chunked transfer-encoding, one event a token; the
            headers go out at once."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-store")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            index = 0
            while True:
                kind, item = fut["queue"].get()
                if kind == "token":
                    self._sse({"token_id": item, "index": index})
                    index += 1
                elif kind == "done":
                    self._sse({"done": True, **self._result_payload(item)})
                    break
                else:           # error
                    self._sse({"error": repr(item)})
                    break
            self._chunk(b"")    # the terminating zero-length chunk
            self.close_connection = True

    server = ThreadingHTTPServer((host, port), Handler)
    worker.start()
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="serve-http").start()
    LOGGER.info(f"serving on http://{host}:{server.server_address[1]} "
                f"(n_slots={engine.n_slots})")
    return server, worker


__all__ = ["Request", "RequestResult", "generate_many", "readiness",
           "serve_http", "throughput_stats"]
