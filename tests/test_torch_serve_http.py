"""The port's front-ends on the CPU: ``serve_http`` (the worker thread,
``/generate`` with and without SSE streaming, ``/healthz``, ``/readyz``,
structured refusals with ``Retry-After``, drain, a failing engine),
``readiness`` against the JAX package's, ``max_queue`` and
``validate_prefill_buckets`` against JAX's, and the serve CLI's flags
(``--speculate``, ``--max-queue``, ``--priority``, ``--deadline-s``,
``--prompt``, ``--pretrained``, ``--http-port``, the refused fleet
flags). Every HTTP call carries a timeout, so a hang fails the test and
does not stall the run; every server is shut down in ``finally``."""
import contextlib
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.serve import ServeEngine as JEngine
from distributed_training_guide_tpu.serve.engine import \
    validate_prefill_buckets as jvalidate
from distributed_training_guide_tpu.serve.router import \
    readiness as jreadiness
from distributed_training_guide_tpu_torch.serve import (
    RefusalError, Request, ServeEngine, generate_many, readiness,
    serve_http)
from distributed_training_guide_tpu_torch.serve.engine import \
    validate_prefill_buckets
from test_torch_spec import bridged
import torch_threads  # noqa: F401  (one torch thread a test process)

TIMEOUT = 60              # seconds, every HTTP call
ENGINE = dict(n_slots=2, page_size=4, max_len=16)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    _, _, tb, tparams = bridged("llama-debug")
    return tb, tparams


class Paused(ServeEngine):
    """An engine the worker does not step while ``paused``: what HTTP
    submits stays queued, deterministically."""

    paused = True

    @property
    def has_work(self) -> bool:
        return not self.paused and self.scheduler.has_work


@contextlib.contextmanager
def served(engine, **kw):
    server, worker = serve_http(engine, port=0, **kw)
    try:
        yield server.server_address[1], worker
    finally:
        worker.stop()
        server.shutdown()
        server.server_close()
        worker.join(timeout=TIMEOUT)


def call(port, method, path, body=None):
    """(status, headers, parsed body) of one call."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def stream(port, body):
    """The token events and the done event of a streamed /generate."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/generate", json.dumps({**body,
                                                      "stream": True}))
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/event-stream"
        events = [json.loads(line[6:]) for line in
                  resp.read().decode().splitlines()
                  if line.startswith("data: ")]
    finally:
        conn.close()
    tokens = [e["token_id"] for e in events if "token_id" in e]
    assert [e["index"] for e in events if "token_id" in e] == list(
        range(len(tokens)))
    return tokens, events[-1]


def test_generate_stream_health_ready(model):
    """Three requests (one streamed) each equal to ``generate_many``'s
    tokens; /healthz and /readyz answered."""
    tb, tparams = model
    reqs = [dict(prompt_ids=[3, 17, 42], max_new_tokens=6, seed=0),
            dict(prompt_ids=[5, 6], max_new_tokens=5, seed=1,
                 temperature=0.8, top_p=0.9),
            dict(prompt_ids=[9, 8, 7, 9, 8], max_new_tokens=7, seed=2)]
    want = [r.generated_ids for r in generate_many(
        ServeEngine(tb, tparams, device="cpu", **ENGINE),
        [Request(**r) for r in reqs])]
    eng = ServeEngine(tb, tparams, device="cpu", **ENGINE)
    with served(eng) as (port, worker):
        status, _, health = call(port, "GET", "/healthz")
        assert status == 200 and health["ok"] is True
        for key in ("queued", "pool_occupancy", "pages_free", "refused",
                    "spec_steps", "host_dispatches", "loop_age_s"):
            assert key in health
        assert call(port, "GET", "/readyz")[::2] == (
            200, {"ready": True, "reasons": []})
        for i in (0, 1):
            status, _, body = call(port, "POST", "/generate", reqs[i])
            assert status == 200 and body["generated_ids"] == want[i]
            assert body["finish_reason"] == "length"
            assert body["ttft_s"] <= body["latency_s"]
        tokens, done = stream(port, reqs[2])
        assert tokens == want[2] and done["done"] is True
        assert done["generated_ids"] == want[2]
        assert call(port, "GET", "/nope")[0] == 404
        assert call(port, "POST", "/nope", {})[0] == 404


def test_refusal_bodies_and_retry_after(model):
    """400 for a request that could never run, 429 with its reason, the
    queue depth and a whole-second ``Retry-After`` for a full queue, 503
    with ``Retry-After`` while draining; the refusals counted by
    reason."""
    tb, tparams = model
    eng = Paused(tb, tparams, device="cpu", max_queue=1, n_slots=1,
                 page_size=4, max_len=16)
    with served(eng) as (port, worker):
        status, _, body = call(port, "POST", "/generate",
                               {"prompt_ids": [], "max_new_tokens": 2})
        assert status == 400 and body["reason"] == "empty_prompt"
        assert "queue_depth" in body
        status, _, body = call(port, "POST", "/generate",
                               {"prompt_ids": [3] * 20,
                                "max_new_tokens": 20})
        assert status == 400 and body["reason"] == "context_too_long"
        status, _, body = call(port, "POST", "/generate",
                               {"prompt": "hello"})
        assert status == 400 and "tokenizer" in body["error"]
        # the worker does not step: one queued request fills the queue
        with worker.lock:
            eng.submit(Request(prompt_ids=[3], max_new_tokens=4))
        status, headers, body = call(port, "POST", "/generate",
                                     {"prompt_ids": [5],
                                      "max_new_tokens": 2})
        assert status == 429 and body["reason"] == "queue_full"
        assert body["queue_depth"] == 1
        assert int(headers["Retry-After"]) >= 1
        eng.drain()
        status, headers, body = call(port, "POST", "/generate",
                                     {"prompt_ids": [5],
                                      "max_new_tokens": 2})
        assert status == 503 and body["reason"] == "draining"
        assert int(headers["Retry-After"]) >= 1
        status, _, ready = call(port, "GET", "/readyz")
        assert status == 503 and "draining" in ready["reasons"]
    refused = eng.stats()["refused"]
    assert refused["empty_prompt"] == refused["queue_full"] == 1
    assert refused["draining"] == 1


def test_stop_drain_finishes_in_flight_then_refuses(model):
    tb, tparams = model
    eng = Paused(tb, tparams, device="cpu", **ENGINE)
    server, worker = serve_http(eng, port=0)
    port = server.server_address[1]
    out = {}

    def client():
        out["r"] = call(port, "POST", "/generate",
                        {"prompt_ids": [3, 17], "max_new_tokens": 10})

    try:
        t = threading.Thread(target=client)
        t.start()
        deadline = time.monotonic() + TIMEOUT
        while not worker.futures and time.monotonic() < deadline:
            time.sleep(0.005)
        assert worker.futures, "the request never reached the worker"
        eng.paused = False
        worker.stop(drain=True, timeout_s=TIMEOUT)
        t.join(timeout=TIMEOUT)
        worker.join(timeout=TIMEOUT)
        status, _, body = out["r"]
        assert status == 200 and len(body["generated_ids"]) == 10
        assert eng.draining and not worker.is_alive()
        with pytest.raises(RefusalError, match="draining"):
            eng.submit(Request(prompt_ids=[3], max_new_tokens=2))
    finally:
        server.shutdown()
        server.server_close()


def test_engine_error_fails_every_waiter_loudly(model):
    tb, tparams = model

    class Broken(ServeEngine):
        def step(self):
            raise RuntimeError("device fell over")

    eng = Broken(tb, tparams, device="cpu", **ENGINE)
    with served(eng) as (port, worker):
        status, _, body = call(port, "POST", "/generate",
                               {"prompt_ids": [3], "max_new_tokens": 2})
        assert status == 500 and "device fell over" in body["error"]
        worker.join(timeout=TIMEOUT)
        status, _, health = call(port, "GET", "/healthz")
        assert status == 200 and health["ok"] is False
        status, _, ready = call(port, "GET", "/readyz")
        assert status == 503 and "engine_dead" in ready["reasons"]
        status, _, body = call(port, "POST", "/generate",
                               {"prompt_ids": [3], "max_new_tokens": 2})
        assert status == 503 and "died" in body["error"]


def test_readiness_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        stats = {"ok": bool(rng.random() < 0.9),
                 "draining": bool(rng.random() < 0.2),
                 "n_slots": int(rng.integers(1, 9)),
                 "queued": int(rng.integers(0, 80)),
                 "max_queue": [None, 0, 4, 64][int(rng.integers(4))],
                 "pages_free": int(rng.integers(0, 12))}
        kw = [{}, {"loop_age_s": float(rng.random() * 10)},
              {"queue_watermark": 3, "min_free_pages": 2}][
            int(rng.integers(3))]
        assert readiness(stats, **kw) == jreadiness(stats, **kw)


def test_max_queue_and_prefill_buckets_against_jax(model):
    tb, tparams = model
    from distributed_training_guide_tpu.models import get_model as jget

    import jax.numpy as jnp

    eng = ServeEngine(tb, tparams, device="cpu", max_queue=1, n_slots=1,
                      page_size=4, max_len=16)
    eng.submit(Request(prompt_ids=[3], max_new_tokens=2))
    with pytest.raises(RefusalError) as exc:
        eng.submit(Request(prompt_ids=[4], max_new_tokens=2))
    assert exc.value.reason == "queue_full" and exc.value.http_status == 429
    assert eng.stats()["max_queue"] == 1
    for buckets, kw in (((4, 8), dict(max_pages=4, page_size=4,
                                      max_model_len=16)),
                        ((4, 32), dict(max_pages=4, page_size=4,
                                       max_model_len=16)),
                        ((16, 4, 8), dict(max_pages=4, page_size=4,
                                          max_model_len=16))):
        try:
            want = jvalidate(buckets, **kw)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                validate_prefill_buckets(buckets, **kw)
            assert str(got.value) == str(e)
        else:
            assert validate_prefill_buckets(buckets, **kw) == want
    with pytest.raises(ValueError, match="cannot cover"):
        ServeEngine(tb, tparams, device="cpu", prefill_buckets=(4,),
                    **ENGINE)
    with pytest.raises(ValueError, match="cannot cover"):
        JEngine(jget("llama-debug", dtype=jnp.float32), bridged(
            "llama-debug")[1], prefill_buckets=(4,), **ENGINE)
    a = generate_many(ServeEngine(tb, tparams, device="cpu",
                                  prefill_buckets=(16, 12), **ENGINE),
                      [Request(prompt_ids=[3, 17, 42], max_new_tokens=4)])
    b = generate_many(ServeEngine(tb, tparams, device="cpu", **ENGINE),
                      [Request(prompt_ids=[3, 17, 42], max_new_tokens=4)])
    assert a[0].token_ids == b[0].token_ids


def cli(argv) -> list:
    """The serve CLI's JSON lines."""
    from distributed_training_guide_tpu_torch.serve.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv + ["--device", "cpu"])
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def test_cli_speculate_queue_priority_deadline():
    base = ["-m", "llama-debug", "--prompt-ids", "1,2,3,1,2,3,1,2",
            "--prompt-ids", "5,5,5,5", "--steps", "16", "--n-slots", "2"]
    off = cli(base)
    on = cli(base + ["--speculate", "ngram", "--spec-k", "3", "--max-queue",
                     "4", "--priority", "2", "--deadline-s", "60"])
    tokens = [line["token_ids"] for line in off if "token_ids" in line]
    assert [line["token_ids"] for line in on if "token_ids" in line] == \
        tokens and len(tokens) == 2
    stats = on[-1]["stats"]
    assert stats["spec_tokens_drafted"] > 0 and stats["deadline_met"] == 2
    draft = cli(base + ["--speculate", "draft", "--draft-model",
                        "llama-debug"])
    assert [line["token_ids"] for line in draft
            if "token_ids" in line] == tokens
    assert draft[-1]["stats"]["spec_tokens_drafted"] > 0
    horizon = cli(base + ["--decode-horizon", "4"])
    assert [line["token_ids"] for line in horizon
            if "token_ids" in line] == tokens
    assert horizon[0]["kv_report"]["decode_horizon"] == 4
    for flag in (["--disagg"], ["--replicas", "2"],
                 ["--disagg", "--transport", "cross_host",
                  "--prefill-slots", "2"]):
        fleet = cli(base + flag)
        assert [line["token_ids"] for line in fleet
                if "token_ids" in line] == tokens, flag
    # --tp N runs one process per rank (tests/test_torch_serve_plan.py);
    # alone it names the launch command, and --shard-kv needs --tp > 1
    with pytest.raises(SystemExit, match="launch.local --nproc 2"):
        cli(base + ["--tp", "2"])
    with pytest.raises(SystemExit,
                       match="--shard-kv needs a tp mesh: pass --tp > 1"):
        cli(base + ["--shard-kv"])
    with pytest.raises(SystemExit, match="--replicas"):
        cli(base + ["--replicas", "2", "--disagg"])
    with pytest.raises(SystemExit, match="draft-model"):
        cli(base + ["--speculate", "draft"])


def test_cli_prompt_through_the_byte_tokenizer():
    lines = cli(["-m", "llama-debug", "--prompt", "hi there", "--steps",
                 "4"])
    [res] = [line for line in lines if "token_ids" in line]
    assert res["token_ids"][:8] == list(b"hi there")
    assert isinstance(res["text"], str) and res["text"].startswith(
        "hi there")


def test_cli_pretrained_hf_checkpoint(tmp_path):
    """``-m hf:<dir> --pretrained <converted>``: the served tokens are the
    engine's on the converted weights, not a random init's."""
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("safetensors")
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.models.hf_convert import (
        convert_hf_checkpoint, load_pretrained)

    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=False))
    model.save_pretrained(tmp_path / "hf", safe_serialization=True)
    name = f"hf:{tmp_path / 'hf'}"
    convert_hf_checkpoint(tmp_path / "hf", tmp_path / "conv", name)
    lines = cli(["-m", name, "--pretrained", str(tmp_path / "conv"),
                 "--prompt-ids", "3,17,42", "--steps", "6"])
    [res] = [line for line in lines if "token_ids" in line]
    bundle = get_model(name, dtype=torch.float32)
    params = load_pretrained(bundle, None, tmp_path / "conv", device="cpu")
    want = generate_many(ServeEngine(bundle, params, device="cpu",
                                     n_slots=4),
                         [Request(prompt_ids=[3, 17, 42], max_new_tokens=6)])
    assert res["token_ids"] == want[0].token_ids
    random = cli(["-m", name, "--prompt-ids", "3,17,42", "--steps", "6"])
    assert [line for line in random if "token_ids" in line][0][
        "token_ids"] != res["token_ids"]


def test_cli_http_port_serves_until_sigterm_then_drains():
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_training_guide_tpu_torch.serve",
         "-m", "llama-debug", "--http-port", "0", "--device", "cpu",
         "--n-slots", "2"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        lines = []
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(json.loads(line))
            if "serving" in lines[-1]:
                break
        assert "serving" in lines[-1], (lines, proc.stderr.read())
        port = int(lines[-1]["serving"].rsplit(":", 1)[1])
        status, _, body = call(port, "POST", "/generate",
                               {"prompt_ids": [3, 17, 42],
                                "max_new_tokens": 5})
        assert status == 200 and len(body["generated_ids"]) == 5
        assert call(port, "GET", "/healthz")[0] == 200
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0
        assert json.loads(out.splitlines()[-1]) == {"draining": True}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=TIMEOUT)
