"""The port's disaggregated prefill / decode pair (``serve/disagg.py``)
against the JAX package's on the CPU, llama-debug at 2 layers (fp32
weights carried across by the bridge): same-host (one pool, a refcount
move) and cross-host (two pools, the pages' bytes over the CRC-framed
wire), fp32 and int8 KV, greedy tokens equal to JAX's ``DisaggEngine``
and to the port's own monolith on the same traffic; same host moves 0
bytes, cross host the handoff's pages x page bytes plus the frame's
header; a torn or stalled transfer requeues and replays to the same
tokens; both pools audit ``free + held + cached == capacity`` after every
iteration. Tolerance: none, tokens are compared exactly."""
import pytest

from distributed_training_guide_tpu.serve import Request as JRequest
from distributed_training_guide_tpu.serve.api import \
    generate_many as jgenerate
from distributed_training_guide_tpu.serve.disagg import \
    DisaggEngine as JDisagg
from distributed_training_guide_tpu_torch.serve import (Request, ServeEngine,
                                                        generate_many)
from distributed_training_guide_tpu_torch.serve.disagg import DisaggEngine
from distributed_training_guide_tpu_torch.serve.kv_pages import \
    kv_page_bytes
from distributed_training_guide_tpu_torch.utils import faults
import torch_threads  # noqa: F401  (one torch thread a test process)
from torch_fleet import bridged, drive, fresh, reference

PAIR = dict(n_slots=2, n_prefill_slots=1, page_size=4, max_len=24)


def _specs(n: int = 5):
    return [dict(prompt_ids=[3 + i, 17, 42, 9, 11][:2 + (i % 4)],
                 max_new_tokens=3 + (i % 4), seed=i) for i in range(n)]


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("transport", ["same_host", "cross_host"])
def test_pair_tokens_equal_jax_pair_and_monolith(transport, kv_dtype):
    jb, jparams, tb, tparams = bridged()
    specs = _specs()
    jeng = JDisagg(jb, jparams, transport=transport, kv_dtype=kv_dtype,
                   **PAIR)
    jres = jgenerate(jeng, [JRequest(**s) for s in specs])
    teng = DisaggEngine(tb, tparams, device="cpu", transport=transport,
                        kv_dtype=kv_dtype, **PAIR)
    ids, done = drive(teng, [Request(**s) for s in specs])
    mono = generate_many(
        ServeEngine(tb, tparams, device="cpu", kv_dtype=kv_dtype,
                    n_slots=2, page_size=4, max_len=24),
        [Request(**s) for s in specs])
    for rid, j, m in zip(ids, jres, mono):
        assert done[rid].token_ids == j.token_ids == m.token_ids
    s, js = teng.stats(), jeng.stats()
    assert s["handoff_delivered"] == js["handoff_delivered"] == len(specs)
    assert s["handoff_pages_transferred"] == js["handoff_pages_transferred"]
    moved = s["handoff_bytes_copied"]
    if transport == "same_host":
        assert moved == 0 == js["handoff_bytes_copied"]
    else:
        payload = s["handoff_pages_transferred"] * kv_page_bytes(
            tb.config, page_size=4, kv_dtype=kv_dtype)
        # the frames carry the pages' bytes plus a JSON header and a CRC
        assert payload < moved < payload + 2048 * s["handoff_transfers"]
        assert teng.decode_pool.n_free == teng.decode_pool.capacity
    teng.close()
    jeng.close()


@pytest.mark.parametrize("transport", ["same_host", "cross_host"])
def test_stats_and_kv_report_keys_match_jax(transport):
    jb, jparams, tb, tparams = bridged()
    jeng = JDisagg(jb, jparams, transport=transport, **PAIR)
    teng = DisaggEngine(tb, tparams, device="cpu", transport=transport,
                        **PAIR)
    specs = _specs(2)
    jgenerate(jeng, [JRequest(**s) for s in specs])
    generate_many(teng, [Request(**s) for s in specs])
    assert set(teng.stats()) == set(jeng.stats())
    jrep, trep = jeng.kv_report(), teng.kv_report()
    assert set(trep) == set(jrep)
    assert trep["kv_shards"] == 1
    for key in ("pool_bytes", "bytes_per_page", "n_pages", "transport"):
        assert trep[key] == jrep[key], key
    teng.close()
    jeng.close()


@pytest.mark.parametrize("knob,outcome", [
    (faults.ENV_HANDOFF_CRASH_XFER, "handoff_dropped_nak"),
    (faults.ENV_HANDOFF_TIMEOUT_XFER, "handoff_dropped_timeout"),
])
def test_faulted_transfer_requeues_and_replays(monkeypatch, knob, outcome):
    """The second transfer torn (``DTG_FAULT_HANDOFF_CRASH_XFER``) or
    stalled past the ack window: payload dropped, sender pages freed, the
    request requeued at the prefill queue's head, and every request still
    decodes the batch-1 tokens (sampled ones included)."""
    _, _, tb, tparams = bridged()
    monkeypatch.setenv(knob, "1")
    eng = DisaggEngine(tb, tparams, device="cpu", transport="cross_host",
                       handoff_ack_timeout_s=0.3, **PAIR)
    reqs = [Request(prompt_ids=[3 + i, 17, 42], max_new_tokens=4,
                    temperature=0.8 if i % 2 else 0.0, seed=i)
            for i in range(4)]
    ids, done = drive(eng, reqs)
    for rid, req in zip(ids, reqs):
        want = reference(tb, tparams, req, page_size=4, max_len=24)
        assert done[rid].token_ids == want.token_ids, f"seed={req.seed}"
    s = eng.stats()
    assert s["handoff_dropped"] == 1 and s[outcome] == 1
    assert s["handoff_requeued"] == 1
    assert s["handoff_delivered"] == len(reqs)
    assert s["handoff_transfers"] == len(reqs) + 1
    assert eng.decode_pool.n_free == eng.decode_pool.capacity
    eng.close()


@pytest.mark.parametrize("transport", ["same_host", "cross_host"])
def test_decode_preemption_replays_through_the_prefill_side(transport):
    """A decode pool too small for both slots' growth: the decode side
    preempts, the sequence re-prefills on the prefill side and replays its
    tokens; every result equals its batch-1 reference and the JAX pair's,
    with the same preemption count."""
    jb, jparams, tb, tparams = bridged()
    kw = dict(PAIR, n_pages=7)
    if transport == "cross_host":
        kw["n_prefill_pages"] = 7
    specs = [dict(prompt_ids=[3 + i, 17, 42, 9, 5], max_new_tokens=10,
                  seed=i) for i in range(3)]
    teng = DisaggEngine(tb, tparams, device="cpu", transport=transport,
                        **kw)
    ids, done = drive(teng, [Request(**s) for s in specs])
    jeng = JDisagg(jb, jparams, transport=transport, **kw)
    jres = jgenerate(jeng, [JRequest(**s) for s in specs])
    for rid, s, j in zip(ids, specs, jres):
        want = reference(tb, tparams, Request(**s), page_size=4, max_len=24)
        assert done[rid].token_ids == want.token_ids == j.token_ids
    assert teng.stats()["preempted"] == jeng.stats()["preempted"] > 0
    teng.close()
    jeng.close()


def test_decode_side_horizon_and_speculation_keep_the_tokens():
    """The decode half's knobs: a K=4 horizon, and n-gram speculation
    parked and restored mid-stream, give the plain pair's tokens."""
    _, _, tb, tparams = bridged()
    LONG = dict(PAIR, max_len=48)
    # the spec tests' repetitive prompts at 24 new tokens: long enough
    # for the debug model's greedy streams to revisit tokens, so
    # ``ngram`` drafts (asserted below)
    specs = [dict(prompt_ids=[9, 8, 7] * 4 + [3 + i], max_new_tokens=24,
                  seed=i) for i in range(3)]
    plain = generate_many(DisaggEngine(tb, tparams, device="cpu", **LONG),
                          [Request(**s) for s in specs])
    hor = DisaggEngine(tb, tparams, device="cpu", **LONG)
    assert hor.set_decode_horizon(4) == 4 == hor.decode_horizon
    got = generate_many(hor, [Request(**s) for s in specs])
    assert [r.token_ids for r in got] == [r.token_ids for r in plain]
    assert hor.stats()["horizon_effective"] > 1
    spec = DisaggEngine(tb, tparams, device="cpu", speculate="ngram",
                        spec_k=3, **LONG)
    ids = [spec.submit(Request(**s)) for s in specs]
    done, it = {}, 0
    while spec.has_work:
        spec.set_speculation(it % 3 != 1)
        for res in spec.step():
            done[res.request_id] = res
        it += 1
    assert [done[i].token_ids for i in ids] == [r.token_ids for r in plain]
    assert spec.stats()["spec_tokens_drafted"] > 0
    with pytest.raises(ValueError, match="K=1"):
        spec.set_decode_horizon(2)


def test_deadlines_drain_and_refusals():
    """An in-transit deadline expires at the facade; a drained pair
    refuses new work with 503; a cross-host request larger than the decode
    pool is refused at submit; the tp-sharded pool is refused naming its
    ROADMAP item."""
    _, _, tb, tparams = bridged()
    eng = DisaggEngine(tb, tparams, device="cpu", transport="cross_host",
                       n_pages=5, **PAIR)
    from distributed_training_guide_tpu_torch.serve.scheduler import \
        RefusalError
    with pytest.raises(RefusalError, match="decode pool"):
        eng.submit(Request(prompt_ids=[3] * 10, max_new_tokens=12))
    eng.drain()
    with pytest.raises(RefusalError) as err:
        eng.submit(Request(prompt_ids=[3, 4], max_new_tokens=2))
    assert err.value.http_status == 503
    eng.close()
    # JAX's refusals: shard_kv without a tp plan, and across hosts
    with pytest.raises(ValueError, match="needs a plan= with a tp mesh"):
        DisaggEngine(tb, tparams, device="cpu", shard_kv=True, **PAIR)
    with pytest.raises(ValueError, match="cross_host.*shard_kv"):
        DisaggEngine(tb, tparams, device="cpu", shard_kv=True,
                     transport="cross_host", **PAIR)
    with pytest.raises(RuntimeError, match="cuda"):
        DisaggEngine(tb, tparams, **PAIR)       # default device: cuda
    eng = DisaggEngine(tb, tparams, device="cpu", **PAIR)
    req = Request(prompt_ids=[3, 4, 5], max_new_tokens=20, deadline_s=1e-9)
    rid = eng.submit(fresh(req))
    out = {}
    while eng.has_work:
        out.update({r.request_id: r for r in eng.step()})
    assert out[rid].finish_reason == "deadline"
    assert eng.stats()["deadline_expired"] == 1
