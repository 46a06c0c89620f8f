"""Serving under a plan: the tp-sharded page pool and the ranks that run
the engine's programs together (``serve/sharding.py``), against the JAX
package.

One gang of 2 CPU ranks (``tests/torch_dist_worker.py --scenario
serve_plan``, started once for this module by the port's ``launch.local``)
serves llama-debug (4 q heads, 2 kv heads: one kv head a rank under
``shard_kv``) and moe-debug from the JAX init, rank 0 leading and rank 1
following its programs: at tp 2 with and without ``shard_kv``, at fsdp 2,
with a decode horizon, an int8 pool, int8 weights, chunked prefill with a
copy-on-write fork, ``ngram`` speculation, two LoRA tenants and a params
publish, the same-host disaggregated pair and a streaming trace under pool
pressure; the serve CLI at ``--tp 2 --shard-kv``; and one decode step and
one attend recorded (``utils/hlo.py``). Rank 0 also runs the port's
single-device engine on each. The JAX references are its engine at tp 2
on two of its forced CPU devices, in each configuration and composition
(built while the gang runs): the greedy requests' tokens are held to
them, and every request's, sampled too, to the port's single device.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dist import _env, _flatten, _logs
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from torch_dist_worker import (  # noqa: E402
    COW_PROMPTS, LORA_TARGETS, SERVE_RUNS, SPEC_PROMPTS, TRACE_REQS,
    _adapter_payloads)


def _jax_requests():
    from distributed_training_guide_tpu.serve import Request

    return [Request(prompt_ids=[3 + i, 17, 42][:(i % 3) + 1],
                    max_new_tokens=3 + (i % 4),
                    temperature=0.9 if i % 2 else 0.0, seed=i)
            for i in range(6)]


def _jax_tokens(eng, reqs):
    from distributed_training_guide_tpu.serve.api import generate_many

    return [r.token_ids for r in generate_many(
        eng, [dataclasses.replace(r, request_id=None) for r in reqs])]


def _jax_lora(bundle, params, plan):
    """``torch_dist_worker._serve_lora`` on the JAX engine at tp 2 with
    the sharded pool: the same two tenants (numpy draws of one seed),
    requests under each and the base, a params publish (every weight x
    1.1), the requests again."""
    from distributed_training_guide_tpu.serve import Request, ServeEngine
    from distributed_training_guide_tpu_torch.models import (
        get_model as torch_model)

    eng = ServeEngine(bundle, params, n_slots=3, page_size=4, max_len=16,
                      plan=plan, shard_kv=True, max_adapters=3,
                      adapter_rank=4, adapter_targets=LORA_TARGETS)
    payloads = _adapter_payloads(torch_model("llama-debug").config, 2)
    slots = [eng.publish_adapter(
        {t: {k: jnp.asarray(v.numpy()) for k, v in pair.items()}
         for t, pair in a.items()}, name=f"t{i}")
        for i, a in enumerate(payloads)]
    reqs = [Request(prompt_ids=[3 + i, 17, 42], max_new_tokens=5,
                    adapter_id=(0, *slots)[i % 3], seed=i)
            for i in range(6)]
    before = _jax_tokens(eng, reqs)
    eng.publish_params(jax.tree.map(lambda x: x * 1.1, params))
    return {"before": before, "after": _jax_tokens(eng, reqs)}


def _jax_trace(bundle, params, plan) -> list:
    """``torch_dist_worker._serve_trace`` on the JAX engine at tp 2 with
    the sharded pool: one submit an iteration under the same pool
    pressure (7 pages for 3 slots, 4-token chunks), so its preemptions
    recompute where the port's do. Each request's tokens."""
    from distributed_training_guide_tpu.serve import Request, ServeEngine

    eng = ServeEngine(bundle, params, n_slots=3, page_size=4, max_len=16,
                      n_pages=7, prefill_chunk=4, plan=plan, shard_kv=True)
    done, ids, it = {}, [], 0
    while len(done) < len(TRACE_REQS):
        if it < len(TRACE_REQS):
            ids.append(eng.submit(Request(**TRACE_REQS[it])))
        for res in eng.step():
            done[res.request_id] = res.token_ids
        it += 1
    return [done[i] for i in ids]


def _jax_refs(eight_devices, params) -> dict:
    """The JAX engine at tp 2 on two forced CPU devices, llama-debug:
    greedy tokens of every SERVE_RUNS configuration it serves and of each
    composition (CoW prompts, ngram speculation, two LoRA tenants and a
    publish, the same-host pair, the trace's requests)."""
    from distributed_training_guide_tpu.models import get_model
    from distributed_training_guide_tpu.parallel import make_mesh, make_plan
    from distributed_training_guide_tpu.serve import Request, ServeEngine
    from distributed_training_guide_tpu.serve.disagg import DisaggEngine

    bundle = get_model("llama-debug", dtype=jnp.float32)
    tp2 = make_plan("tp", make_mesh(tp=2, devices=eight_devices[:2]))
    refs = {}
    for tag, kw in (("tp2", {}), ("tp2_kv", {"shard_kv": True}),
                    ("tp2_kv_int8_pool", {"shard_kv": True,
                                          "kv_dtype": "int8"}),
                    ("tp2_kv_int8_weights", {"shard_kv": True,
                                             "weight_dtype": "int8"}),
                    ("tp2_int8_weights", {"weight_dtype": "int8"})):
        eng = ServeEngine(bundle, params, n_slots=3, page_size=4,
                          max_len=16, plan=tp2, **kw)
        refs[tag] = _jax_tokens(eng, _jax_requests())
    eng = ServeEngine(bundle, params, n_slots=2, page_size=4, max_len=32,
                      prefill_chunk=4, plan=tp2, shard_kv=True)
    refs["cow"] = [_jax_tokens(eng, [Request(prompt_ids=list(p),
                                             max_new_tokens=3 + 2 * i)])[0]
                   for i, p in enumerate(COW_PROMPTS)]
    eng = ServeEngine(bundle, params, n_slots=2, page_size=4, max_len=32,
                      speculate="ngram", spec_k=3, plan=tp2, shard_kv=True)
    refs["spec"] = _jax_tokens(eng, [
        Request(prompt_ids=list(p), max_new_tokens=10,
                temperature=0.8 * i, seed=i)
        for i, p in enumerate(SPEC_PROMPTS)])
    refs["spec_drafted"] = eng.stats()["spec_tokens_drafted"]
    pair = DisaggEngine(bundle, params, n_slots=2, page_size=4, max_len=16,
                        prefill_chunk=4, plan=tp2, shard_kv=True)
    refs["disagg"] = _jax_tokens(pair, _jax_requests()[:2])
    refs["lora"] = _jax_lora(bundle, params, tp2)
    refs["trace"] = _jax_trace(bundle, params, tp2)
    return refs


@pytest.fixture(scope="module")
def gang(tmp_path_factory, eight_devices):
    from distributed_training_guide_tpu.models import get_model

    tmp = tmp_path_factory.mktemp("serve_plan")
    inits = {}
    for key, name in (("llama", "llama-debug"), ("moe", "moe-debug")):
        bundle = get_model(name, dtype=jnp.float32)
        inits[key] = bundle.init(bundle.config, jax.random.key(0))
        np.savez(tmp / f"serve_{key}.npz",
                 **_flatten(jax.tree.map(np.asarray, inits[key])))
    # the gang runs while this process builds the JAX references
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_training_guide_tpu_torch.launch."
         "local", "--nproc", "2", "--log-dir", str(tmp / "logs"), "--",
         sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         "--dir", str(tmp), "--scenario", "serve_plan"], cwd=ROOT,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        refs = _jax_refs(eight_devices, inits["llama"])
        out, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and (tmp / "done").exists(), (
        out[-3000:] + err[-3000:] + _logs(tmp))
    facts = [json.loads((tmp / f"serve_plan.rank{r}.json").read_text())
             for r in (0, 1)]
    return facts, refs


GREEDY = [i for i in range(6) if i % 2 == 0]


def test_greedy_tokens_are_the_jax_engines_at_tp2(gang):
    """llama-debug at tp 2 with and without shard_kv, and at fsdp 2, with
    a decode horizon, an int8 pool and int8 weights: every greedy
    request's tokens are the JAX engine's at tp 2 in the same
    configuration."""
    (facts, _), refs = gang
    for name, ref in (("tp2", "tp2"), ("tp2_kv", "tp2_kv"),
                      ("fsdp2", "tp2_kv"), ("tp2_kv_horizon", "tp2_kv"),
                      ("tp2_kv_int8_pool", "tp2_kv_int8_pool"),
                      ("tp2_kv_int8_weights", "tp2_kv_int8_weights"),
                      ("tp2_int8_weights", "tp2_int8_weights")):
        for i in GREEDY:
            assert facts[name][i] == refs[ref][i], (name, i)


@pytest.mark.parametrize("name", [r[0] for r in SERVE_RUNS])
def test_every_run_gives_the_single_device_engines_tokens(gang, name):
    """Greedy and sampled: the draw sees the whole vocabulary on every
    rank (the vocab-parallel logits gathered), so each request's tokens
    are the port's single-device engine's, int8 pools and weights and
    the MoE's expert shards (K5's plain version on each) too."""
    (facts, _), _ = gang
    assert facts[name] == facts["single"][name]


def test_shard_kv_pools_hold_a_ranks_kv_heads(gang):
    """Under shard_kv each rank's pool (every layer, payload and int8
    scales) holds Hkv / tp = 1 of llama-debug's 2 kv heads; without, both,
    on both ranks."""
    (f0, f1), _ = gang
    for facts in (f0, f1):
        heads = facts["pool_heads"]
        for name, _, _, _, prog_kw, _ in SERVE_RUNS:
            want = 1 if prog_kw.get("shard_kv") else 2
            assert heads[name] and set(heads[name]) == {want}, name
        for name in ("cow", "spec", "disagg", "trace", "lora"):
            assert set(heads[name]) == {1}, name


def test_chunked_prefill_and_the_cow_fork(gang):
    """A mid-page divergence forks once under the sharded pool (each rank
    copies its heads) and both prompts keep the single device's tokens;
    the pool's pages all come back."""
    (facts, _), refs = gang
    got, want = facts["cow"], facts["single"]["cow"]
    assert got["cow_forks"] == 1 and want["cow_forks"] == 1
    assert got["tokens"] == want["tokens"] and got["pool_whole"]
    assert got["tokens"] == refs["cow"]


def test_speculation_drafts_and_keeps_the_tokens(gang):
    """ngram under shard_kv drafts, keeps the single device's tokens, and
    its greedy request's are the JAX engine's with ngram at tp 2."""
    (facts, _), refs = gang
    got, want = facts["spec"], facts["single"]["spec"]
    assert got["drafted"] > 0 and refs["spec_drafted"] > 0
    assert got["tokens"] == want["tokens"]
    assert got["tokens"][0] == refs["spec"][0]


def test_lora_tenants_and_publishes_into_the_sharded_engine(gang):
    """Two tenants over wq / wv (column-parallel) and wo / down
    (row-parallel): each rank's adapter products cut to its shard; then a
    params publish reaches every rank. Every request is greedy: the
    tokens before and after are the JAX engine's at tp 2 under the same
    tenants and publish."""
    (facts, _), refs = gang
    got, want = facts["lora"], facts["single"]["lora"]
    assert got["before"] == want["before"]
    assert got["after"] == want["after"] and got["after"] != got["before"]
    assert got["publishes"] == 1
    assert got["before"] == refs["lora"]["before"]
    assert got["after"] == refs["lora"]["after"]


def test_disagg_pair_and_streaming_trace_under_shard_kv(gang):
    """The same-host pair moves page ids over the sharded pool; a
    staggered trace under pool pressure preempts, never rewrites a
    streamed prefix, and ends on the single device's tokens; the greedy
    requests of both end on the JAX engine's at tp 2."""
    (facts, _), refs = gang
    assert facts["disagg"] == facts["single"]["disagg"]
    assert facts["disagg"]["tokens"][0] == refs["disagg"][0]
    got, want = facts["trace"], facts["single"]["trace"]
    assert got["tokens"] == want["tokens"]
    assert got["rewritten"] == 0 and got["preempted"] > 0
    for i, r in enumerate(TRACE_REQS):
        if r["temperature"] == 0.0:
            assert got["tokens"][i] == refs["trace"][i], i


def test_decode_step_pin_no_rank_holds_the_whole_pool(gang):
    """JAX's compiled-HLO pin (``tests/test_serve_sharded.py``) on the
    recorded decode step: under shard_kv the rank's per-layer pool slice
    [P, page, Hkv / tp, D] is written and no tensor of the whole pool's
    [.., Hkv, D] shape is made; without shard_kv the whole slice is. The
    attend issues no collective under shard_kv, and gathers the heads
    without (every rank writes the whole pool)."""
    from distributed_training_guide_tpu_torch.utils import hlo

    (f0, f1), _ = gang
    local, whole = (9, 4, 1, 16), (9, 4, 2, 16)
    assert hlo.has_aval(f0["pin_kv"], "f32", local)
    for shape in (whole, (2,) + whole):
        assert not hlo.has_aval(f0["pin_kv"], "f32", shape)
    assert hlo.has_aval(f0["pin"], "f32", whole)
    for facts, rank in ((f0, 0), (f1, 1)):
        got = facts["attend_collectives"]
        assert got[f"pin_kv/rank{rank}"] == []
        assert "all-gather" in got[f"pin/rank{rank}"]


def test_cli_tp2_shard_kv_prints_the_tp1_lines(gang):
    """``launch.local --nproc 2 -- ... serve --tp 2 --shard-kv``: rank 0
    prints the single-device CLI's token lines; the kv report says two
    shards."""
    (facts, _), _ = gang
    lines = [json.loads(x) for x in facts["cli_tp2"].splitlines()]
    ref = [json.loads(x) for x in facts["cli_tp1"].splitlines()]
    assert [x["token_ids"] for x in lines if "token_ids" in x] == \
        [x["token_ids"] for x in ref if "token_ids" in x]
    assert lines[0]["kv_report"]["kv_shards"] == 2
    assert ref[0]["kv_report"]["kv_shards"] == 1


@pytest.mark.parametrize("fail_rank", [0, 1])
def test_a_program_failing_after_its_broadcast_ends_the_gang(
        tmp_path, fail_rank):
    """A decode step raises on one rank after rank 0 broadcast it, while
    the other rank is inside its collectives: the failing rank ends
    itself with status 1 naming the program (no stop message could match
    what its peer waits in), and the gang ends at once, not at the
    backend's 30-minute timeout."""
    import os
    import time

    env = dict(_env(), DTG_SERVE_FAIL_RANK=str(fail_rank))
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_training_guide_tpu_torch.launch."
         "local", "--nproc", "2", "--log-dir", str(tmp_path / "logs"), "--",
         sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         "--dir", str(tmp_path), "--scenario", "serve_abort"], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _, stderr = proc.communicate(timeout=100)
    finally:
        if proc.poll() is None:     # SIGTERM: launch.local ends its ranks
            proc.terminate()
            proc.communicate()
    assert time.monotonic() - t0 < 100
    err = stderr if fail_rank == 0 else (
        tmp_path / "logs" / "rank1.err").read_text()
    assert proc.returncode == 1, stderr[-3000:]
    assert f"injected decode failure on rank {fail_rank}" in err
    who = "rank 0 failed in program 'decode' after broadcasting it" \
        if fail_rank == 0 else "rank 1 failed in program 'decode'"
    assert f"{who}; ending this rank" in err, err[-3000:]
    assert not list(tmp_path.glob("served.rank*"))
    assert not os.path.exists(tmp_path / "done")


def test_match_partition_rules_mechanics():
    from distributed_training_guide_tpu_torch.serve.sharding import (
        SERVE_KV_RULES, match_partition_rules)
    from distributed_training_guide_tpu_torch.train.precision import (
        Quantized)

    tree = {"pages": {"k": torch.zeros(2, 5, 4, 2, 16),
                      "v": Quantized(q=torch.zeros(2, 5, 4, 2, 16),
                                     scale=torch.zeros(2, 5, 4, 2, 1))},
            "tables": torch.zeros(3, 4), "temps": torch.zeros(3),
            "scalar": torch.zeros(())}
    specs = match_partition_rules(SERVE_KV_RULES, tree)
    pool = (None, None, None, "tp", None)
    assert specs["pages"]["k"] == pool
    assert specs["pages"]["v"] == Quantized(q=pool, scale=pool)
    assert specs["tables"] == specs["temps"] == specs["scalar"] == ()
    with pytest.raises(ValueError, match="no serve partition rule"):
        match_partition_rules(SERVE_KV_RULES, {"mystery": torch.zeros(4, 4)})


class _Plan:
    """A plan's shard arithmetic for one rank of a tp mesh."""

    def __init__(self, tp, rank):
        self.sizes, self.rank = {"tp": tp}, rank

    def rank_over(self, axes):
        return self.rank

    def shard(self, spec, x):
        for d, e in enumerate(spec):
            if e:
                n = x.shape[d] // self.sizes["tp"]
                x = x.narrow(d, self.rank * n, n)
        return x


@pytest.mark.parametrize("tp", [2, 4])
def test_int8_scales_split_only_on_whole_blocks(tp):
    """JAX's ``quantized_param_shardings``: the payload splits like its
    leaf; the scales' block axis splits where every shard holds whole
    blocks (tp 2 of 64 columns in blocks of 32), else each rank reads its
    own columns' scales off the whole row (tp 4: 16 columns a rank, half
    a block). Either way each rank's (q, scale) dequantizes to its
    columns of the whole leaf, bitwise."""
    from distributed_training_guide_tpu_torch.serve.sharding import (
        shard_leaf)
    from distributed_training_guide_tpu_torch.train.precision import (
        dequantize_blockwise, quantize_blockwise)

    w = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
    whole = quantize_blockwise(w, block_size=32)
    for rank in range(tp):
        got = shard_leaf(_Plan(tp, rank), (None, "tp"), whole)
        n = 64 // tp
        assert got.q.shape == (8, n)
        assert got.scale.shape == (8, 2 // tp if tp == 2 else 1)
        cols = slice(rank * n, (rank + 1) * n)
        assert torch.equal(dequantize_blockwise(got),
                           dequantize_blockwise(whole)[:, cols])
