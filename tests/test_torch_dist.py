"""The port's sharding plans against the JAX package on 4 gloo ranks.

One gang of 4 CPU ranks (``tests/torch_dist_worker.py``, started once for
this module by the port's ``launch.local``) runs ddp, zero1, zero2
(grad_accum 2), fsdp 4, tp 4 (llama-debug's 2 kv heads split in halves)
and tp_fsdp 2 x 2 (and fsdp, tp_fsdp under remat), two AdamW steps each
on llama-debug in fp32: the
``tests/test_parallel.py`` recipe. Each is held to ONE JAX single-device
run on the same weights (carried across by ``models/from_jax.py``) and
batch, at JAX's own tolerances: losses rtol 1e-4, params rtol 1e-2 / atol
1e-4. The gang also checks what each rank holds, the global mean loss
under uneven ``-100`` labels, and a restore across plans (fsdp 4 into
tp_fsdp 2 x 2), that the ``single`` plan is refused on 4 ranks, and the
order ``process0_first`` / ``process_ordered`` give the ranks. The
same gang runs gpt2-debug under tp 4 (the fused QKV sharded on its heads),
neox-debug under tp 2 x fsdp 2 and LoRA-only llama-debug under tp 4
without sequence parallelism, each held to its JAX single-device run at
the same tolerances. It also trains moe-debug (chapter 10) under ep 4,
ep 2 x fsdp 2, ddp 4 and fsdp 4 with the dense and the ragged dispatch,
pp 2 and ep 2 x cp 2 dense, and tp 2 dense on qwen1.5-moe's wiring (a
shared expert), each held to JAX's single-device trajectory at JAX's MoE
tolerances (losses rtol 2e-4 dense, 2e-5 ragged: ``tests/test_moe.py``)
with the same ``moe_dropped_frac``; the first step's MoE grads (the
router's aux-loss gradient among them, at ``router_aux_coef`` 1) under
ddp 4 and tp 2 against ``jax.grad`` on one device; expert leaves sharded
on ep in params, grads and optimizer state; and an ep 4 checkpoint
restored under ep 2 x fsdp 2 and under fsdp 4. The dense dispatch is
also held at capacity factor 0.5 under ddp 4 and ep 2 x cp 2, where pairs
drop, to JAX's ``moe_dropped_frac`` and trajectory. The overlap schedule
(``ops/overlap.py``) runs in the same gang: under fsdp 4, zero1, tp_fsdp
2 x 2 and zero2 (grad_accum 2) its trajectory is bitwise the unscheduled
one's on the same fused loss, its gather counter counts 2 x L x 7 leaf
gathers a step under fsdp (the port's stand-in for the JAX package's HLO
count), ``loss_chunks`` 4 under each of those plans (both runs) and under
tp 4 holds JAX's single-device chunked trajectory at the same grad_accum,
the vocab-parallel fused loss under tp
4 holds the dense loss at grad level, and the ep 4 and ep 2 x fsdp 2
ragged ring holds the bulk exchange. Two more gangs: chapter 02 through
``launch.local``, and a rank that dies taking the gang down."""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]
SEQ, GLOBAL_BATCH = 32, 8
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-2, 1e-4
STRATEGIES = [("ddp", 1), ("zero1", 1), ("zero2", 2), ("fsdp", 1),
              ("tp", 1), ("tp_fsdp", 1), ("fsdp_remat_all", 1),
              ("tp_fsdp_remat_attn", 1)]


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _uneven_labels(ids):
    """-100 on most of rank 0's rows and one of rank 3's (ddp over 4 ranks
    gives each 2 rows): the per-rank valid counts differ."""
    labels = ids.copy()
    labels[0, 3:] = -100
    labels[1, 10:] = -100
    labels[7, 25:] = -100
    return labels


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _gang(nproc, worker, tmp, timeout):
    return subprocess.run(
        [sys.executable, "-m", "distributed_training_guide_tpu_torch.launch."
         "local", "--nproc", str(nproc), "--log-dir", str(tmp / "logs"),
         "--", *worker], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=timeout)


def _logs(tmp):
    return "\n".join(p.read_text()[-3000:]
                     for p in sorted((tmp / "logs").glob("*.err")))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from distributed_training_guide_tpu.models import get_model
    from distributed_training_guide_tpu.parallel import make_mesh, make_plan
    from distributed_training_guide_tpu.train import Trainer, adamw_cosine

    tmp = tmp_path_factory.mktemp("gang")
    bundle = get_model("llama-debug", dtype=jnp.float32)
    ids = {1: np.random.RandomState(0).randint(0, 512, (GLOBAL_BATCH, SEQ)),
           2: np.random.RandomState(0).randint(0, 512,
                                               (2, GLOBAL_BATCH, SEQ))}
    uneven = _uneven_labels(ids[1])
    refs = {}

    def trainer(accum):
        return Trainer(bundle=bundle, optimizer=adamw_cosine(1e-3),
                       plan=make_plan("single", make_mesh(
                           devices=jax.devices()[:1])),
                       grad_accum=accum, donate=False)

    def put(t, a):
        return jax.device_put(jnp.asarray(a), t.batch_shardings()["input_ids"])

    for accum in (1, 2):
        t = Trainer(bundle=bundle, optimizer=adamw_cosine(1e-3),
                    plan=make_plan("single", make_mesh(
                        devices=jax.devices()[:1])),
                    loss_chunks=4, grad_accum=accum, donate=False)
        state = t.init_state(0)
        batch = {"input_ids": put(t, ids[accum]),
                 "labels": put(t, ids[accum])}
        losses = []
        for _ in range(2):
            state, m = t.step_fn(state, batch)
            losses.append(float(m["loss"]))
        refs[("chunked", accum)] = (
            losses, _flatten(jax.tree.map(np.asarray, state.params)))
    for accum in (1, 2):
        t = trainer(accum)
        state = t.init_state(0)
        if accum == 1:
            init = _flatten(jax.tree.map(np.asarray, state.params))
        batch = {"input_ids": put(t, ids[accum]), "labels": put(t, ids[accum])}
        losses = []
        for _ in range(2):
            state, m = t.step_fn(state, batch)
            losses.append(float(m["loss"]))
        refs[accum] = (losses, _flatten(jax.tree.map(np.asarray,
                                                     state.params)))
    t = trainer(1)
    _, m = t.step_fn(t.init_state(0), {"input_ids": put(t, ids[1]),
                                       "labels": put(t, uneven)})
    refs["uneven"] = float(m["loss"])
    for name, fam_bundle, lora_only in _family_bundles():
        t = Trainer(bundle=fam_bundle, optimizer=adamw_cosine(1e-3),
                    plan=make_plan("single", make_mesh(
                        devices=jax.devices()[:1])), donate=False,
                    lora_only=lora_only)
        state = t.init_state(0)
        np.savez(tmp / f"{name}_init.npz",
                 **_flatten(jax.tree.map(np.asarray, state.params)))
        batch = {"input_ids": put(t, ids[1]), "labels": put(t, ids[1])}
        losses = []
        for _ in range(2):
            state, m = t.step_fn(state, batch)
            losses.append(float(m["loss"]))
        refs[name] = (losses, _flatten(jax.tree.map(np.asarray,
                                                    state.params)))

    refs.update(_moe_refs(tmp, ids[1], put))
    np.savez(tmp / "init.npz", **init)
    np.savez(tmp / "batches.npz", accum1=ids[1], accum2=ids[2],
             uneven_labels=uneven)
    t0 = time.perf_counter()
    out = _gang(4, [sys.executable, str(ROOT / "tests" /
                                        "torch_dist_worker.py"),
                    "--dir", str(tmp)], tmp, timeout=600)
    assert out.returncode == 0 and (tmp / "done").exists(), (
        out.stdout[-3000:] + out.stderr[-3000:] + _logs(tmp))
    refs["gang_s"] = time.perf_counter() - t0
    return tmp, refs


# moe-debug with qwen1.5-moe's wiring (QKV biases, un-normalized top-k, a
# shared expert), as tests/torch_dist_worker.py:MOE_SHARED
MOE_SHARED = dict(attn_bias=True, norm_topk_prob=False,
                  shared_expert_intermediate=32)
# tests/torch_dist_worker.py:MOE_CF05: the dense dispatch drops pairs
MOE_CF05 = dict(capacity_factor=0.5)
# tests/torch_dist_worker.py:MOE_WHOLE: widths tp 4 divides neither of
MOE_WHOLE = dict(MOE_SHARED, intermediate_size=126,
                 shared_expert_intermediate=30)


def _moe_refs(tmp, ids, put):
    """JAX's single-device runs the gang's MoE plans are held to: two
    steps of each (model, dispatch) from the init written for the gang,
    and the first step's MoE grads at router_aux_coef 1."""
    import jax
    import jax.numpy as jnp

    from distributed_training_guide_tpu.models import get_model
    from distributed_training_guide_tpu.models import moe as jmoe
    from distributed_training_guide_tpu.ops.cross_entropy import (
        causal_lm_loss)
    from distributed_training_guide_tpu.parallel import make_mesh, make_plan
    from distributed_training_guide_tpu.train import Trainer, adamw_cosine

    refs = {}
    for init, over in (("moe", {}), ("moe_shared", MOE_SHARED),
                       ("moe_cf05", MOE_CF05), ("moe_whole", MOE_WHOLE)):
        bundle = get_model("moe-debug", dtype=jnp.float32, **over)
        params = bundle.init(bundle.config, jax.random.key(0))
        if init != "moe_cf05":        # moe's weights: init does not read cf
            np.savez(tmp / f"{init}_init.npz",
                     **_flatten(jax.tree.map(np.asarray, params)))
        for dispatch in (("dense", "ragged") if init == "moe"
                         else ("dense",)):
            b = get_model("moe-debug", dtype=jnp.float32,
                          moe_dispatch=dispatch, **over)
            t = Trainer(bundle=b, optimizer=adamw_cosine(1e-3),
                        plan=make_plan("single", make_mesh(
                            devices=jax.devices()[:1])), donate=False)
            state = t.init_state_from_params(params, 0)
            batch = {"input_ids": put(t, ids), "labels": put(t, ids)}
            losses, dropped = [], []
            for _ in range(2):
                state, m = t.step_fn(state, batch)
                losses.append(float(m["loss"]))
                dropped.append(float(m["moe_dropped_frac"]))
            refs[f"{init}/{dispatch}"] = (
                losses, _flatten(jax.tree.map(np.asarray, state.params)),
                dropped)
        if init in ("moe_cf05", "moe_whole"):
            continue
        cfg = dataclasses.replace(bundle.config, router_aux_coef=1.0)

        def loss(p, cfg=cfg):
            logits, aux = jmoe.apply_with_aux(cfg, p, jnp.asarray(ids))
            return causal_lm_loss(logits, jnp.asarray(ids)) + aux
        grads = jax.jit(jax.grad(loss))(params)["layers"]["moe"]
        refs[f"{init}/grads"] = {k: np.asarray(v) for k, v in grads.items()}
    return refs


def _family_bundles():
    """(name, JAX bundle, lora_only) of the gang's family runs."""
    import jax.numpy as jnp

    from distributed_training_guide_tpu.models import get_model
    from distributed_training_guide_tpu.models.lora import lora_bundle

    return [("gpt2_tp", get_model("gpt2-debug", dtype=jnp.float32), False),
            ("neox_tp_fsdp", get_model("neox-debug", dtype=jnp.float32),
             False),
            ("lora_tp", lora_bundle(get_model("llama-debug",
                                              dtype=jnp.float32), rank=4,
                                    targets=("wq", "wv", "wo", "down")),
             True)]


FAMILY_RUNS = ["gpt2_tp", "neox_tp_fsdp", "lora_tp"]


@pytest.mark.parametrize("strategy,accum",
                         STRATEGIES + [(n, None) for n in FAMILY_RUNS],
                         ids=[s for s, _ in STRATEGIES] + FAMILY_RUNS)
def test_strategy_holds_the_jax_single_device_trajectory(gang, strategy,
                                                        accum):
    """Each plan's two steps against JAX's single device; under fsdp,
    zero1, tp_fsdp, zero2 and tp also the overlap schedule's and the
    fused loss's cases (``_holds_overlap``)."""
    tmp, refs = gang
    got = np.load(tmp / f"traj_{strategy}.npz")
    jlosses, jparams = refs[strategy if accum is None else accum]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
    if accum is not None:
        assert np.all(np.isfinite(got["norms"]))
    assert set(jparams) == {k[2:] for k in got.files if k.startswith("p/")}
    for path, want in jparams.items():
        np.testing.assert_allclose(got[f"p/{path}"], want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=path)
    _holds_overlap(tmp, refs, strategy)


# the overlap-schedule runs of tests/torch_dist_worker.py:OVERLAP_RUNS, and
# the schedule's gathers in two steps of llama-debug (L 2; 7 leaves on
# fsdp: wq, wk, wv, wo, gate, up, down), forward and recompute
OVERLAP_GATHERS = {"fsdp": 2 * 2 * 7, "tp_fsdp": 2 * 2 * 7, "zero1": 0,
                   "zero2": 0}


def _holds_chunked(got, key, ref):
    """The run ``key`` of ``overlap.npz`` against JAX's single-device
    trajectory with ``loss_chunks`` 4 (``ref``: losses, params)."""
    jlosses, jparams = ref
    np.testing.assert_allclose(got[f"{key}/losses"], jlosses, rtol=LOSS_RTOL)
    for path, want in jparams.items():
        np.testing.assert_allclose(got[f"{key}/p/{path}"], want,
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{key}: {path}")


def _holds_overlap(tmp, refs, strategy):
    """The overlap schedule's cases of ``strategy`` (see the module
    docstring): scheduled against unscheduled bitwise, on the same fused
    loss, and the unscheduled run (tp's ``loss_chunks`` 4 run) against
    JAX's chunked single device at the same grad_accum; tp's fused
    vocab-parallel grads against the dense loss's at grad level."""
    got = np.load(tmp / "overlap.npz")
    if strategy in OVERLAP_GATHERS:
        counts = json.loads((tmp / "overlap.json").read_text())[strategy]
        want = OVERLAP_GATHERS[strategy]
        assert counts == {"gather": want, "regather": want}, counts
        keys = [k[len(strategy) + 7:] for k in got.files
                if k.startswith(f"{strategy}/sched/")]
        assert {"losses", "norms"} < set(keys)
        for k in keys:
            assert np.array_equal(got[f"{strategy}/sched/{k}"],
                                  got[f"{strategy}/unsched/{k}"]), k
        accum = 2 if strategy == "zero2" else 1
        _holds_chunked(got, f"{strategy}/unsched", refs[("chunked", accum)])
    if strategy == "tp":
        _holds_chunked(got, "chunks_tp", refs[("chunked", 1)])
    if strategy == "tp":
        # the scale pin: each tp rank seeds its backward with the loss's
        # own cotangent, so a 1/tp or tp-fold factor on the head's grad
        # would show here and nowhere in a trajectory (Adam is invariant
        # to it)
        paths = [k[len("grads_dense/"):] for k in got.files
                 if k.startswith("grads_dense/")]
        for path in paths:
            fused, dense = got[f"grads_fused/{path}"], got[
                f"grads_dense/{path}"]
            scale = float(np.abs(dense).max())
            np.testing.assert_allclose(fused, dense, rtol=0,
                                       atol=1e-5 * scale, err_msg=path)
            ratio = float((fused * dense).sum() / (dense * dense).sum())
            assert abs(ratio - 1) < 1e-5, (path, ratio)


def _held(gang):
    tmp, _ = gang
    return json.loads((tmp / "held.json").read_text())


def test_zero1_shards_the_optimizer_state_and_not_the_params(gang):
    held = _held(gang)["zero1"]
    wq = held["layers/attn/wq"]     # [L, E, H]: embed over the 4 data ranks
    assert wq["param"] == [2, 64, 64] and wq["exp_avg"] == [2, 16, 64]
    table = held["embed/embedding"]   # [V, E]: vocab over the data ranks
    assert table["param"] == [512, 64] and table["exp_avg"] == [128, 64]
    norm = held["layers/input_norm"]  # no embed / vocab dim: replicated
    assert norm["param"] == norm["exp_avg"] == [2, 64]
    assert wq["grad"] == wq["exp_avg"]     # the optimizer steps the shard


def test_zero2_hands_the_optimizer_sharded_grads(gang):
    held = _held(gang)["zero2"]
    for path, shapes in held.items():
        assert shapes["grad"] == shapes["exp_avg"], path
    assert held["layers/mlp/down"]["grad"] == [2, 128, 16]
    assert held["layers/mlp/down"]["param"] == [2, 128, 64]


def test_fsdp_shards_every_weight_on_embed_or_vocab(gang):
    held = _held(gang)["fsdp"]
    assert held["layers/attn/wq"]["param"] == [2, 16, 64]
    assert held["layers/mlp/down"]["param"] == [2, 128, 16]
    assert held["embed/embedding"]["param"] == [128, 64]   # vocab first
    assert held["lm_head"]["param"] == [16, 512]
    assert held["layers/attn/wq"]["placements"][2] == "Shard(1)"
    assert held["final_norm"]["param"] == [64]              # never sharded


def test_tp_splits_the_kv_heads_and_keeps_whole_q_heads(gang):
    held = _held(gang)["tp"]
    assert held["layers/attn/wq"]["param"] == [2, 64, 16]   # 1 q head
    assert held["layers/attn/wk"]["param"] == [2, 64, 8]    # half a kv head
    assert held["layers/attn/wo"]["param"] == [2, 16, 64]   # row-parallel
    assert held["embed/embedding"]["param"] == [128, 64]    # vocab-parallel
    assert held["layers/attn/wk"]["placements"][4] == "Shard(2)"
    tf = _held(gang)["tp_fsdp"]["layers/attn/wq"]
    assert tf["param"] == [2, 32, 32]       # embed on fsdp, heads on tp


def test_uneven_ignore_labels_give_the_global_mean(gang):
    """-100 labels fall unevenly over the ranks: the ddp loss is the global
    NLL sum over the global count, the single-device JAX loss (a mean of
    per-rank means would weigh rank 0's few tokens like rank 1's many)."""
    tmp, refs = gang
    labels = _uneven_labels(np.zeros((GLOBAL_BATCH, SEQ), int))
    counts = [(labels[2 * r:2 * r + 2, 1:] != -100).sum() for r in range(4)]
    assert len(set(counts)) > 1
    got = float(np.load(tmp / "uneven.npz")["loss"])
    np.testing.assert_allclose(got, refs["uneven"], rtol=1e-6)


def test_checkpoint_saved_under_fsdp_restores_under_tp_fsdp(gang):
    """DCP reshards on load: the next loss after restoring fsdp 4's
    checkpoint into tp 2 x fsdp 2 equals the fsdp run's own next loss (two
    fp32 plans: the sums run in another order)."""
    tmp, _ = gang
    got = np.load(tmp / "restore.npz")
    np.testing.assert_allclose(float(got["resumed"]), float(got["straight"]),
                               rtol=1e-5)
    assert int(got["step"]) == 2 and int(got["count"]) == 2
    assert int(got["global_step"]) == 1


def test_single_plan_on_many_ranks_is_refused(gang):
    """'single' on a mesh of 4 ranks would train each rank alone on its
    quarter of the rows, with no grad all-reduce: the Trainer raises.
    The gang's process guards, checked here too (the file's test count
    sets its place in the tier-1 queue, see below): ``process0_first``
    ends rank 0's block before any other rank's starts, and
    ``process_ordered(rank % 2 == 1)`` runs both odd ranks before either
    even one (the first group pauses inside its block)."""
    tmp, _ = gang
    err = json.loads((tmp / "refusal.json").read_text())["error"]
    assert err is not None and "'ddp'" in err and "4 ranks" in err
    lines = (tmp / "guards.txt").read_text().split()
    first = [ln for ln in lines if ln.startswith("p0first:")]
    ordered = [ln for ln in lines if ln.startswith("odd_first:")]
    assert first[0] == "p0first:0" and sorted(first[1:]) == [
        "p0first:1", "p0first:2", "p0first:3"]
    assert sorted(ordered[:2]) == ["odd_first:1", "odd_first:3"]
    assert sorted(ordered[2:]) == ["odd_first:0", "odd_first:2"]


def test_gang_of_chapter_02_trains(tmp_path):
    out = _gang(2, [sys.executable, "-m",
                    "distributed_training_guide_tpu_torch.chapters.c02_ddp",
                    "-m", "llama-debug", "-d", "synthetic:3000", "-s", "32",
                    "-b", "2", "--max-steps", "2", "--log-freq", "2",
                    "--device", "cpu"], tmp_path, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:] + _logs(tmp_path)
    assert "strategy=ddp" in out.stderr
    assert "'global_step': 2" in out.stderr
    assert "global batch 4" in out.stderr


_DIES = """
import os, sys, torch.distributed as dist
sys.path.insert(0, {root!r})
from distributed_training_guide_tpu_torch.launch import maybe_initialize_distributed
maybe_initialize_distributed("cpu")
if dist.get_rank() == 1:
    os._exit(7)
dist.barrier()
"""


def test_a_dead_rank_takes_the_gang_down(tmp_path):
    """Rank 1 dies after the rendezvous; rank 0 would wait in a collective
    until its timeout. The launcher ends the gang with rank 1's code."""
    t0 = time.perf_counter()
    out = _gang(2, [sys.executable, "-c", _DIES.format(root=str(ROOT))],
                tmp_path, timeout=120)
    assert out.returncode == 7, out.stderr[-2000:]
    assert time.perf_counter() - t0 < 60


# (name, init, dispatch): tests/torch_dist_worker.py:MOE_RUNS
MOE_RUNS = [("ep4", "moe", "dense"), ("ep4_ragged", "moe", "ragged"),
            ("ep2_fsdp2", "moe", "dense"),
            ("ep2_fsdp2_ragged", "moe", "ragged"),
            ("ddp4", "moe", "dense"), ("ddp4_ragged", "moe", "ragged"),
            ("fsdp4", "moe", "dense"), ("fsdp4_ragged", "moe", "ragged"),
            ("tp2_shared", "moe_shared", "dense"), ("pp2", "moe", "dense"),
            ("ep2_cp2", "moe", "dense"), ("ddp4_cf05", "moe_cf05", "dense"),
            ("ep2_cp2_cf05", "moe_cf05", "dense"),
            ("ep4_ragged_ring", "moe", "ragged"),
            ("ep2_fsdp2_ragged_ring", "moe", "ragged"),
            ("tp4_whole", "moe_whole", "dense")]
MOE_LOSS_RTOL = {"dense": 2e-4, "ragged": 2e-5}
# the ragged ring against the bulk exchange (tests/torch_dist_worker.py
# ``*_ring`` runs): the same products per row, the owner's partials summed
# in member order, an expert's weight gradient summed over the hops; Adam's
# normalized step turns a grad's last-bit difference where the grad is
# near zero into a move of up to ~2e-6 (measured 1.8e-6 on one wq element)
RING_LOSS_RTOL, RING_PARAM_RTOL, RING_PARAM_ATOL = 1e-6, 1e-5, 1e-5


# The MoE cases are loops inside four tests, not parametrized cases: the
# file's test count sets its place in pytest-xdist's loadfile queue, and
# at 24 tests or fewer it runs after the JAX package's tests/
# test_pipeline.py, whose start bounds the tier-1 run (CHANGES.md, PR 15).

def test_moe_plans_hold_the_jax_single_device_trajectory(gang):
    """Two steps of moe-debug under each plan of ``MOE_RUNS`` against
    JAX's single device from the same weights and batch: losses at JAX's
    MoE tolerances, the final params at the gang's, and
    ``moe_dropped_frac`` (the global fraction) equal to JAX's within 1e-6
    (identically 0 under ragged; above 5% at capacity factor 0.5, the
    ``*_cf05`` runs). The ``*_ring`` runs (the overlap schedule's
    double-buffered ring) are also held to their bulk exchange's run at
    ``RING_*``. The pipeline's dense dispatch routes
    each microbatch alone (its capacity and aux over the microbatch's
    tokens, as JAX's pipeline does, which reports no dropped fraction):
    its losses are held to the single device as JAX's
    ``tests/test_pipeline.py`` holds its own, and its grads to the single
    device's mean of microbatch means in ``tests/test_torch_pipeline.py``
    (a pair flipping between kept and dropped turns a tiny embedding-row
    grad, which Adam's normalized step makes a 2e-3 parameter move)."""
    tmp, refs = gang
    for name, init, dispatch in MOE_RUNS:
        got = np.load(tmp / f"moe_{name}.npz")
        jlosses, jparams, jdropped = refs[f"{init}/{dispatch}"]
        np.testing.assert_allclose(got["losses"], jlosses,
                                   rtol=MOE_LOSS_RTOL[dispatch], err_msg=name)
        if name == "pp2":
            assert list(got["dropped"]) == [-1.0, -1.0]   # not reported
            continue
        np.testing.assert_allclose(got["dropped"], jdropped, atol=1e-6,
                                   err_msg=name)
        if init == "moe_cf05":     # the capacity drops pairs here
            assert min(jdropped) > 0.05, (name, jdropped)
        if name.endswith("_ring"):
            bulk = np.load(tmp / f"moe_{name[:-len('_ring')]}.npz")
            np.testing.assert_allclose(got["losses"], bulk["losses"],
                                       rtol=RING_LOSS_RTOL, err_msg=name)
            for k in bulk.files:
                if k.startswith("p/"):
                    np.testing.assert_allclose(
                        got[k], bulk[k], rtol=RING_PARAM_RTOL,
                        atol=RING_PARAM_ATOL, err_msg=f"{name}: {k}")
        assert set(jparams) == {k[2:] for k in got.files
                                if k.startswith("p/")}, name
        for path, want in jparams.items():
            np.testing.assert_allclose(got[f"p/{path}"], want,
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{name}: {path}")


def _moe_held(gang):
    tmp, _ = gang
    return json.loads((tmp / "moe.json").read_text())


# (name, local expert stack [L, E / ep, D (/ fsdp), F], local router)
MOE_HELD = [("ep4", [2, 1, 64, 128], [2, 64, 4]),
            ("ep4_ragged", [2, 1, 64, 128], [2, 64, 4]),
            ("ep2_fsdp2", [2, 2, 32, 128], [2, 32, 4]),
            ("ep2_fsdp2_ragged", [2, 2, 32, 128], [2, 32, 4])]


def test_moe_expert_leaves_stay_sharded_on_ep(gang):
    """Under ep 4 and ep 2 x fsdp 2, both dispatches, the routed experts'
    stacks [L, E, D, F] hold E / ep experts on each rank (and D / fsdp
    under ep_fsdp) in the param, the grad the optimizer steps and its
    state; the router is never sharded on ep (on its embed dim under
    ep_fsdp, as every embed dim)."""
    for name, local, router in MOE_HELD:
        held = _moe_held(gang)[name]
        for leaf in ("gate", "up"):
            h = held[f"layers/moe/{leaf}"]
            assert h["param"] == h["grad"] == h["exp_avg"] == local, (
                name, leaf)
            assert h["placements"][3] == "Shard(1)", name   # ep: experts
        assert held["layers/moe/down"]["param"][:2] == local[:2], name
        r = held["layers/moe/router"]
        assert r["param"] == r["grad"] == router, name
        assert r["placements"][3] == "Replicate", name


def test_moe_grads_match_jax_with_the_aux_loss(gang):
    """The first step's grads of every MoE leaf (router, experts and the
    shared expert) at router_aux_coef 1 under ddp 4 and under tp 2 (the
    shared-expert variant), summed over the ranks, against ``jax.grad``
    of ce + aux on one device, within 1e-4 of each leaf's largest: the
    aux loss's router gradient is the global one, not a 1/dp (or under tp
    a tp-fold) share."""
    tmp, refs = gang
    got = np.load(tmp / "moe_grads.npz")
    for name, init in (("ddp4", "moe"), ("tp2_shared", "moe_shared")):
        want = refs[f"{init}/grads"]
        assert {k.split("/", 1)[1] for k in got.files
                if k.startswith(name + "/")} == {f"layers/moe/{k}"
                                                 for k in want}, name
        for leaf, w in want.items():
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(got[f"{name}/layers/moe/{leaf}"], w,
                                       rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{name}: {leaf}")


def test_moe_checkpoint_saved_under_ep_restores_under_ep_fsdp(gang):
    """An ep 4 state saved after one ragged step, restored under ep 2 x
    fsdp 2 and under fsdp 4 at the same world (DCP reshards the expert
    stacks), takes the straight run's next step (two fp32 plans: rtol
    1e-5)."""
    got = _moe_held(gang)["restore"]
    for plan in ("ep_fsdp", "fsdp"):
        np.testing.assert_allclose(got[plan]["resumed"], got["straight"],
                                   rtol=1e-5, err_msg=plan)
        assert got[plan]["step"] == 2 and got[plan]["global_step"] == 1
