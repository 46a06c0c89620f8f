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
tp_fsdp 2 x 2), and that the ``single`` plan is refused on 4 ranks. Two
more gangs: chapter 02 through ``launch.local``, and a
rank that dies taking the gang down."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

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

    np.savez(tmp / "init.npz", **init)
    np.savez(tmp / "batches.npz", accum1=ids[1], accum2=ids[2],
             uneven_labels=uneven)
    t0 = time.perf_counter()
    out = _gang(4, [sys.executable, str(ROOT / "tests" /
                                        "torch_dist_worker.py"),
                    "--dir", str(tmp)], tmp, timeout=300)
    assert out.returncode == 0 and (tmp / "done").exists(), (
        out.stdout[-3000:] + out.stderr[-3000:] + _logs(tmp))
    refs["gang_s"] = time.perf_counter() - t0
    return tmp, refs


@pytest.mark.parametrize("strategy,accum", STRATEGIES,
                         ids=[s for s, _ in STRATEGIES])
def test_strategy_holds_the_jax_single_device_trajectory(gang, strategy,
                                                        accum):
    tmp, refs = gang
    got = np.load(tmp / f"traj_{strategy}.npz")
    jlosses, jparams = refs[accum]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
    assert np.all(np.isfinite(got["norms"]))
    assert set(jparams) == {k[2:] for k in got.files if k.startswith("p/")}
    for path, want in jparams.items():
        np.testing.assert_allclose(got[f"p/{path}"], want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=path)


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
    quarter of the rows, with no grad all-reduce: the Trainer raises."""
    tmp, _ = gang
    err = json.loads((tmp / "refusal.json").read_text())["error"]
    assert err is not None and "'ddp'" in err and "4 ranks" in err


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
