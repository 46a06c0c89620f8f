"""Context and pipeline parallelism of the port on 4 gloo ranks, against
the JAX package's single-device trajectory.

One gang of 4 CPU ranks (``tests/torch_dist_worker.py --scenario cp_pp``,
started once for this module by the port's ``launch.local``) runs two
AdamW steps (fp32, lr 1e-3) of each plan of ``CP_PP_RUNS``: the ring at
cp 4, cp 2 x fsdp 2 and cp 2 x tp 2, Ulysses at cp 2 and at cp 4 (which
does not divide the kv heads: q, k, v all-gathered), neox-debug's ring at
cp 4, pp 2 x dp 2, pp 4 (llama-debug cut to 4 layers), pp 2 x fsdp 2, pp 2
x tp 2, and pp 2 x cp 2 under both context impls, each rank fed its rows
(M microbatches under pp), its sequence shard and its shifted targets
(``data/loader.py:local_batch``). Each is held to ONE JAX single-device
run on the same weights and batch at JAX's tolerances (loss rtol 2e-4,
params rtol 1e-2 / atol 1e-4). The gang also takes one cp 4 step on labels
with -100 at shard edges (the shift across an edge) against JAX's loss,
and restores a pp 2 x fsdp 2 checkpoint under fsdp 4. Two more gangs run
chapters 08 and 09 through ``launch.local``."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from test_torch_dist import _flatten, _gang, _logs
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]
SEQ, GLOBAL_BATCH = 32, 8
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 1e-2, 1e-4
# run name -> the JAX reference it is held to
RUNS = {"ring_cp4": "init", "ring_cp2_fsdp2": "init",
        "ring_cp2_tp2": "init", "ulysses_cp2": "init", "ulysses_cp4": "init",
        "neox_ring_cp4": "neox_init", "pp2_dp2": "init", "pp4": "l4_init",
        "pp2_fsdp2": "init", "pp2_tp2": "init", "pp2_cp2_ring": "init",
        "pp2_cp2_ulysses": "init"}


def _uneven_labels(ids):
    """-100 on the first label of a cp-4 shard (position 8: the target of
    shard 0's last row), across the edge of shards 1 and 2, and on most of
    one row: the per-rank valid counts differ."""
    labels = ids.copy()
    labels[0, 8] = -100
    labels[3, 14:18] = -100
    labels[6, 5:] = -100
    return labels


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from distributed_training_guide_tpu.models import get_model
    from distributed_training_guide_tpu.parallel import make_mesh, make_plan
    from distributed_training_guide_tpu.train import Trainer, adamw_cosine

    tmp = tmp_path_factory.mktemp("cp_pp")
    ids = np.random.RandomState(0).randint(0, 512, (GLOBAL_BATCH, SEQ))
    uneven = _uneven_labels(ids)
    refs = {}

    def put(t, a):
        return jax.device_put(jnp.asarray(a), t.batch_shardings()["input_ids"])

    for key, model, over in (("init", "llama-debug", {}),
                             ("l4_init", "llama-debug", {"num_layers": 4}),
                             ("neox_init", "neox-debug", {})):
        t = Trainer(bundle=get_model(model, dtype=jnp.float32, **over),
                    optimizer=adamw_cosine(1e-3),
                    plan=make_plan("single", make_mesh(
                        devices=jax.devices()[:1])), donate=False)
        state = t.init_state(0)
        np.savez(tmp / f"{key}.npz",
                 **_flatten(jax.tree.map(np.asarray, state.params)))
        batch = {"input_ids": put(t, ids), "labels": put(t, ids)}
        if key == "init":
            _, m = t.step_fn(state, {"input_ids": put(t, ids),
                                     "labels": put(t, uneven)})
            refs["uneven"] = float(m["loss"])
        losses = []
        for _ in range(2):
            state, m = t.step_fn(state, batch)
            losses.append(float(m["loss"]))
        refs[key] = (losses, _flatten(jax.tree.map(np.asarray,
                                                   state.params)))
    np.savez(tmp / "batches.npz", ids=ids, uneven_labels=uneven)
    out = _gang(4, [sys.executable, str(ROOT / "tests" /
                                        "torch_dist_worker.py"),
                    "--dir", str(tmp), "--scenario", "cp_pp"], tmp,
                timeout=400)
    assert out.returncode == 0 and (tmp / "done").exists(), (
        out.stdout[-3000:] + out.stderr[-3000:] + _logs(tmp))
    return tmp, refs


@pytest.mark.parametrize("run", list(RUNS))
def test_plan_holds_the_jax_single_device_trajectory(gang, run):
    tmp, refs = gang
    got = np.load(tmp / f"cp_pp_{run}.npz")
    jlosses, jparams = refs[RUNS[run]]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
    assert set(jparams) == {k[2:] for k in got.files if k.startswith("p/")}
    for path, want in jparams.items():
        np.testing.assert_allclose(got[f"p/{path}"], want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=path)


def _result(gang):
    tmp, _ = gang
    return json.loads((tmp / "cp_pp.json").read_text())


def test_uneven_labels_across_cp_shard_edges_give_the_global_mean(gang):
    """The targets are shifted before the sequence is sharded: shard 0's
    last row is scored against shard 1's first label (here -100), and the
    loss is the global NLL sum over the global count, JAX's."""
    _, refs = gang
    labels = _uneven_labels(np.zeros((GLOBAL_BATCH, SEQ), int))
    counts = [(labels[:, 1:][:, 8 * r:8 * r + 8] != -100).sum()
              for r in range(4)]
    assert len(set(counts)) > 1
    np.testing.assert_allclose(_result(gang)["uneven_loss"], refs["uneven"],
                               rtol=1e-5)


def test_checkpoint_saved_under_pp_fsdp_restores_under_fsdp(gang):
    """DCP stores each stacked [L] leaf whole: pp 2 x fsdp 2's checkpoint
    after step 1 restores under fsdp 4, and its step 2 equals the pp run's
    own step 2 (two fp32 plans: sums in another order)."""
    got = _result(gang)
    np.testing.assert_allclose(got["resumed"], got["straight"], rtol=1e-5)
    assert got["step"] == 2 and got["global_step"] == 1


@pytest.mark.parametrize("chapter,extra,mesh", [
    ("c08_context_parallel", ["-s", "64", "--context-parallel", "4"],
     "'cp': 4} strategy=ddp"),
    ("c09_pipeline_parallel", ["-s", "32", "--pipeline-parallel", "2",
                               "--context-parallel", "2"],
     "'cp': 2} strategy=pp")])
def test_gang_of_chapters_08_and_09_trains(tmp_path, chapter, extra, mesh):
    out = _gang(4, [sys.executable, "-m",
                    f"distributed_training_guide_tpu_torch.chapters.{chapter}",
                    "-m", "llama-debug", "-d", "synthetic:3000", "-b", "4",
                    "--max-steps", "2", "--log-freq", "2", "--device", "cpu",
                    *extra], tmp_path, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:] + _logs(tmp_path)
    assert mesh in out.stderr
    assert "'global_step': 2" in out.stderr
