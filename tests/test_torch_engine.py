"""The port's JSON engine (``train/engine.py``) on the CPU.

The stage-to-plan table (stage 0-3 -> ddp / zero1 / zero2 / fsdp, with
tensor_parallel -> tp / tp_fsdp); three steps at stage 0 on llama-debug in
fp32 against the JAX ``TrainingEngine`` on the same weights (carried across
as numpy) and batches, losses within 1e-4 relative (fp32 math in two
frameworks, the sums in another order); refused keys naming their ROADMAP
items, and pipeline / context / expert parallelism building the JAX
engine's plan (and refusing what it refuses beside ep); DeepSpeed's offload and scheduler spellings; a save and a load; and
the engine chapter (``chapters/engine_llm.py``) on the JAX package's own
``alternative-frameworks/engine/config.json``."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_training_guide_tpu.train.engine import (
    TrainingEngine as JEngine)
from distributed_training_guide_tpu_torch.models import from_jax
from distributed_training_guide_tpu_torch.train.engine import (
    TrainingEngine, initialize, plan_for_stage)
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
BASE = {"model": "llama-debug", "bf16": {"enabled": False}, "seed": 0,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}


@pytest.mark.parametrize("stage,tp,want", [
    (0, 1, ("ddp", None, None)), (1, 1, ("zero1", True, None)),
    (2, 1, ("zero2", True, True)), (3, 1, ("fsdp", None, None)),
    (0, 2, ("tp", None, None)), (1, 2, ("tp", True, None)),
    (2, 2, ("tp", True, True)), (3, 2, ("tp_fsdp", None, None))])
def test_stage_to_plan_table(stage, tp, want):
    assert plan_for_stage(stage, tp) == want


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_each_stage_builds_its_plan_at_world_one(stage):
    engine = initialize({**BASE, "zero_optimization": {"stage": stage}},
                        device="cpu")
    try:
        plan = engine.trainer.plan
        assert plan.strategy == plan_for_stage(stage, 1)[0]
        assert plan.zero1 == (stage in (1, 2))
        assert plan.zero2 == (stage == 2)
        assert engine.global_batch_size == 1
    finally:
        engine.close()
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_stage_zero_losses_equal_the_jax_engine():
    jeng = JEngine({**BASE, "zero_optimization": {"stage": 0},
                    "train_micro_batch_size_per_gpu": 1})
    n = len(jax.devices())
    ids = np.random.default_rng(0).integers(0, 512, (3, n, 32))
    sharding = jeng.trainer.batch_shardings()["input_ids"]
    params = jax.tree.map(np.asarray, jeng.state.params)
    want = []
    for b in ids:
        x = jax.device_put(jnp.asarray(b), sharding)
        want.append(float(jeng.train_batch({"input_ids": x,
                                            "labels": x})["loss"]))
    import torch

    engine = initialize({**BASE, "zero_optimization": {"stage": 0},
                         "train_micro_batch_size_per_gpu": n}, device="cpu")
    try:
        assert engine.global_batch_size == n
        engine.state = engine.trainer.init_state_from_params(
            from_jax.params_from_numpy(params, device="cpu"))
        got = []
        for b in ids:
            x = torch.from_numpy(b)
            got.append(float(engine.train_batch({"input_ids": x,
                                                 "labels": x})["loss"]))
    finally:
        engine.close()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("key,value,item", [
    ("pipeline_parallel", 2, None),
    ("context_parallel", 2, None),
    ("expert_parallel", 2, None),
    ("overlap_schedule", True, None)],
    ids=["pipeline_parallel-2-None", "context_parallel-2-None",
         "expert_parallel-2-Expert parallelism",
         "overlap_schedule-True-Overlap schedule and the fused loss"])
def test_refused_keys_name_their_items(key, value, item):
    """pipeline_parallel, context_parallel, expert_parallel and
    overlap_schedule (item None: ported; no key refuses now) build the
    plan the JAX engine builds on its 8 CPU devices, here on a fake
    process group of 8 ranks, and overlap_schedule turns on the trainer's
    layer schedule as it does the JAX engine's. expert_parallel also refuses
    what the JAX engine refuses beside it (tp or pp; ZeRO-1 / 2), before
    any process group starts, and takes ep_fsdp at stage 3."""
    import torch.distributed as dist

    if key == "expert_parallel":
        for extra, match in (({"tensor_parallel": 2}, "data/fsdp axes only"),
                             ({"pipeline_parallel": 2},
                              "data/fsdp axes only"),
                             ({"zero_optimization": {"stage": 1}},
                              "use stage 0 or 3"),
                             ({"zero_optimization": {"stage": 2}},
                              "use stage 0 or 3")):
            config = {**BASE, key: value, **extra}
            with pytest.raises(ValueError, match=match):
                JEngine(config)
            with pytest.raises(ValueError, match=match):
                TrainingEngine(config, device="cpu")
            assert not dist.is_initialized()
        assert plan_for_stage(3, 1, ep=2) == ("ep_fsdp", None, None)
        assert plan_for_stage(0, 1, ep=2) == ("ep", None, None)
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            TrainingEngine({**BASE, key: value}, device="cpu")
        assert not dist.is_initialized()
        return
    from distributed_training_guide_tpu_torch.train.preflight import (
        fake_group)

    jplan = JEngine({**BASE, key: value}).trainer.plan
    with fake_group(len(jax.devices())):
        engine = TrainingEngine({**BASE, key: value}, device="cpu")
        try:
            plan = engine.trainer.plan
            assert plan.strategy == jplan.strategy
            assert plan.sizes == {a: int(n) for a, n in
                                  jplan.mesh.shape.items()}
            assert (plan.zero1, plan.zero2) == (jplan.zero1, jplan.zero2)
            pipe = engine.trainer.plan_state.pipeline
            assert (pipe is not None) == (key == "pipeline_parallel")
            scheduled = key == "overlap_schedule"
            assert engine.trainer.overlap_schedule == scheduled
            assert JEngine({**BASE, key: value}).trainer.overlap_schedule \
                == scheduled
            assert (engine.trainer.plan_state.layer_schedule
                    is not None) == scheduled
        finally:
            engine.close()
    assert not dist.is_initialized()


def test_cp_hop_loop_is_validated_where_the_config_enters():
    """The JAX hop-loop forms are accepted (the port runs one loop); any
    other ``cp_hop_loop`` refuses at the engine, which closes its group."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="hop_loop"):
        TrainingEngine({**BASE, "cp_hop_loop": "spiral"}, device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("zero,want", [
    ({"offload_optimizer": {"device": "cpu"}}, (True, False)),
    ({"offload_optimizer": {"device": "none"}}, (False, False)),
    ({"offload_optimizer": True, "offload_param": {"device": "cpu"}},
     (True, True))])
def test_deepspeed_offload_spellings(zero, want):
    engine = initialize({**BASE, "zero_optimization": {"stage": 3, **zero}},
                        device="cpu")
    try:
        t = engine.trainer
        assert (t.offload_opt_state, t.offload_params) == want
        if any(want):
            assert engine.state.offload.on_host(engine.state)
    finally:
        engine.close()


def test_deepspeed_scheduler_spelling_normalizes_as_jax():
    sched = {"type": "WarmupCosineLR",
             "params": {"total_num_steps": 500, "warmup_num_steps": 50,
                        "cos_min_ratio": 0.1}}
    jeng = JEngine({**BASE, "scheduler": sched})
    engine = initialize({**BASE, "scheduler": sched}, device="cpu")
    try:
        assert engine.scheduler_config == jeng.scheduler_config
    finally:
        engine.close()
    with pytest.raises(ValueError, match="warmup_max_lr"):
        TrainingEngine({**BASE, "scheduler": {
            "type": "WarmupCosineLR", "params": {"warmup_max_lr": 1.0}}},
            device="cpu")


def test_save_and_load_checkpoint(tmp_path):
    import torch

    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 512,
                                                             (3, 2, 32)))
    cfg = {**BASE, "zero_optimization": {"stage": 3},
           "train_micro_batch_size_per_gpu": 2}
    engine = initialize(cfg, device="cpu")
    try:
        losses = []
        for i, b in enumerate(ids):
            losses.append(float(engine.train_batch(
                {"input_ids": b, "labels": b})["loss"]))
            if i == 1:
                engine.save_checkpoint(tmp_path, "run")
    finally:
        engine.close()
    again = initialize(cfg, device="cpu")
    try:
        host = again.load_checkpoint(tmp_path, "run")
        assert host["global_step"] == 2
        loss = float(again.train_batch({"input_ids": ids[2],
                                        "labels": ids[2]})["loss"])
    finally:
        again.close()
    assert loss == losses[2]


def test_engine_chapter_runs_the_jax_packages_config(tmp_path):
    from distributed_training_guide_tpu_torch.chapters import engine_llm

    config = ROOT / "alternative-frameworks" / "engine" / "config.json"
    assert json.loads(config.read_text())["zero_optimization"]["stage"] == 3
    out = engine_llm.main(["--config", str(config), "-d", "synthetic:20000",
                           "-s", "64", "--max-steps", "4", "--log-freq", "2",
                           "--device", "cpu", "--save-dir", str(tmp_path),
                           "--ckpt-freq", "4"])
    assert out["strategy"] == "fsdp" and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"]))
    assert [i["step"] for i in out["infos"]] == [2, 4]
    assert (tmp_path / "state.json").exists()
