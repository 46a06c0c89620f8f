"""The port's host utilities against the JAX package's: the fault drills
(``active_faults`` field for field under the same environment, the crash,
latency and corruption drills), the heartbeat (write, read, age), the
process guards (``process0_first`` / ``process_ordered`` without a
process group; across ranks in ``tests/test_torch_dist.py``'s gang),
``log_dict``, the mesh descriptor of the single-device plan, and
``make_tracker`` with a stub ``wandb`` in ``sys.modules`` (as
``tests/test_tracking.py`` stubs it), also through ``run_training``."""
import dataclasses
import json
import sys
import types

import pytest

from distributed_training_guide_tpu.checkpoint import reshard as jreshard
from distributed_training_guide_tpu.train import optimizer as jopt
from distributed_training_guide_tpu.train.step import Trainer as JTrainer
from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.utils import faults as jfaults
from distributed_training_guide_tpu.utils import heartbeat as jheartbeat
from distributed_training_guide_tpu_torch.checkpoint import reshard
from distributed_training_guide_tpu_torch.models import get_model
from distributed_training_guide_tpu_torch.train import cli as tcli
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train.step import Trainer
from distributed_training_guide_tpu_torch.utils import (faults, heartbeat,
                                                        procguards, tracking)
import torch_threads  # noqa: F401  (one torch thread a test process)

ENVS = {
    "train": {faults.ENV_CRASH_STEP: "4", faults.ENV_CRASH_MODE: "exc",
              faults.ENV_NAN_LOSS_STEP: "2", faults.ENV_CORRUPT_CKPT_STEP: "6",
              faults.ENV_SAVE_LATENCY_S: "0.25"},
    "serve": {faults.ENV_HANDOFF_CRASH_XFER: "3",
              faults.ENV_HANDOFF_TIMEOUT_XFER: "5",
              faults.ENV_REPLICA_KILL: "r1@7",
              faults.ENV_REPLICA_WEDGE: "r2@9",
              faults.ENV_ARRIVAL_BURST: "3.5@1:2.5",
              faults.ENV_REPLICA_SLOW: "r0@0.125"},
    "elastic": {faults.ENV_SLICE_LOSS: "slice1@4",
                faults.ENV_SWAP_DROP_SEQ: "2"},
    "malformed": {faults.ENV_CRASH_STEP: "x", faults.ENV_REPLICA_KILL: "r1",
                  faults.ENV_ARRIVAL_BURST: "a@b", faults.ENV_SAVE_LATENCY_S:
                  "slow"},
    "none": {},
}


@pytest.mark.parametrize("env", sorted(ENVS))
def test_active_faults_equal_jax(monkeypatch, env):
    for name in dir(faults):
        if name.startswith("ENV_"):
            monkeypatch.delenv(getattr(faults, name), raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(faults.active_faults()) == dataclasses.asdict(
        jfaults.active_faults())
    assert {k for k in dir(faults) if k.startswith("ENV_")} == {
        k for k in dir(jfaults) if k.startswith("ENV_")}


def test_training_drills(monkeypatch, tmp_path):
    monkeypatch.setenv(faults.ENV_CRASH_STEP, "3")
    monkeypatch.setenv(faults.ENV_CRASH_MODE, "exc")
    faults.maybe_crash(2)
    with pytest.raises(RuntimeError, match="crash at global step 3"):
        faults.maybe_crash(3)
    ckpt = tmp_path / "checkpoint-2"
    ckpt.mkdir()
    (ckpt / "big").write_bytes(bytes(range(256)) * 4)
    (ckpt / "small").write_bytes(b"x")
    monkeypatch.setenv(faults.ENV_CORRUPT_CKPT_STEP, "2")
    faults.maybe_corrupt_checkpoint(ckpt, 1)
    assert (ckpt / "big").read_bytes()[:4] == bytes([0, 1, 2, 3])
    faults.maybe_corrupt_checkpoint(ckpt, 2)
    assert (ckpt / "big").read_bytes()[:4] == bytes([255, 254, 253, 252])


def test_heartbeat_write_read_age(tmp_path, monkeypatch):
    path = tmp_path / "hb" / "heartbeat.json"
    monkeypatch.delenv(heartbeat.HEARTBEAT_ENV, raising=False)
    assert not heartbeat.HeartbeatWriter().enabled
    assert not heartbeat.HeartbeatWriter().beat(1)     # a no-op unset
    monkeypatch.setenv(heartbeat.HEARTBEAT_ENV, str(path))
    writer = heartbeat.HeartbeatWriter(min_interval_s=3600)
    assert writer.beat(5) and not writer.beat(6)       # throttled
    assert writer.beat(7, force=True)
    beat = heartbeat.read_heartbeat(path)
    assert beat["step"] == 7 and beat == jheartbeat.read_heartbeat(path)
    monitor = heartbeat.HeartbeatMonitor(path)
    assert monitor.age_s(now=beat["time"] + 2.5) == pytest.approx(2.5)
    assert heartbeat.HeartbeatMonitor(tmp_path / "none").age_s() is None
    path.write_text("{torn")
    assert heartbeat.read_heartbeat(path) is None


def test_process_guards_without_a_process_group():
    assert procguards.is_process0() and procguards.process_count() == 1
    procguards.sync_processes("noop")
    ran = []
    with procguards.process0_first():
        ran.append("first")
    with procguards.process_ordered(False):
        ran.append("second")
    assert ran == ["first", "second"]


def test_log_dict_logs_what_jax_s_logs(caplog):
    """The same record as the JAX package's ``log_dict``: floats rounded to
    6 places, other values as they are."""
    import logging

    from distributed_training_guide_tpu.utils import log_dict as jlog_dict
    from distributed_training_guide_tpu_torch.utils import log_dict

    info = {"running_loss": 6.2345678912, "global_step": 3, "lr": 3e-5,
            "tag": "x", "tokens_per_s": 1234.56789123}
    logger = logging.getLogger("log_dict_test")
    with caplog.at_level(logging.INFO, logger="log_dict_test"):
        log_dict(logger, info)
        jlog_dict(logger, info)
    port, jax_ = (r.getMessage() for r in caplog.records)
    assert port == jax_ == str({"running_loss": 6.234568, "global_step": 3,
                                "lr": 3e-05, "tag": "x",
                                "tokens_per_s": 1234.567891})


@pytest.mark.parametrize("policy", ["fp32", "adam8bit"])
def test_mesh_descriptor_equals_jax_single_plan(policy):
    jt = JTrainer(bundle=jget_model("llama-debug"),
                  optimizer=jopt.adamw_cosine(1e-3), precision=policy)
    tt = Trainer(bundle=get_model("llama-debug"),
                 optimizer=topt.adamw_cosine(1e-3), precision=policy,
                 device="cpu")
    assert reshard.mesh_descriptor(tt) == jreshard.mesh_descriptor(jt)
    assert reshard.describe_layout(reshard.mesh_descriptor(tt)) == \
        jreshard.describe_layout(jreshard.mesh_descriptor(jt))


# ---- tracking, with a stub wandb ------------------------------------------

def _fake_wandb(tmp_path):
    mod = types.ModuleType("wandb")
    mod.logged, mod.inits, mod.finished = [], [], 0

    def init(**kwargs):
        mod.inits.append(kwargs)
        return types.SimpleNamespace(kwargs=kwargs)

    def log(info, step=None):
        mod.logged.append((dict(info), step))

    def finish():
        mod.finished += 1

    mod.init, mod.log, mod.finish = init, log, finish
    mod.util = types.SimpleNamespace(generate_id=lambda: "fakeid01")
    return mod


@pytest.fixture
def fake_wandb(tmp_path, monkeypatch):
    mod = _fake_wandb(tmp_path)
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def _args(*extra):
    return tcli.get_parser().parse_args(
        ["-m", "llama-debug", "-d", "synthetic:20000", "-s", "64", "-b", "2",
         "--log-freq", "2", "--device", "cpu", *extra])


def test_tracker_modes_and_resume_id(tmp_path, fake_wandb):
    args = _args("--wandb", "-e", "run", "--wandb-project", "p")
    tr = tracking.make_tracker(args, exp_dir=tmp_path / "run",
                               config={"a": 1})
    assert tr.enabled and fake_wandb.inits[-1]["id"] == "fakeid01"
    assert (tmp_path / "run" / "wandb_id.txt").read_text() == "fakeid01"
    assert fake_wandb.inits[-1]["resume"] == "allow"
    fake_wandb.util.generate_id = lambda: "other"
    tracking.make_tracker(args, exp_dir=tmp_path / "run")
    assert fake_wandb.inits[-1]["id"] == "fakeid01"       # reused on resume
    tracking.make_tracker(args, mode="per-host")
    assert fake_wandb.inits[-1]["name"] == "proc-0"
    assert fake_wandb.inits[-1]["group"] == "run"
    tr.log({"x": 1.0}, step=3)
    tr.finish()
    assert fake_wandb.logged == [({"x": 1.0}, 3)] and fake_wandb.finished == 1


def test_tracker_is_a_noop_without_the_flag_or_the_module(monkeypatch):
    assert not tracking.make_tracker(_args()).enabled
    monkeypatch.setitem(sys.modules, "wandb", None)     # import fails
    assert not tracking.make_tracker(_args("--wandb")).enabled


def test_run_training_logs_each_info_dict(tmp_path, fake_wandb):
    out = tcli.run_training(_args("--wandb", "--max-steps", "4", "-e", "w",
                                  "--save-dir", str(tmp_path),
                                  "--ckpt-freq", "100"))
    assert [s for _, s in fake_wandb.logged] == [2, 4]
    assert fake_wandb.logged[-1][0]["running_loss"] == pytest.approx(
        out["last_info"]["running_loss"])
    assert fake_wandb.finished == 1
    assert json.loads(json.dumps(fake_wandb.inits[0]["config"]))[
        "model_name"] == "llama-debug"
