"""The port's checkpoints on the CPU, at llama-debug size: the manifest
against the JAX package's (field for field on the same directory, full and
sampled CRC, each side verifying the other's), resume through the CLI
bitwise equal to an uninterrupted 6-step run (fp32, ``bf16-master+
adam8bit`` and lion), the ``keep_n`` chain, the fallback past a corrupted
latest checkpoint, the orphan sweep, the precision-policy stamps (a refusal
naming both policies; an fp32 checkpoint re-encoded into ``bf16-master``
with a warning), the async snapshot against in-place updates, write
retries, and the SIGKILL drill in a subprocess as ``tests/test_chaos.py``
runs it."""
import ast
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.checkpoint import manifest as jmanifest
from distributed_training_guide_tpu_torch.checkpoint import (
    CheckpointCorruptionError, CheckpointIO, manifest, restore_train_state,
    stamp_host_state)
from distributed_training_guide_tpu_torch.models import get_model
from distributed_training_guide_tpu_torch.train import cli as tcli
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train.state import (
    host_state_dict, state_tensors)
from distributed_training_guide_tpu_torch.train.step import Trainer
from distributed_training_guide_tpu_torch.utils import faults
import torch_threads  # noqa: F401  (one torch thread a test process)

REPO = Path(__file__).resolve().parents[1]
FLAGS = ["-m", "llama-debug", "-d", "synthetic:20000", "-s", "64", "-b", "2",
         "--log-freq", "1", "--device", "cpu"]


# ---- manifests -------------------------------------------------------------

def _fill(ckpt: Path) -> None:
    (ckpt / "sub").mkdir(parents=True)
    (ckpt / "a.bin").write_bytes(os.urandom(3000))
    (ckpt / "sub" / "b.bin").write_bytes(os.urandom(5 << 20))
    (ckpt / ".metadata").write_bytes(b"meta")


@pytest.mark.parametrize("mode", ["full", "sampled"])
def test_manifest_equals_jax_field_for_field(tmp_path, monkeypatch, mode):
    """Sampled: the threshold lowered to 4 KiB in both modules, so the
    5 MiB file gets the windowed CRC (format 2)."""
    if mode == "sampled":
        monkeypatch.setattr(manifest, "SAMPLE_THRESHOLD", 4096)
        monkeypatch.setattr(jmanifest, "SAMPLE_THRESHOLD", 4096)
    ckpt = tmp_path / "checkpoint-7"
    _fill(ckpt)
    host = {"global_step": 7, "epoch": 0, "precision_policy": "fp32"}
    mine = json.loads(manifest.write_manifest(ckpt, 7, host).read_text())
    theirs = json.loads(jmanifest.write_manifest(ckpt, 7, host).read_text())
    mine.pop("created"), theirs.pop("created")
    assert mine == theirs
    assert mine["format"] == (2 if mode == "sampled" else 1)
    assert manifest.verify_manifest(ckpt, theirs) == []
    assert jmanifest.verify_manifest(ckpt, mine) == []


def test_verify_catches_a_flipped_byte(tmp_path):
    ckpt = tmp_path / "checkpoint-1"
    _fill(ckpt)
    manifest.write_manifest(ckpt, 1, {})
    loaded = manifest.load_manifest(tmp_path, "checkpoint-1")
    assert manifest.verify_manifest(ckpt, loaded) == []
    data = bytearray((ckpt / "a.bin").read_bytes())
    data[1234] ^= 0x01
    (ckpt / "a.bin").write_bytes(bytes(data))
    assert manifest.verify_manifest(ckpt, loaded) == [
        "checksum mismatch: a.bin"]
    (ckpt / "sub" / "b.bin").unlink()
    assert "missing file: sub/b.bin" in manifest.verify_manifest(ckpt, loaded)


# ---- resume through the CLI --------------------------------------------------

def _losses(out) -> dict:
    return {i["global_step"]: i["running_loss"] for i in out["infos"]}


@pytest.mark.parametrize("extra", [
    [], ["--precision-policy", "bf16-master+adam8bit"],
    ["--optimizer", "lion"]], ids=["fp32", "bf16-master+adam8bit", "lion"])
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, extra):
    exp = ["-e", "x", "--save-dir", str(tmp_path), "--ckpt-freq", "2",
           *extra]
    golden = _losses(tcli.run_training(tcli.get_parser().parse_args(
        FLAGS + ["--max-steps", "6", *extra])))
    first = tcli.run_training(tcli.get_parser().parse_args(
        FLAGS + ["--max-steps", "4", *exp]))
    assert not first["resumed"]
    second = tcli.run_training(tcli.get_parser().parse_args(
        FLAGS + ["--max-steps", "6", *exp]))
    assert second["resumed"]
    assert _losses(first) == {k: golden[k] for k in (1, 2, 3, 4)}
    assert _losses(second) == {k: golden[k] for k in (5, 6)}
    assert second["host_state"]["global_step"] == 6


def _trainer(policy="fp32", lr=1e-2):
    return Trainer(bundle=get_model("llama-debug", dtype=torch.float32),
                   optimizer=topt.adamw_cosine(lr), precision=policy,
                   device="cpu")


def _batch(seed):
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 512, (2, 16))).long()
    return {"input_ids": ids, "labels": ids}


def _steps(trainer, state, n, seed0=0):
    for i in range(n):
        trainer.step_fn(state, _batch(seed0 + i))
    return state


def _host(step, trainer):
    host = host_state_dict()
    host["global_step"] = step
    return stamp_host_state(host, trainer)


def _snapshot(state) -> dict:
    return {k: v.clone() for k, v in state_tensors(state).items()}


def _assert_state_equal(state, snap):
    now = state_tensors(state)
    assert now.keys() == snap.keys()
    for k in snap:
        assert torch.equal(now[k], snap[k]), k


def test_keep_n_chain_and_manifests(tmp_path):
    t = _trainer()
    io = CheckpointIO(tmp_path, keep_n=2)
    state = t.init_state(0)
    for step in (2, 4, 6):
        _steps(t, state, 2, step)
        io.save(state, _host(step, t))
    io.close()
    chain = json.loads((tmp_path / "state.json").read_text())["retained"]
    assert chain == ["checkpoint-6", "checkpoint-4"]
    dirs = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert dirs == ["checkpoint-4", "checkpoint-6"]
    for name in chain:
        m = manifest.load_manifest(tmp_path, name)
        written = {str(p.relative_to(tmp_path / name))
                   for p in (tmp_path / name).rglob("*") if p.is_file()}
        assert {f["path"] for f in m["files"]} == written   # every file
        assert manifest.verify_manifest(tmp_path / name, m) == []
        assert m["host_state"]["precision_policy"] == "fp32"


def test_restore_falls_back_past_a_corrupted_latest(tmp_path, caplog):
    t = _trainer()
    io = CheckpointIO(tmp_path, keep_n=2)
    state = t.init_state(0)
    _steps(t, state, 2)
    io.save(state, _host(2, t))
    at2 = _snapshot(state)
    _steps(t, state, 2, 2)
    io.save(state, _host(4, t))
    assert faults.corrupt_checkpoint_dir(tmp_path / "checkpoint-4")
    with caplog.at_level(logging.WARNING):
        restored, host = CheckpointIO(tmp_path).restore(_trainer().init_state(
            5))
    assert host["global_step"] == 2
    assert "skipping checkpoint checkpoint-4" in caplog.text
    _assert_state_equal(restored, at2)
    assert faults.corrupt_checkpoint_dir(tmp_path / "checkpoint-2")
    with pytest.raises(CheckpointCorruptionError, match="checkpoint-2"):
        CheckpointIO(tmp_path).restore(_trainer().init_state(5))


def test_orphans_are_swept_by_the_first_save_only(tmp_path):
    t = _trainer()
    state = t.init_state(0)
    io = CheckpointIO(tmp_path)
    io.save(state, _host(1, t))
    (tmp_path / "checkpoint-9").mkdir()            # committed, unpublished
    (tmp_path / "checkpoint-8.manifest.json").write_text("{}")
    (tmp_path / "checkpoint-7.tmp").mkdir()        # a write that died
    CheckpointIO(tmp_path).restore(_trainer().init_state(0))
    assert (tmp_path / "checkpoint-9").exists()    # a reader deletes nothing
    fresh = CheckpointIO(tmp_path)
    fresh.save(state, _host(2, t))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["checkpoint-1", "checkpoint-1.manifest.json",
                     "checkpoint-2", "checkpoint-2.manifest.json",
                     "state.json"]


def test_a_policy_change_fails_loudly_naming_both(tmp_path):
    t8 = _trainer("adam8bit")
    state = t8.init_state(0)
    _steps(t8, state, 1)
    io = CheckpointIO(tmp_path)
    io.save(state, _host(1, t8))
    with pytest.raises(ValueError, match="'adam8bit'.*'bf16-master'"):
        restore_train_state(CheckpointIO(tmp_path), _trainer("bf16-master"))


def test_fp32_checkpoint_reencodes_into_bf16_master(tmp_path, caplog):
    t32 = _trainer()
    state = t32.init_state(0)
    _steps(t32, state, 2)
    CheckpointIO(tmp_path).save(state, _host(2, t32))
    t16 = _trainer("bf16-master")
    with caplog.at_level(logging.WARNING):
        restored, host = restore_train_state(CheckpointIO(tmp_path), t16)
    assert "re-encoding into precision policy 'bf16-master'" in caplog.text
    assert host["global_step"] == 2 and restored.step == 2
    opt, opt32 = restored.opt_state.optimizer, state.opt_state.optimizer
    assert opt.count == 2 and restored.opt_state.count == 2
    for (p, p32) in zip(opt.param_groups[0]["params"],
                        opt32.param_groups[0]["params"]):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, p32.detach().to(torch.bfloat16))
        for slot in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][slot],
                               opt32.state[p32][slot].to(torch.bfloat16))
    t16.step_fn(restored, _batch(9))              # and it trains on


def test_async_save_snapshots_before_the_next_step(tmp_path):
    """The step after an async save updates params and moments in place;
    the checkpoint holds the values of the save."""
    t = _trainer()
    state = t.init_state(0)
    _steps(t, state, 2)
    io = CheckpointIO(tmp_path, async_save=True)
    io.save(state, _host(2, t))
    saved = _snapshot(state)
    _steps(t, state, 3, 2)                 # runs while the write may not
    assert not torch.equal(state_tensors(state)["params/final_norm"],
                           saved["params/final_norm"])
    io.close()
    assert io.save_log[0]["async"] and "write_s" in io.save_log[0]
    restored, host = CheckpointIO(tmp_path).restore(_trainer().init_state(3))
    assert host["global_step"] == 2
    _assert_state_equal(restored, saved)


def test_a_failed_async_write_raises_at_the_next_save(tmp_path,
                                                      monkeypatch):
    t = _trainer()
    state = t.init_state(0)
    io = CheckpointIO(tmp_path, async_save=True)

    def broken(self, path, flat):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(CheckpointIO, "_write", broken)
    io.save(state, _host(1, t))
    with pytest.raises(OSError, match="No space"):
        io.save(state, _host(2, t))
    assert not (tmp_path / "state.json").exists()   # nothing published


def test_a_transient_write_error_is_retried(tmp_path, monkeypatch, caplog):
    t = _trainer()
    state = t.init_state(0)
    io = CheckpointIO(tmp_path, retry_backoff_s=0.0)
    real = CheckpointIO._write
    calls = []

    def flaky(self, path, flat):
        calls.append(path)
        if len(calls) == 1:
            raise OSError(5, "I/O error")
        return real(self, path, flat)

    monkeypatch.setattr(CheckpointIO, "_write", flaky)
    with caplog.at_level(logging.WARNING):
        io.save(state, _host(1, t))
    assert len(calls) == 2 and "attempt 1/3 failed" in caplog.text
    assert io.can_resume()


# ---- the SIGKILL drill -------------------------------------------------------

def _run(args, env_extra=None, timeout=240):
    # one torch thread, as the test process (tests/torch_threads.py)
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env_extra or {}))
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_training_guide_tpu_torch.train",
         *FLAGS, *args], capture_output=True, text=True, timeout=timeout,
        cwd=REPO, env=env)
    losses = {}
    for line in (proc.stdout + proc.stderr).splitlines():
        at = line.find("INFO:{")
        if at >= 0:
            d = ast.literal_eval(line[at + 5:])
            if "global_step" in d:
                losses[d["global_step"]] = d["running_loss"]
    return proc, losses


def test_sigkill_then_resume_matches_the_uninterrupted_run(tmp_path):
    exp = ["-e", "drill", "--save-dir", str(tmp_path), "--ckpt-freq", "2",
           "--max-steps", "6"]
    golden = _losses(tcli.run_training(tcli.get_parser().parse_args(
        FLAGS + ["--max-steps", "6"])))
    killed, first = _run(exp, {faults.ENV_CRASH_STEP: "4"})
    assert killed.returncode == -9                   # really SIGKILLed
    assert set(first) == {1, 2, 3, 4}
    resumed, second = _run(exp)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "Resumed=True" in resumed.stderr
    assert set(second) == {5, 6}
    assert {**first, **second} == golden
