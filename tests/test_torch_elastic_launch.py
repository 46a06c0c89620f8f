"""The port's elastic world renegotiation (``launch/elastic.py``) and the
supervisor's drills on the CPU, against the JAX package.

- The protocol units of ``tests/test_elastic_train.py`` (membership
  liveness, the barrier'd agreement, dropped stragglers, id-fenced acks,
  fencing, the member helper and its slice-loss fault, the worker command's
  tokens) run through JAX's functions and the port's alike.
- ``worker_world_env``: the ``DTG_WORLD_*`` keys equal JAX's, and no
  ``XLA_FLAGS`` is set (a torch rank is one device).
- Interop: a JAX negotiator acks a port proposal and reads the port's
  ``world.json``, and the reverse, on one coordination directory.
- The slice-loss drill: the port's supervisor, its ``--member`` helper and
  a gloo gang ``launch.local --nproc {world_devices}`` of chapter 02 at
  ``-b {world_batch}``; the member is killed after the step-2 checkpoint
  and the world goes 2 -> 1 with the global batch held. Every logged step
  holds an uninterrupted world-2 run within ``tests/test_torch_dist.py``'s
  bound of DDP against one device (losses rtol 1e-4: the sums over ranks
  run in another order), and ``elastic.jsonl`` records 2 -> 1.
- The crash drill of ``tests/test_chaos.py`` through the port's train
  CLI: SIGKILL after the step-4 checkpoint, a restart that resumes, and
  stitched losses equal to the uninterrupted run's."""
import ast
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from distributed_training_guide_tpu.launch import elastic as jel
from distributed_training_guide_tpu_torch.launch import elastic as tel
from distributed_training_guide_tpu_torch.utils import faults
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]
ELASTIC = {"jax": jel, "torch": tel}
LOSS_RTOL = 1e-4        # tests/test_torch_dist.py: DDP against one device


@pytest.fixture(params=sorted(ELASTIC))
def el(request):
    return ELASTIC[request.param]


def test_membership_liveness(el, tmp_path):
    a = el.SliceMember(tmp_path, "a")
    b = el.SliceMember(tmp_path, "b")
    a.beat()
    b.beat()
    assert el.live_members(tmp_path, 5.0) == ["a", "b"]
    assert el.live_members(tmp_path, 5.0, now=time.time() + 10) == []
    b.retire()
    assert el.live_members(tmp_path, 5.0) == ["a"]


def test_world_agreement_barrier_and_stragglers(el, tmp_path):
    """A follower acks, the leader publishes world 1 and logs its event;
    a proposed member that never acks is dropped under a fresh id."""
    a = el.WorldNegotiator(tmp_path / "x", "a", ack_timeout_s=5.0)
    b = el.WorldNegotiator(tmp_path / "x", "b")
    got = {}
    t = threading.Thread(target=lambda: got.update(b=b.follow(0, 5.0)))
    t.start()
    world = a.propose_and_agree(["a", "b"], "start")
    t.join()
    assert (world["world_id"], world["members"]) == (1, ["a", "b"])
    assert got["b"]["world_id"] == 1
    events = el.read_events(tmp_path / "x")
    assert len(events) == 1 and "wall_time" in events[0]
    assert (events[0]["event"], events[0]["old_world"],
            events[0]["new_world"]["members"], events[0]["trigger"]) == (
        "renegotiated", None, ["a", "b"], "start")

    a = el.WorldNegotiator(tmp_path / "y", "a", ack_timeout_s=0.3)
    b = el.WorldNegotiator(tmp_path / "y", "b")
    t = threading.Thread(target=lambda: b.follow(0, 5.0))
    t.start()
    world = a.propose_and_agree(["a", "b", "ghost"], "start")
    t.join()
    assert world["members"] == ["a", "b"] and world["world_id"] >= 2


def test_single_member_stale_ack_and_fencing(el, tmp_path):
    """A lone member agrees at once; an ack left by an earlier incarnation
    names an old id and cannot pass a newer barrier; a member outside the
    published world is fenced out."""
    a = el.WorldNegotiator(tmp_path, "a", ack_timeout_s=0.3)
    world = a.propose_and_agree(["a"], "start")
    assert (world["world_id"], world["members"]) == (1, ["a"])
    el._write_json_atomic(tmp_path / "world.ack.b.json",
                          {"world_id": 1, "member": "b"})
    assert a.propose_and_agree(["a", "b"], "slice_joined")["members"] == [
        "a"]
    with pytest.raises(el.FencedOutError):
        el.WorldNegotiator(tmp_path, "b").follow(0, 0.5)


def test_member_helper_slice_loss_and_fencing(el, tmp_path, monkeypatch):
    """``DTG_FAULT_SLICE_LOSS`` kills the helper at its 3rd beat without
    retiring its file; a stale world that predates a member's join does
    not fence it, a newer world that drops it does."""
    monkeypatch.setenv(faults.ENV_SLICE_LOSS, "b@3")
    assert el.run_member(tmp_path / "x", "b", interval_s=0.01,
                         max_beats=50) == 1
    payload = json.loads((tmp_path / "x" / el.MEMBERS_DIR / "b.json")
                         .read_text())
    assert payload["beats"] == 3
    assert el.live_members(tmp_path / "x", 60.0) == ["b"]
    assert el.live_members(tmp_path / "x", 0.0, now=time.time() + 1) == []
    monkeypatch.delenv(faults.ENV_SLICE_LOSS)

    coord = tmp_path / "y"
    el._write_json_atomic(coord / el.WORLD_FILE,
                          {"world_id": 5, "members": ["a"]})
    assert el.run_member(coord, "b", interval_s=0.001, max_beats=20) == 0
    assert not (coord / el.MEMBERS_DIR / "b.json").exists()
    el._write_json_atomic(coord / el.WORLD_FILE,
                          {"world_id": 6, "members": ["a", "b"]})
    done = {}
    t = threading.Thread(target=lambda: done.update(rc=el.run_member(
        coord, "b", interval_s=0.01, max_beats=500)))
    t.start()
    time.sleep(0.1)
    el._write_json_atomic(coord / el.WORLD_FILE,
                          {"world_id": 7, "members": ["a"]})
    t.join(timeout=10)
    assert done.get("rc") == 0
    assert not (coord / el.MEMBERS_DIR / "b.json").exists()


def test_render_worker_cmd_tokens(el):
    cmd = ["python", "train.py", "-b", "{world_batch}",
           "--note", "world={world_devices}"]
    assert el.render_worker_cmd(cmd, 4, global_batch=8) == [
        "python", "train.py", "-b", "2", "--note", "world=4"]
    with pytest.raises(ValueError, match="elastic-global-batch"):
        el.render_worker_cmd(["-b", "{world_batch}"], 4)
    with pytest.raises(ValueError, match="not divisible"):
        el.render_worker_cmd(["-b", "{world_batch}"], 3, global_batch=8)


def test_worker_world_env_sets_the_world_and_no_xla_flag():
    world = {"world_id": 3, "members": ["a", "b"]}
    jenv = jel.worker_world_env({"XLA_FLAGS": "--xla_foo=1"}, world, 4)
    tenv = tel.worker_world_env({}, world, 4)
    keys = ("DTG_WORLD_ID", "DTG_WORLD_MEMBERS", "DTG_WORLD_DEVICES")
    assert {k: tenv[k] for k in keys} == {k: jenv[k] for k in keys} == {
        "DTG_WORLD_ID": "3", "DTG_WORLD_MEMBERS": "a,b",
        "DTG_WORLD_DEVICES": "4"}
    assert set(tenv) == set(keys)


@pytest.mark.parametrize("leader", ["jax", "torch"])
def test_coordination_files_interoperate(leader, tmp_path):
    """One directory, a leader of one package and a follower of the
    other: the follower acks the leader's proposal and reads its
    ``world.json``, both beat members the other sees, and the event line
    is what either package reads."""
    follower = "torch" if leader == "jax" else "jax"
    lead, foll = ELASTIC[leader], ELASTIC[follower]
    lead.SliceMember(tmp_path, "a").beat()
    foll.SliceMember(tmp_path, "b").beat()
    assert lead.live_members(tmp_path, 5.0) == foll.live_members(
        tmp_path, 5.0) == ["a", "b"]
    got = {}
    t = threading.Thread(target=lambda: got.update(world=foll.WorldNegotiator(
        tmp_path, "b").follow(0, 5.0)))
    t.start()
    world = lead.WorldNegotiator(tmp_path, "a", ack_timeout_s=5.0) \
        .propose_and_agree(["a", "b"], "start")
    t.join()
    assert got["world"] == world == foll.WorldNegotiator(
        tmp_path, "b").current()
    assert world["members"] == ["a", "b"]
    assert foll.read_events(tmp_path) == lead.read_events(tmp_path)


# ---- the drills (subprocesses) -------------------------------------------

TRAIN_FLAGS = ["-d", "synthetic:20000", "-s", "64", "--log-freq", "1",
               "--device", "cpu"]


@pytest.fixture(scope="module")
def debug_model(tmp_path_factory) -> list:
    """``-m hf:<dir>`` of llama-debug's config: a dir without tokenizer
    files, so the workers start without importing transformers (the byte
    tokenizer, as for ``-m llama-debug``)."""
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.models.hf_export import (
        _hf_config)

    d = tmp_path_factory.mktemp("llama-debug")
    (d / "config.json").write_text(json.dumps(_hf_config(get_model(
        "llama-debug"))))
    return ["-m", f"hf:{d}"]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _losses_by_step(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        at = line.find("INFO:{")
        if at >= 0:
            try:
                d = ast.literal_eval(line[at + 5:])
            except (ValueError, SyntaxError):
                continue
            if isinstance(d, dict) and "global_step" in d:
                out.setdefault(d["global_step"], []).append(
                    d["running_loss"])
    return out


def _attempt_text(logs: Path, n: int) -> str:
    d = logs / f"attempt_{n}"
    return (d / "stdout.log").read_text() + (d / "stderr.log").read_text()


def _module(name: str) -> list:
    return [sys.executable, "-m",
            f"distributed_training_guide_tpu_torch.{name}"]


def test_slice_loss_renegotiates_two_to_one_and_resumes(debug_model,
                                                        tmp_path):
    """World 2 (two members of one device each) at global batch 4 loses
    its peer after the step-2 checkpoint: the supervisor SIGTERMs the
    gang, agrees the 1-member world and re-execs it at ``-b 4``, which
    resumes from the newest checkpoint onto one rank."""
    n_steps = 24
    chapter = [*_module("chapters.c02_ddp"), *debug_model, *TRAIN_FLAGS,
               "--max-steps", str(n_steps)]
    # the uninterrupted world-2 run, beside the drill
    golden = subprocess.Popen(
        [*_module("launch.local"), "--nproc", "2", "--", *chapter,
         "-b", "2", "--save-dir", str(tmp_path / "golden")],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    coord, logs, work = tmp_path / "coord", tmp_path / "sup", tmp_path / "w"
    member = subprocess.Popen(
        [*_module("launch.elastic"), "--member", "slice1", "--dir",
         str(coord), "--interval", "0.1"], cwd=ROOT, env=_env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def kill_member_after_checkpoint():
        deadline = time.time() + 300
        while time.time() < deadline and not (
                work / "drill" / "checkpoint-2").exists():
            time.sleep(0.1)
        time.sleep(0.3)                  # state.json publishes after it
        member.kill()                    # the slice is gone, no cleanup

    killer = threading.Thread(target=kill_member_after_checkpoint,
                              daemon=True)
    try:
        killer.start()
        # the save latency paces the run (0.25 s a checkpoint), so the
        # loss lands mid-run whatever this machine's speed
        proc = subprocess.run(
            [*_module("launch.supervisor"), "--max-restarts", "1",
             "--restart-backoff", "0.05", "--log-dir", str(logs),
             "--elastic-dir", str(coord), "--slice-name", "slice0",
             "--devices-per-slice", "1", "--liveness-timeout", "1.0",
             "--elastic-global-batch", "4", "--",
             *_module("launch.local"), "--nproc", "{world_devices}", "--",
             *chapter, "-b", "{world_batch}", "--ckpt-freq", "2",
             "-e", "drill", "--save-dir", str(work)],
            cwd=ROOT, env=_env(**{faults.ENV_SAVE_LATENCY_S: "0.25"}),
            capture_output=True, text=True, timeout=400)
        gold_out, _ = golden.communicate(timeout=400)
    finally:
        member.kill()
        golden.kill()
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert golden.returncode == 0, gold_out[-3000:]
    want = {k: v[0] for k, v in _losses_by_step(gold_out).items()}
    assert set(want) == set(range(1, n_steps + 1))

    events = tel.read_events(coord)
    assert [e["new_world"]["members"] for e in events] == [
        ["slice0", "slice1"], ["slice0"]], events
    assert events[1]["old_world"]["members"] == ["slice0", "slice1"]
    assert events[1]["trigger"] == "slice_lost"
    assert "renegotiation (slice_lost)" in out
    first = _attempt_text(logs, 0)
    second = _attempt_text(logs, 1)
    assert "global batch 4" in first and "global batch 4" in second
    assert "strategy=ddp" in first and "strategy=ddp" in second
    assert "Resumed=True" in second
    got = _losses_by_step(first + second)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for step, losses in got.items():
        for loss in losses:
            assert loss == pytest.approx(want[step], rel=LOSS_RTOL), (
                step, losses, want[step])


def test_crash_restart_resume_matches_uninterrupted(debug_model, tmp_path):
    """``DTG_FAULT_CRASH_STEP=4`` SIGKILLs the port's train CLI after the
    step-4 checkpoint; the supervisor restarts it, the restart resumes
    from checkpoint-4 and runs steps 5-6. The stitched losses equal the
    uninterrupted run's, and the heartbeat reached step 5 or later."""
    from distributed_training_guide_tpu_torch.train import cli

    train = [*_module("train"), *debug_model, *TRAIN_FLAGS, "-b", "2",
             "--max-steps", "6"]
    logs = tmp_path / "sup"
    proc = subprocess.Popen(
        [*_module("launch.supervisor"), "--max-restarts", "2",
         "--restart-backoff", "0.05", "--log-dir", str(logs), "--", *train,
         "--ckpt-freq", "2", "-e", "drill", "--save-dir", str(tmp_path)],
        cwd=ROOT, env=_env(**{faults.ENV_CRASH_STEP: "4"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        golden = cli.run_training(cli.get_parser().parse_args(train[3:]))
        out, _ = proc.communicate(timeout=300)
    finally:
        proc.kill()
    want = {i["global_step"]: i["running_loss"] for i in golden["infos"]}
    assert proc.returncode == 0, out[-3000:]
    assert "attempt 0 failed rc=-9" in out
    assert "attempt 1 exited cleanly" in out
    first = _losses_by_step(_attempt_text(logs, 0))
    second_text = _attempt_text(logs, 1)
    second = _losses_by_step(second_text)
    assert set(first) == {1, 2, 3, 4} and set(second) == {5, 6}
    assert "Resumed=True" in second_text
    stitched = {k: v[0] for k, v in {**first, **second}.items()}
    assert stitched == want
    hb = json.loads((logs / "attempt_1" / "heartbeat.json").read_text())
    assert hb["step"] >= 5
