"""Host offload of the training state (``train/offload.py``) on the CPU.

The offloaded state crosses to the device before a step and back after;
the update is the same, so every loss, grad norm and param must be bitwise
the run's without offload: on one device under fp32, bf16-master +
adam8bit (quantized moments) and adafactor, through a checkpoint save and
restore, under the guard's skip, through chapter 05's CLI flags, and under
fsdp on 2 gloo ranks (``tests/torch_dist_worker.py --scenario offload``).
Between steps every offloaded tensor is one of the offload's host buffers
(pinning needs a card; ``tests/test_torch_gpu.py`` checks it there)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_training_guide_tpu_torch.checkpoint import (
    CheckpointIO, restore_train_state, stamp_host_state)
from distributed_training_guide_tpu_torch.models import get_model
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train.state import (
    host_state_dict, named_leaves)
from distributed_training_guide_tpu_torch.train.step import Trainer
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]
OFFLOADS = {"none": {}, "opt": {"offload_opt_state": True},
            "both": {"offload_opt_state": True, "offload_params": True}}
POLICIES = [("fp32", "adamw"), ("bf16-master+adam8bit", "adamw"),
            ("fp32", "adafactor")]


def _trainer(precision="fp32", opt="adamw", guard="off", **off):
    return Trainer(bundle=get_model("llama-debug"),
                   optimizer=topt.OPTIMIZERS[opt](1e-3), precision=precision,
                   guard_policy=guard, device="cpu", **off)


def _batches(n=3):
    gen = np.random.default_rng(0)
    return [torch.from_numpy(gen.integers(0, 512, (2, 32))) for _ in range(n)]


def _run(t, batches, state=None, save=None):
    state = t.init_state(0) if state is None else state
    out = []
    for i, ids in enumerate(batches, start=1):
        state, m = t.step_fn(state, {"input_ids": ids, "labels": ids})
        out.append((float(m["loss"]), float(m["grad_norm"])))
        if state.offload is not None:
            assert state.offload.on_host(state)
        if save is not None and i == save[1]:
            io = CheckpointIO(save[0])
            host = stamp_host_state(host_state_dict(), t)
            host["global_step"] = i
            io.save(state, host)
            io.close()
    return out, state


def _params(state):
    return {p: t.detach().clone() for p, t in named_leaves(state.params)}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("precision,opt", POLICIES,
                         ids=[f"{p}-{o}" for p, o in POLICIES])
def test_offload_is_bitwise_the_run_without(precision, opt):
    batches = _batches()
    want, ref = _run(_trainer(precision, opt), batches)
    for name in ("opt", "both"):
        got, state = _run(_trainer(precision, opt, **OFFLOADS[name]),
                          batches)
        assert got == want, name
        assert _same(_params(state), _params(ref)), name
        slots = sum(t.numel() * t.element_size()
                    for p in state.opt_state.optimizer.state
                    for t in topt.state_slots(state.opt_state.optimizer,
                                              p).values())
        params = sum(t.numel() * t.element_size()
                     for _, t in named_leaves(state.params))
        assert state.offload.host_bytes(state) == (
            slots + (params if name == "both" else 0))


def test_offload_through_a_save_and_restore(tmp_path):
    batches = _batches(4)
    want, ref = _run(_trainer("bf16-master+adam8bit"), batches)
    t = _trainer("bf16-master+adam8bit", **OFFLOADS["both"])
    got, _ = _run(t, batches[:2], save=(tmp_path, 2))
    assert got == want[:2]
    t2 = _trainer("bf16-master+adam8bit", **OFFLOADS["both"])
    state, host = restore_train_state(CheckpointIO(tmp_path), t2)
    assert host["global_step"] == 2 and state.offload.on_host(state)
    resumed, state = _run(t2, batches[2:], state=state)
    assert resumed == want[2:]
    assert _same(_params(state), _params(ref))


def test_offload_under_the_guards_skip(monkeypatch):
    monkeypatch.setenv("DTG_FAULT_NAN_LOSS_STEP", "1")
    batches = _batches()
    want, ref = _run(_trainer(guard="skip"), batches)
    got, state = _run(_trainer(guard="skip", **OFFLOADS["both"]), batches)
    assert np.isnan(want[1][0]) and np.isnan(got[1][0])
    assert [w for i, w in enumerate(want) if i != 1] == [
        g for i, g in enumerate(got) if i != 1]
    assert _same(_params(state), _params(ref))


def test_chapter05_offload_flags_train_bitwise():
    from distributed_training_guide_tpu_torch.chapters import c05_llama405b

    argv = ["-m", "llama-debug", "-d", "synthetic:20000", "-s", "64", "-b",
            "2", "--max-steps", "3", "--log-freq", "1", "--device", "cpu"]
    runs = [c05_llama405b.main(argv + flags) for flags in
            ([], ["--offload-opt-state"],
             ["--offload-opt-state", "--offload-params"])]
    losses = [[i["running_loss"] for i in r["infos"]] for r in runs]
    norms = [[i["grad_norm"] for i in r["infos"]] for r in runs]
    assert len(losses[0]) == 3
    assert losses[0] == losses[1] == losses[2]
    assert norms[0] == norms[1] == norms[2]
    state = runs[2]["state"]
    assert state.offload.on_host(state)
    # a param that were a view would keep its base's storage where the
    # offload moved the view's (fsdp at world 1 shards nothing)
    assert all(p._base is None for _, p in named_leaves(state.params))


def test_offload_under_fsdp_on_two_gloo_ranks(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "distributed_training_guide_tpu_torch.launch."
         "local", "--nproc", "2", "--log-dir", str(tmp_path / "logs"), "--",
         sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         "--dir", str(tmp_path), "--scenario", "offload"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    logs = "\n".join(p.read_text()[-3000:]
                     for p in sorted((tmp_path / "logs").glob("*.err")))
    assert out.returncode == 0, out.stderr[-3000:] + logs
    got = json.loads((tmp_path / "offload.json").read_text())
    for precision in ("fp32", "adam8bit"):
        r = got[precision]
        assert r["offload"] == r["plain"], precision
        assert r["resumed"] == r["plain"][1:], precision
        assert r["params_equal"] and r["resumed_params_equal"], precision
        assert r["on_host"] and r["bytes_on_host"] > 0, precision
    g = got["guard_skip"]
    assert np.isnan(g["plain"][1][0]) and np.isnan(g["offload"][1][0])
    assert g["plain"][0] == g["offload"][0]
    assert g["plain"][2] == g["offload"][2]
    assert g["params_equal"]
