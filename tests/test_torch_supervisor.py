"""The port's restart supervisor and failure classification against the
JAX package's (``launch/supervisor.py``, ``launch/errors.py``).

Each scenario of ``tests/test_launchers.py``'s supervisor tests runs once
through JAX's ``run_supervised`` and once through the port's, in-process,
on the same tiny ``python -c`` workers (which import no torch), and both
must give the same return code, the same attempt dirs, the same backoff
sleeps (``time`` patched in the supervisor module where they are
checked) and the same poison reason. ``classify_error`` runs on JAX's
payloads (``tests/test_errors.py``) in both packages, on the real torch
errors whose wording JAX's patterns miss (the port's added patterns),
and on a real gloo error of a rank whose peer died, which must stay
transient in both."""
import json
import os
import sys
import time
import types

import pytest

from distributed_training_guide_tpu.launch import errors as jerrors
from distributed_training_guide_tpu.launch import supervisor as jsup
from distributed_training_guide_tpu_torch.launch import errors as terrors
from distributed_training_guide_tpu_torch.launch import supervisor as tsup

PY = sys.executable
SUPERVISORS = {"jax": jsup, "torch": tsup}


@pytest.fixture(params=sorted(SUPERVISORS))
def sup(request):
    return SUPERVISORS[request.param]


def _dirs(log_dir) -> list:
    return sorted(p.name for p in log_dir.iterdir() if p.is_dir())


def _recording_sleeps(monkeypatch, module) -> list:
    """The supervisor module's ``time`` with ``sleep`` recorded, not
    slept (only the backoff sleeps without a heartbeat timeout)."""
    sleeps = []
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        time=time.time, sleep=sleeps.append))
    return sleeps


def _error_writing_worker(error: str, suffix: str = "",
                          foreign: bool = False) -> list:
    """A worker that writes a torchelastic-style error file (what
    ``@record`` does; ``foreign``: {"message": "<string>"}) to
    ``$ERROR_FILE`` + ``suffix`` and exits 1."""
    message = repr(error) if foreign else (
        f"{{'error': {error!r}, 'traceback': '...'}}")
    return [PY, "-c", (
        "import json, os, sys\n"
        f"path = os.environ['ERROR_FILE'] + {suffix!r}\n"
        "os.makedirs(os.path.dirname(path) or '.', exist_ok=True)\n"
        "with open(path, 'w') as fp:\n"
        f"    json.dump({{'message': {message}}}, fp)\n"
        "sys.exit(1)\n")]


def _poison_line(out: str):
    lines = [ln for ln in out.splitlines() if "non-retryable failure" in ln]
    return lines[0].split("(", 1)[1].rsplit(")", 1)[0] if lines else None


def test_restart_then_succeed(sup, tmp_path, monkeypatch):
    """Exit 3 on the first attempt, 0 on the second: one restart after one
    backoff sleep, per-attempt logs and the ERROR_FILE env contract."""
    sleeps = _recording_sleeps(monkeypatch, sup)
    sentinel = tmp_path / "ran_once"
    cmd = [PY, "-c", (
        "import os, pathlib, sys\n"
        f"s = pathlib.Path({str(sentinel)!r})\n"
        "print('attempt with ERROR_FILE', os.environ['ERROR_FILE'])\n"
        "if s.exists():\n"
        "    sys.exit(0)\n"
        "s.write_text('x')\n"
        "sys.exit(3)\n")]
    logs = tmp_path / "logs"
    rc = sup.run_supervised(cmd, max_restarts=2, log_dir=logs,
                            restart_backoff=0.05)
    assert (rc, _dirs(logs), sleeps) == (0, ["attempt_0", "attempt_1"],
                                         [0.05])
    for n in (0, 1):
        out = (logs / f"attempt_{n}" / "stdout.log").read_text()
        assert f"attempt_{n}" in out


def test_restarts_exhausted_and_backoff_schedule(sup, tmp_path, monkeypatch):
    """An always-failing worker: the backoff doubles from its base up to
    the cap, one sleep before each restart, and the last rc is returned
    once the restarts are spent; a cap under the base bounds the first
    sleep."""
    sleeps = _recording_sleeps(monkeypatch, sup)
    fail = [PY, "-c", "import sys; sys.exit(9)"]
    rc = sup.run_supervised(fail, max_restarts=3, log_dir=tmp_path / "a",
                            restart_backoff=0.4, backoff_cap=1.0)
    assert (rc, _dirs(tmp_path / "a"), sleeps) == (
        9, [f"attempt_{n}" for n in range(4)], [0.4, 0.8, 1.0])
    sleeps.clear()
    rc = sup.run_supervised([PY, "-c", "import sys; sys.exit(5)"],
                            max_restarts=1, log_dir=tmp_path / "b",
                            restart_backoff=10.0, backoff_cap=0.1)
    assert (rc, _dirs(tmp_path / "b"), sleeps) == (
        5, ["attempt_0", "attempt_1"], [0.1])


# (error, ERROR_FILE suffix, foreign shape, the poison reason or None)
POISON_CASES = {
    "oom_main_file": (
        "XlaRuntimeError('RESOURCE_EXHAUSTED: Out of memory allocating 1TB')",
        "", False, "oom"),
    "shape_rank_file": (
        "ValueError('8 devices not divisible by tensor x pipeline = 3')",
        ".rank1", False, "shape/sharding"),
    "foreign_shape": ("RESOURCE_EXHAUSTED: out of memory", "", True, "oom"),
    "transient": ("ConnectionError('coordinator unreachable')", "", False,
                  None),
}


def test_poison_pills_stop_the_restarts(sup, tmp_path, capsys):
    """A poison error file (the main one, a gang's ``.rankN`` file, or a
    foreign ``{"message": "<string>"}``) stops after attempt 0; a
    transient one restarts; ``stop_on_poison=False`` (the CLI's
    ``--restart-on-poison``) restarts a poison pill anyway."""
    for case, (error, suffix, foreign, reason) in POISON_CASES.items():
        worker = _error_writing_worker(error, suffix, foreign)
        logs = tmp_path / case
        rc = sup.run_supervised(worker, max_restarts=2, log_dir=logs,
                                restart_backoff=0.0)
        got = _poison_line(capsys.readouterr().out)
        want_dirs = ["attempt_0"] if reason else [
            "attempt_0", "attempt_1", "attempt_2"]
        assert (rc, _dirs(logs)) == (1, want_dirs), case
        if reason is None:
            assert got is None, case
            continue
        assert got == f"{reason}: {error} (error.json{suffix})", case
        rc = sup.run_supervised(worker, max_restarts=1,
                                log_dir=tmp_path / f"{case}_override",
                                restart_backoff=0.0, stop_on_poison=False)
        assert (rc, _dirs(tmp_path / f"{case}_override")) == (
            1, ["attempt_0", "attempt_1"]), case


def test_stale_error_files_are_fenced(sup, tmp_path, monkeypatch):
    """A preset ``$ERROR_FILE`` left by an earlier incarnation is unlinked
    before the launch, so a failing worker that writes none keeps its
    restarts; with the unlink defeated, the mtime fence alone ignores a
    payload older than the launch."""
    stale = tmp_path / "err.json"
    stale.write_text(json.dumps({"message": {
        "error": "XlaRuntimeError('RESOURCE_EXHAUSTED: OOM from last week')"
    }}))
    monkeypatch.setenv("ERROR_FILE", str(stale))
    rc = sup.run_supervised([PY, "-c", "import sys; sys.exit(1)"],
                            max_restarts=1, log_dir=tmp_path / "logs",
                            restart_backoff=0.0)
    assert (rc, _dirs(tmp_path / "logs")) == (1, ["attempt_0", "attempt_1"])
    assert not stale.exists()
    err = tmp_path / "error.json"
    err.write_text(json.dumps({"message": {
        "error": "RESOURCE_EXHAUSTED: out of memory"}}))
    old = time.time() - 3600
    os.utime(err, (old, old))
    assert sup._poison_reason(err, launched_at=time.time()) is None
    assert sup._poison_reason(err, launched_at=old - 10) == (
        "oom: RESOURCE_EXHAUSTED: out of memory (error.json)")


def test_heartbeat_preferred_over_log_silence(sup, tmp_path):
    """A worker that logs nothing but beats ``$HEARTBEAT_FILE`` lives past
    a heartbeat timeout shorter than its run."""
    cmd = [PY, "-c", (
        "import json, os, time\n"
        "path = os.environ['HEARTBEAT_FILE']\n"
        "for step in range(5):\n"
        "    with open(path + '.tmp', 'w') as fp:\n"
        "        json.dump({'step': step, 'time': time.time()}, fp)\n"
        "    os.replace(path + '.tmp', path)\n"
        "    time.sleep(0.4)\n")]
    logs = tmp_path / "logs"
    rc = sup.run_supervised(cmd, max_restarts=0, log_dir=logs,
                            heartbeat_timeout=1.5)
    assert (rc, _dirs(logs)) == (0, ["attempt_0"])


@pytest.mark.parametrize("worker", ["stale_heartbeat", "hung"])
def test_stale_heartbeat_and_hung_worker_are_killed(sup, worker, tmp_path,
                                                    capsys):
    """A worker that beats once and then chats on stdout forever is
    killed when its heartbeat goes stale; one that prints once and
    sleeps is killed by the log-size fallback. Both SIGKILLed (rc -9)."""
    body = {
        "stale_heartbeat": (
            "import json, os, time\n"
            "with open(os.environ['HEARTBEAT_FILE'], 'w') as fp:\n"
            "    json.dump({'step': 1, 'time': time.time()}, fp)\n"
            "while True:\n"
            "    print('still chatting', flush=True)\n"
            "    time.sleep(0.2)\n"),
        "hung": "import time\nprint('alive', flush=True)\ntime.sleep(600)\n",
    }[worker]
    t0 = time.time()
    logs = tmp_path / "logs"
    rc = sup.run_supervised([PY, "-c", body], max_restarts=0, log_dir=logs,
                            heartbeat_timeout=1.0)
    assert (rc, _dirs(logs)) == (-9, ["attempt_0"])
    assert time.time() - t0 < 60
    kind = "heartbeat" if worker == "stale_heartbeat" else "logs"
    assert f"no {kind} progress for 1.0s -> SIGKILL (hang)" in \
        capsys.readouterr().out


# ---- classification ---------------------------------------------------------

def _payload(error_repr, traceback=""):
    return {"message": {"error": error_repr, "traceback": traceback}}


# tests/test_errors.py's payloads and their reasons in the JAX package
JAX_PAYLOADS = [
    (_payload("XlaRuntimeError('RESOURCE_EXHAUSTED: Out of memory "
              "allocating 123456 bytes')"), "oom"),
    (_payload("ValueError('8 devices not divisible by tensor x pipeline = "
              "3')"), "shape/sharding"),
    (_payload("NonFiniteLossError('non-finite training step 7: ...')"),
     "non-finite"),
    (_payload("RuntimeError('injected failure after step-3 checkpoint "
              "(test)')"), None),
    (_payload("ConnectionError('coordinator unreachable')"), None),
    ({}, None),
    ({"message": "RESOURCE_EXHAUSTED: oom"}, "oom"),
    ({"message": "it broke"}, None),
    ("not even a dict", None),
    (_payload('XlaRuntimeError("INVALID_ARGUMENT: Multiprocess computations '
              "aren't implemented on the CPU backend.\")"), None),
    (_payload("XlaRuntimeError('INVALID_ARGUMENT: Sharding contains unknown "
              "device')"), None),
    (_payload("TimeoutError('barrier timed out')",
              traceback="File jax/_src/sharding_impls.py line 1 ..."), None),
]


def test_classify_error_on_jax_payloads():
    """Every payload of ``tests/test_errors.py`` classifies alike in both
    packages: the three poison classes, transient errors, foreign file
    shapes, a gang's collateral teardown errors, and a pattern that only
    the traceback names."""
    for payload, reason in JAX_PAYLOADS:
        assert jerrors.classify_error(payload) == reason, payload
        assert terrors.classify_error(payload) == reason, payload


# torch's wording of the poison classes, each raised for real below
TORCH_ERRORS = {
    "cpu_oom": (lambda torch: torch.empty(10 ** 15), "oom"),
    "matmul_shapes": (lambda torch: torch.ones(2, 3) @ torch.ones(4, 5),
                      "shape/sharding"),
    "broadcast": (lambda torch: torch.ones(3) + torch.ones(4),
                  "shape/sharding"),
    "view": (lambda torch: torch.ones(6).view(5), "shape/sharding"),
}


@pytest.mark.parametrize("kind", sorted(TORCH_ERRORS))
def test_classify_torch_errors_jax_patterns_miss(kind, tmp_path):
    """The port's added patterns, each on the error file ``@record``
    writes for a real torch error that JAX's patterns pass as transient;
    torch's CUDA OOM ("CUDA out of memory") already matches JAX's."""
    import torch

    fn, reason = TORCH_ERRORS[kind]
    with pytest.raises(RuntimeError) as info:
        fn(torch)
    path = tmp_path / "error.json"
    terrors.write_error_file(info.value, str(path))
    payload = json.loads(path.read_text())
    assert terrors.classify_error(payload) == reason
    assert jerrors.classify_error(payload) is None
    cuda_oom = torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")
    assert terrors.classify_error(_payload(repr(cuda_oom))) == "oom"
    assert jerrors.classify_error(_payload(repr(cuda_oom))) == "oom"


def _dead_peer_error() -> str:
    """The error rank 0 of a 2-rank gloo group raises when rank 1's end
    goes away (both ranks in this process, one thread each)."""
    import threading

    import torch
    import torch.distributed as dist

    store, pgs = dist.HashStore(), {}

    def each_rank(fn):
        threads = [threading.Thread(target=fn, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    each_rank(lambda r: pgs.update({r: dist.ProcessGroupGloo(store, r, 2)}))
    each_rank(lambda r: pgs[r].allreduce([torch.ones(1)]).wait())
    del pgs[1]                   # the peer's sockets close
    try:
        pgs[0].allreduce([torch.ones(1)]).wait()
    except RuntimeError as exc:
        return repr(exc)
    raise AssertionError("the collective survived its peer")


def test_a_dead_peer_stays_transient():
    """The error a gloo rank raises when its peer process dies, and
    NCCL's wording of the same, are not poison in either package: a
    restart after a peer's death is what the supervisor is for."""
    gloo = _dead_peer_error()
    assert "Connection closed by peer" in gloo, gloo
    nccl = ("DistBackendError('NCCL error in: ProcessGroupNCCL.cpp:2057, "
            "remote process exited or there was a network error, NCCL "
            "version 2.21.5\\nncclRemoteError: A call failed possibly due "
            "to a network error or a remote process exiting prematurely.')")
    for error in (gloo, nccl):
        assert terrors.classify_error(_payload(error)) is None
        assert jerrors.classify_error(_payload(error)) is None
