"""The port's native token loader (``data/native_loader.py``,
``csrc/token_loader.cpp``) against the JAX package's.

The C++ source is byte for byte JAX's; on one token file, seed, epoch and
``start_step`` the two libraries hand out byte-equal batches (JAX's built
from a temp copy of its source, so nothing is written into the JAX
package); the port's library lands under ``build/``; an epoch covers each
sequence once, two loaders of one seed agree, and ``start_step`` equals
skipping that many batches. Through the training CLI at llama-debug,
``--native-loader`` in the port holds JAX's CLI with ``--native-loader``
within the bound ``tests/test_torch_train.py`` holds the two chapter-01
CLIs to (losses rtol 1e-3: bf16 compute in two frameworks, the same fp32
weights), and a ``--mmap-data``-shaped memmap is read in place."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_training_guide_tpu.data import native_loader as jnative
from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu_torch.data import BatchLoader
from distributed_training_guide_tpu_torch.data import native_loader as tnative
from distributed_training_guide_tpu_torch.models import from_jax
from distributed_training_guide_tpu_torch.models import llama as tllama
from distributed_training_guide_tpu_torch.train import cli as tcli
import torch_threads  # noqa: F401  (one torch thread a test process)

# tests/test_torch_train.py:test_cli_bf16_params_follow_the_jax_cli
CLI_RTOL = 1e-3
SEQ, BATCH = 16, 4


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    data = np.random.RandomState(3).randint(0, 1000, (103, SEQ))
    path = tmp_path_factory.mktemp("tokens") / "data.tokens.bin"
    tnative.write_token_file(data, path)
    return data.astype(np.int32), path


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """JAX's bindings over a library built from a temp copy of its source
    (``_CSRC`` patched for the build only)."""
    csrc = tmp_path_factory.mktemp("jax_csrc")
    shutil.copy(jnative._CSRC / "token_loader.cpp", csrc)
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_CSRC", csrc)
    mp.setattr(jnative, "_LIB", None)
    mp.setattr(jnative, "_BUILD_FAILED", False)
    assert jnative.native_available()
    yield jnative
    mp.undo()


def test_source_is_jax_s_byte_for_byte():
    assert (tnative._CSRC / "token_loader.cpp").read_bytes() == (
        jnative._CSRC / "token_loader.cpp").read_bytes()


def test_library_lands_under_build():
    assert tnative.native_available()
    path = tnative.library_path()
    assert path.is_file()
    assert path.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("epoch,start", [(0, 0), (1, 0), (2, 7)])
def test_batches_equal_jax_s(token_file, jax_lib, epoch, start):
    _, path = token_file
    t = tnative.NativeTokenLoader(path, SEQ, BATCH, seed=5)
    j = jax_lib.NativeTokenLoader(path, SEQ, BATCH, seed=5)
    got = list(t.epoch_batches(epoch, start))
    want = list(j.epoch_batches(epoch, start))
    t.close()
    j.close()
    assert len(got) == len(want) == 103 // BATCH - start
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        assert a.tobytes() == b.tobytes()


def test_epoch_coverage_determinism_and_start_step(token_file):
    data, path = token_file
    a = tnative.NativeTokenLoader(path, SEQ, BATCH, seed=9)
    b = tnative.NativeTokenLoader(path, SEQ, BATCH, seed=9)
    whole = np.concatenate(list(a.epoch_batches(0)))
    assert (len(a), a.num_sequences) == (103 // BATCH, 103)
    rows = {r.tobytes() for r in whole}
    assert len(whole) == len(rows) == (103 // BATCH) * BATCH
    assert rows <= {r.tobytes() for r in data}
    assert np.array_equal(np.concatenate(list(b.epoch_batches(0))), whole)
    tail = np.concatenate(list(b.epoch_batches(0, start_step=5)))
    assert np.array_equal(tail, whole[5 * BATCH:])
    assert not np.array_equal(np.concatenate(list(a.epoch_batches(1))),
                              whole)
    a.close()
    b.close()


def test_batch_loader_native_path(token_file, tmp_path):
    """``BatchLoader(native=True)``: a memmap in the raw token layout is
    mmapped in place, an in-memory dataset through a temp token file that
    ``close`` removes; the batches are the C++ loader's, as int64 on the
    device, and grad accumulation reshapes them as the JAX loader does."""
    data, path = token_file
    mm = np.memmap(path, dtype=np.int32, mode="r", shape=data.shape)
    direct = tnative.NativeTokenLoader(path, SEQ, 8, seed=1)
    want = list(direct.epoch_batches(1))
    direct.close()
    for ds in (mm, data):
        loader = BatchLoader(ds, 8, device="cpu", seed=1, grad_accum=2,
                             native=True)
        assert loader.backend == "native"
        owned = loader._native_path
        assert (owned is None) == (ds is mm)
        loader.set_epoch(1)
        got = [b["input_ids"] for b in loader.epoch_batches()]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == (2, 4, SEQ) and str(g.dtype) == "torch.int64"
            assert np.array_equal(g.numpy().reshape(8, SEQ), w)
        loader.close()
        if owned is not None:
            assert not os.path.exists(owned)


def test_cli_native_loader_holds_jax_s(jax_lib, monkeypatch):
    """Both CLIs with ``--native-loader`` on llama-debug from the JAX
    CLI's own init (carried across): 6 steps' losses within the CLIs'
    bound, the run names its loader, and a missing g++ falls back to the
    Python loader with the run saying so."""
    from distributed_training_guide_tpu.parallel import make_mesh, make_plan
    from distributed_training_guide_tpu.train import cli as jcli

    argv = ["-m", "llama-debug", "-d", "synthetic:20000", "-s", "64", "-b",
            "2", "--max-steps", "6", "--log-freq", "1", "--native-loader",
            "--lr", "1e-3"]
    # JAX's native path: jax_lib built it from a temp copy of its source
    jinfos = []
    real_info = jcli.LOGGER.info

    def capture(msg, *a, **kw):
        if isinstance(msg, dict) and "running_loss" in msg:
            jinfos.append(msg)
        return real_info(msg, *a, **kw)

    monkeypatch.setattr(jcli.LOGGER, "info", capture)
    jcli.run_training(jcli.get_parser().parse_args(argv),
                      lambda: make_plan("single",
                                        make_mesh(devices=jax.devices()[:1])))
    jb = jget_model("llama-debug", dtype=jnp.float32)
    init_rng, _ = jax.random.split(jax.random.key(0))
    jparams = jax.tree.map(np.asarray, jb.init(jb.config, init_rng))
    monkeypatch.setattr(tllama, "init", lambda config, rng, *, device=None:
                        from_jax.params_from_numpy(jparams, device=device))
    out = tcli.run_training(tcli.get_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert out["loader"] == "native"
    tlosses = [i["running_loss"] for i in out["infos"]]
    jlosses = [i["running_loss"] for i in jinfos]
    assert len(tlosses) == len(jlosses) == 6
    np.testing.assert_allclose(tlosses, jlosses, rtol=CLI_RTOL)

    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_BUILD_FAILED", True)
    out = tcli.run_training(tcli.get_parser().parse_args(
        argv + ["--device", "cpu", "--max-steps", "1"]))
    assert out["loader"] == "python"
