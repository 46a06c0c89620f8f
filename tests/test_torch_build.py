"""The kernels' build key, on the CPU (no nvcc needed): a library is named
by a hash of its own source, of every shared header in ``csrc/`` and of the
flags, so that an edit to a header such as ``hopper.cuh`` rebuilds each
library that may include it, and an edit to one source rebuilds only that
source's library. Run in a temporary copy of ``csrc/``."""
import shutil

import pytest

from distributed_training_guide_tpu_torch.ops import _build
import torch_threads  # noqa: F401  (one torch thread a test process)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _paths():
    return {name: _build.library_path(name) for name in _build.all_sources()}


def test_sources_are_the_cu_files_and_hopper_cuh_is_shared(csrc):
    names = _build.all_sources()
    assert {"flash_fwd", "flash_bwd", "grouped_matmul"} <= set(names)
    assert "hopper" not in names
    for name in ("flash_fwd", "flash_bwd", "grouped_matmul"):
        assert '#include "hopper.cuh"' in (csrc / f"{name}.cu").read_text()


def test_a_header_edit_renames_every_library(csrc):
    before = _paths()
    assert before == _paths()                       # the key is stable
    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = _paths()
    for name in before:
        assert after[name] != before[name], name
        assert after[name].parent == _build.BUILD_DIR


def test_a_new_header_renames_every_library(csrc):
    before = _paths()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _paths()
    assert all(after[name] != before[name] for name in before)


def test_a_source_edit_renames_only_its_library(csrc):
    before = _paths()
    src = csrc / "grouped_matmul.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    after = _paths()
    for name in before:
        assert (after[name] != before[name]) == (name == "grouped_matmul")
