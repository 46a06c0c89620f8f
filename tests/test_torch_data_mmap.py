"""The port's ``--mmap-data`` path against the JAX package's on the CPU:
the same cache key, a ``.tokens.bin`` file byte-identical to JAX's for the
same dataset (synthetic, and a local text file through the byte
tokenizer), a second load that reuses the file, batches from the memmap
equal to the in-memory array's and to the JAX loader's, the CLI flag end
to end, and an HF ``datasets`` corpus (a stub of the library in
``sys.modules``) tokenized and spilled as JAX's is."""
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.data import loader as jloader
from distributed_training_guide_tpu.data import pipeline as jpipeline
from distributed_training_guide_tpu.data.tokenizer import \
    ByteTokenizer as JByteTokenizer
from distributed_training_guide_tpu_torch.data import BatchLoader
from distributed_training_guide_tpu_torch.data import pipeline as tpipeline
from distributed_training_guide_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_training_guide_tpu_torch.train import cli as tcli
import torch_threads  # noqa: F401  (one torch thread a test process)


def _text_file(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("the quick brown fox jumps over the lazy dog. " * 40)
    return str(path)


@pytest.mark.parametrize("source", ["synthetic:30000", "text"])
def test_token_file_is_byte_identical_to_jax(tmp_path, source):
    name = _text_file(tmp_path) if source == "text" else source
    jdata = jpipeline.load_and_preprocess_data(
        name, JByteTokenizer(), 32, seed=3, mmap_dir=tmp_path / "jax")
    tdata = tpipeline.load_and_preprocess_data(
        name, ByteTokenizer(), 32, seed=3, mmap_dir=tmp_path / "torch")
    assert isinstance(tdata, np.memmap) and tdata.dtype == np.int32
    jfile, tfile = os.path.basename(jdata.filename), os.path.basename(
        tdata.filename)
    assert tfile == jfile and tfile.endswith(".tokens.bin")
    assert (tmp_path / "torch" / tfile).read_bytes() == \
        (tmp_path / "jax" / jfile).read_bytes()
    plain = tpipeline.load_and_preprocess_data(name, ByteTokenizer(), 32,
                                               seed=3)
    assert np.array_equal(np.asarray(tdata), plain)


def test_second_load_reuses_the_file(tmp_path):
    first = tpipeline.load_and_preprocess_data(
        "synthetic:20000", None, 16, seed=1, mmap_dir=tmp_path)
    stamp = os.stat(first.filename).st_mtime_ns
    again = tpipeline.load_and_preprocess_data(
        "synthetic:20000", None, 16, seed=1, mmap_dir=tmp_path)
    assert again.filename == first.filename
    assert os.stat(again.filename).st_mtime_ns == stamp
    assert not again.flags.writeable            # read-only view


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_memmap_batches_equal_the_array_and_jax(tmp_path, grad_accum):
    data = tpipeline.load_and_preprocess_data(
        "synthetic:20000", None, 16, seed=2, mmap_dir=tmp_path)
    plain = np.asarray(data).copy()
    mm = BatchLoader(data, 8, device="cpu", grad_accum=grad_accum, seed=2)
    ram = BatchLoader(plain, 8, device="cpu", grad_accum=grad_accum, seed=2)
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    jl = jloader.ShardedBatchLoader(plain, 8, sharding, grad_accum=grad_accum,
                                    seed=2)
    for epoch, start in ((0, 0), (1, 5)):
        for loader in (mm, ram, jl):
            loader.set_epoch(epoch)
        batches = zip(mm.epoch_batches(start), ram.epoch_batches(start),
                      jl.epoch_batches(start))
        for a, b, c in batches:
            assert torch.equal(a["input_ids"], b["input_ids"])
            assert np.array_equal(a["input_ids"].numpy(),
                                  np.asarray(c["input_ids"]))
    jl.close()


def test_cli_trains_from_the_memmap(tmp_path):
    args = tcli.get_parser().parse_args(
        ["-m", "llama-debug", "-d", "synthetic:20000", "-s", "64", "-b", "2",
         "--max-steps", "2", "--log-freq", "2", "--device", "cpu",
         "--mmap-data", str(tmp_path)])
    out = tcli.run_training(args)
    assert np.isfinite(out["last_info"]["running_loss"])
    assert len(list(tmp_path.glob("*.tokens.bin"))) == 1


def _fake_datasets():
    """A stand-in for the ``datasets`` library, whose hub datasets need the
    network: one "train" split of two text rows."""
    texts = ["hello world " * 30, "the lazy dog " * 40]

    class Split:
        column_names = ["text"]

        def map(self, fn, batched, remove_columns, desc):
            return {"input_ids": fn({"text": texts})["input_ids"]}

    mod = types.ModuleType("datasets")
    mod.load_dataset = lambda name, subset: {"train": Split()}
    return mod


def test_hf_dataset_tokenizes_like_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", _fake_datasets())
    jdata = jpipeline.load_and_preprocess_data(
        "org/corpus", JByteTokenizer(), 32, mmap_dir=tmp_path / "jax")
    tdata = tpipeline.load_and_preprocess_data(
        "org/corpus", ByteTokenizer(), 32, mmap_dir=tmp_path / "torch")
    assert np.array_equal(np.asarray(tdata), np.asarray(jdata))
    assert os.path.basename(tdata.filename) == os.path.basename(
        jdata.filename)


def test_tokenizer_of_a_config_only_dir_skips_transformers(tmp_path,
                                                           monkeypatch):
    """``hf:<dir>`` of a config without tokenizer files gets the byte
    tokenizer, as the JAX package's lookup ends (transformers fails there),
    without asking transformers; a dir with a tokenizer file still asks
    it (a stub of the library in ``sys.modules``)."""
    from distributed_training_guide_tpu.data.tokenizer import (
        get_tokenizer as jget_tokenizer)
    from distributed_training_guide_tpu_torch.data.tokenizer import (
        get_tokenizer)

    (tmp_path / "config.json").write_text('{"model_type": "llama"}')
    asked = []

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(name, **kw):
            asked.append(name)
            return "hf-tokenizer"

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        AutoTokenizer=AutoTokenizer))
    got = get_tokenizer(f"hf:{tmp_path}")
    assert isinstance(got, ByteTokenizer) and asked == []
    monkeypatch.delitem(sys.modules, "transformers")
    assert type(jget_tokenizer(f"hf:{tmp_path}")).__name__ == "ByteTokenizer"
    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        AutoTokenizer=AutoTokenizer))
    (tmp_path / "tokenizer.json").write_text("{}")
    assert get_tokenizer(f"hf:{tmp_path}") == "hf-tokenizer"
    assert asked == [str(tmp_path)]
