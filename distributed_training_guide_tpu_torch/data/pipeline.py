"""Data pipeline: text -> fixed-length token sequences.

Counterpart of ``distributed_training_guide_tpu/data/pipeline.py``:
tokenize, concatenate, chunk into ``seq_length`` blocks; the labels are the
input ids (the loss shifts). Sources: ``synthetic[:n_tokens]`` (seeded
tokens, the same numpy stream as the JAX package) and a local
``.txt`` / ``.jsonl`` file, or an HF ``datasets`` name where that library
and its cache are present. Output: one int32 array
[num_sequences, seq_length]; with ``mmap_dir`` (``--mmap-data``) a
read-only ``np.memmap`` over a raw int32 ``<cache_key>.tokens.bin``, the
JAX package's ``_spill_to_memmap`` layout and cache key, so the two
packages write byte-identical files for the same dataset.
"""
from __future__ import annotations

import json
import logging
import os
import re
from pathlib import Path

import numpy as np

LOGGER = logging.getLogger(__name__)


def _chunk(token_stream: np.ndarray, seq_length: int) -> np.ndarray:
    n = (len(token_stream) // seq_length) * seq_length
    if n == 0:
        raise ValueError(f"corpus too small: {len(token_stream)} tokens < "
                         f"seq_length={seq_length}")
    return token_stream[:n].astype(np.int32).reshape(-1, seq_length)


def synthetic_dataset(n_tokens: int, vocab_size: int, seq_length: int,
                      seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    # Markov-ish structure so the loss actually decreases during smoke runs
    base = rng.randint(0, vocab_size, size=n_tokens, dtype=np.int64)
    repeat_mask = rng.rand(n_tokens) < 0.5
    stream = np.where(repeat_mask, np.roll(base, 1), base)
    return _chunk(stream, seq_length)


def _tokenize_batch(tokenizer, texts: list[str]) -> list[list[int]]:
    out = tokenizer(texts)["input_ids"]
    if out and isinstance(out[0], int):
        out = [out]
    return out


def _from_local_file(path: Path, tokenizer, seq_length: int) -> np.ndarray:
    if path.suffix == ".jsonl":
        texts = [json.loads(line).get("text", "")
                 for line in path.read_text().splitlines() if line]
    else:
        texts = [path.read_text()]
    ids: list[int] = []
    for id_list in _tokenize_batch(tokenizer, texts):
        ids.extend(id_list)
    return _chunk(np.asarray(ids, dtype=np.int64), seq_length)


def _from_hf(dataset_name: str, subset, tokenizer,
             seq_length: int) -> np.ndarray:
    """An HF ``datasets`` dataset (the reference's ``--dataset-name
    tatsu-lab/alpaca``), where the library and its cache are present;
    ``datasets`` is imported only here."""
    import datasets

    split = datasets.load_dataset(dataset_name, subset)["train"]
    column = "text" if "text" in split.column_names else split.column_names[0]
    tokenized = split.map(lambda ex: tokenizer(ex[column]), batched=True,
                          remove_columns=split.column_names,
                          desc="tokenizing")
    stream = np.concatenate([np.asarray(x, dtype=np.int64)
                             for x in tokenized["input_ids"]])
    return _chunk(stream, seq_length)


def _spill_to_memmap(arr: np.ndarray, mmap_dir: str | Path,
                     cache_key: str) -> np.ndarray:
    """Write the corpus once as a raw int32 token file (no header) and
    return a read-only memmap of it: host RAM then holds only the rows a
    batch reads. A file of the expected size is reused; a writer replaces
    the file atomically from a pid-unique temporary, so concurrent writers
    never leave a torn file."""
    mmap_dir = Path(mmap_dir)
    mmap_dir.mkdir(parents=True, exist_ok=True)
    path = mmap_dir / f"{cache_key}.tokens.bin"
    expect = arr.size * 4
    if not path.exists() or path.stat().st_size != expect:
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        np.ascontiguousarray(arr, dtype=np.int32).tofile(tmp)
        tmp.replace(path)
        LOGGER.info(f"spilled corpus to {path} ({expect >> 20} MiB)")
    return np.memmap(path, dtype=np.int32, mode="r", shape=arr.shape)


def mmap_cache_key(dataset_name: str, tokenizer, seq_length: int,
                   seed: int, dataset_subset: str | None = None) -> str:
    """The token file's name stem: everything that changes its content
    (dataset, subset, tokenizer, sequence length, seed), as the JAX
    package names it."""
    if tokenizer is None:
        tok_id = "none"
    else:
        tok_id = (getattr(tokenizer, "name_or_path", None)
                  or type(tokenizer).__name__)
    return re.sub(r"[^A-Za-z0-9._-]+", "_",
                  f"{dataset_name}-{dataset_subset or ''}-{tok_id}"
                  f"-s{seq_length}-r{seed}")


def load_and_preprocess_data(dataset_name: str, tokenizer, seq_length: int,
                             *, max_position_embeddings: int | None = None,
                             seed: int = 0,
                             dataset_subset: str | None = None,
                             mmap_dir: str | Path | None = None
                             ) -> np.ndarray:
    """Returns [num_sequences, seq_length] int32: an array, or with
    ``mmap_dir`` a read-only memmap of the spilled token file."""
    if max_position_embeddings:
        seq_length = min(seq_length, max_position_embeddings)
    if dataset_name.startswith("synthetic"):
        n_tokens = 1_000_000
        if ":" in dataset_name:
            n_tokens = int(dataset_name.split(":", 1)[1])
        vocab = getattr(tokenizer, "vocab_size", 259)
        data = synthetic_dataset(n_tokens, vocab, seq_length, seed)
    elif Path(dataset_name).exists():
        data = _from_local_file(Path(dataset_name), tokenizer, seq_length)
    else:
        data = _from_hf(dataset_name, dataset_subset, tokenizer, seq_length)
    if mmap_dir is not None:
        data = _spill_to_memmap(data, mmap_dir, mmap_cache_key(
            dataset_name, tokenizer, seq_length, seed, dataset_subset))
    return data
