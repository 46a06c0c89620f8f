"""Data pipeline: text -> fixed-length token sequences.

Counterpart of ``distributed_training_guide_tpu/data/pipeline.py``:
tokenize, concatenate, chunk into ``seq_length`` blocks; the labels are the
input ids (the loss shifts). Sources: ``synthetic[:n_tokens]`` (seeded
tokens, the same numpy stream as the JAX package) and a local
``.txt`` / ``.jsonl`` file. Output: one int32 array
[num_sequences, seq_length].
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


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


def load_and_preprocess_data(dataset_name: str, tokenizer, seq_length: int,
                             *, max_position_embeddings: int | None = None,
                             seed: int = 0) -> np.ndarray:
    """Returns [num_sequences, seq_length] int32."""
    if max_position_embeddings:
        seq_length = min(seq_length, max_position_embeddings)
    if dataset_name.startswith("synthetic"):
        n_tokens = 1_000_000
        if ":" in dataset_name:
            n_tokens = int(dataset_name.split(":", 1)[1])
        vocab = getattr(tokenizer, "vocab_size", 259)
        return synthetic_dataset(n_tokens, vocab, seq_length, seed)
    path = Path(dataset_name)
    if path.exists():
        return _from_local_file(path, tokenizer, seq_length)
    raise NotImplementedError(
        f"dataset {dataset_name!r} is neither synthetic nor a local file; "
        f"HF hub datasets need the network and are not ported (ROADMAP.md "
        f"queue 1, 'Chapter 01 remainder')")
