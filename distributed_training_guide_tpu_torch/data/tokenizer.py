"""Tokenizer resolution.

Counterpart of ``distributed_training_guide_tpu/data/tokenizer.py``: an HF
tokenizer when one is cached locally, else the hermetic byte tokenizer.
Nothing is downloaded; a machine without ``transformers`` gets the byte
tokenizer.
"""
from __future__ import annotations

from pathlib import Path


class ByteTokenizer:
    """UTF-8 byte tokenizer: vocab = 256 bytes + BOS/EOS/PAD."""

    vocab_size = 259
    bos_token_id = 256
    eos_token_id = 257
    pad_token_id = 258
    model_max_length = 1 << 30

    def __call__(self, texts):
        if isinstance(texts, str):
            texts = [texts]
        return {"input_ids": [list(t.encode("utf-8")) + [self.eos_token_id]
                              for t in texts]}

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8",
                                                       errors="replace")


# the files an HF tokenizer loads from: a local dir with none of them (an
# ``hf:`` config written for random-weight training) has no tokenizer, and
# asking transformers, which takes seconds to import, would only fail
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                    "tokenizer.model", "vocab.json", "vocab.txt",
                    "merges.txt", "spiece.model", "sentencepiece.bpe.model")


def get_tokenizer(model_name: str):
    """HF tokenizer if locally cached, else the byte tokenizer."""
    if model_name.startswith("hf:"):
        model_name = model_name[3:]
    path = Path(model_name)
    if path.is_dir() and not any((path / f).exists()
                                 for f in _TOKENIZER_FILES):
        return ByteTokenizer()
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(model_name,
                                             local_files_only=True)
    # as the JAX function: an ``hf:`` dir with a config but no tokenizer
    # files fails inside transformers with other types too (AttributeError)
    except Exception:  # noqa: BLE001
        return ByteTokenizer()
