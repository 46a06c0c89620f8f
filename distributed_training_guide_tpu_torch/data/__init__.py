"""Data of the port: tokenizer, token pipeline, the batch loader (Python
or C++ assembly: ``native_loader.py``)."""
from .loader import BatchLoader
from .pipeline import load_and_preprocess_data, synthetic_dataset
from .tokenizer import ByteTokenizer, get_tokenizer

__all__ = ["BatchLoader", "ByteTokenizer", "get_tokenizer",
           "load_and_preprocess_data", "synthetic_dataset"]
