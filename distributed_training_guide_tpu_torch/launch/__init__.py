"""Launch helpers: process-group init, the local gang launcher, error
files."""
from .distributed import maybe_initialize_distributed

__all__ = ["maybe_initialize_distributed"]
