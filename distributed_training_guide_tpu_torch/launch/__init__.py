"""Launch helpers: process-group init, the local gang launcher, error
files and their classification, the restart supervisor and elastic world
renegotiation."""

__all__ = ["maybe_initialize_distributed"]


def __getattr__(name):
    # imported on first use: the supervisor and the gang launcher start
    # without importing torch
    if name == "maybe_initialize_distributed":
        from .distributed import maybe_initialize_distributed

        return maybe_initialize_distributed
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
