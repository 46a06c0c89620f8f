"""Host C++ sources of the port (the token loader of
``data/native_loader.py``); the CUDA kernels live in ``ops/csrc``."""
