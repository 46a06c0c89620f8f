"""PyTorch + CUDA port of ``distributed_training_guide_tpu`` for NVIDIA
H100 cards, built slice by slice beside the JAX package, which stays the
reference every port module is tested against.

Ported so far:

- chapter 01's training loop (``train/``, ``data/``, ``utils/``,
  ``checkpoint/``): checkpoints and resume, precision policies, AdamW /
  adafactor / lion, remat policies, fault drills, heartbeat, tracking,
  memmap data and the C++ token loader (``data/native_loader.py`` over
  ``csrc/token_loader.cpp``);
- the sharding plans of chapters 02-10 (``parallel/``, ``chapters/``):
  ddp, ZeRO, fsdp, tp, 2D, the zigzag ring and Ulysses, the 1F1B
  pipeline, expert parallelism, the overlap schedule and the fused loss;
  HF conversion and export (chapter 05); the dense families and LoRA;
- the serve plane (``serve/``): the paged KV engine with speculation,
  decode horizons, int8 weights, multi-LoRA tenants, the HTTP endpoint
  and the fleet (disaggregation, the router, the host tier, elastic
  generations, the controller); on-policy post-training (``post/``);
- the runtime tooling (``launch/``, ``monitor/``): the gang launcher,
  the restart supervisor (poison pills, heartbeat kills), elastic world
  renegotiation, and the nvidia-smi cluster monitor.

The seven kernels the JAX package wrote in Pallas are hand-written in
CUDA for ``sm_90a`` (``ops/csrc/``: flash attention forward and backward,
paged attention, the grouped matmuls, the block-dequant matmul) and built
at first use by ``ops/_build.py``. Module names follow the JAX package so
each module's counterpart is easy to find; nothing here imports jax or the
JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``_device.resolve_device``); on the CPU every kernel wrapper runs its
plain PyTorch version, which is how the tests hold the port against JAX.
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    # imported on first use, so that the package's torch-free tools (the
    # supervisor, the monitor's ``--local``) start without importing torch
    if name == "resolve_device":
        from ._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
