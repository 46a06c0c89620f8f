"""PyTorch + CUDA port of ``distributed_training_guide_tpu`` for one NVIDIA
H100, built slice by slice beside the JAX package, which stays the
reference every port module is tested against.

Ported so far: the serving path (the Llama family in ``models/llama.py``,
the paged KV cache and its continuous-batching engine in ``serve/``, the
paged-attention kernel ``ops/csrc/paged_attend.cu``) and chapter 01's
single-device training loop (``train/``, ``data/``, ``utils/``, the loss
in ``ops/cross_entropy.py`` and the flash-attention kernels
``ops/csrc/flash_fwd.cu`` and ``flash_bwd.cu``) with all of chapter 01
(checkpoints and resume in ``checkpoint/``, precision policies, adafactor
and lion, remat policies in ``ops/remat.py``, fault drills, heartbeat,
tracking, memmap data), chapter 10's mixture of experts with the grouped
matmuls, and int8 serve weights with the block-dequant matmul. Every
kernel is
hand-written in CUDA for ``sm_90a`` and built at first use by
``ops/_build.py``.
Module names follow the JAX package so each module's counterpart is easy
to find; nothing here imports jax or the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``_device.resolve_device``); on the CPU every kernel wrapper runs its
plain PyTorch version, which is how the tests hold the port against JAX.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
