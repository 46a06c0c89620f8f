"""Model-FLOPs-utilization accounting.

Counterpart of ``distributed_training_guide_tpu/utils/mfu.py``: ``6 *
n_params`` matmul FLOPs per token for forward + backward (embedding
excluded when ``vocab_size`` is given), plus the dense attention term
``12 * n_layers * hidden * seq``. The peak is the card's dense bf16
tensor-core rate, from its name: NVIDIA's data sheets give 989 TFLOP/s for
the H100 and H200 SXM parts. The CPU gets a nominal 1e12, so CPU runs give
a finite MFU that means nothing. ``TARGETS`` holds the data-sheet figures
the preflight roofline prices a plan at (``train/preflight.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

# Peak dense bf16 FLOP/s by card-name substring (data sheets).
_PEAK_FLOPS = [("H100", 989e12), ("H200", 989e12)]

# Preflight targets, by name (NVIDIA's H100 SXM data sheet; figures from
# the sheet, not measurements): dense bf16 FLOP/s, NVLink bytes/s per
# direction (900 GB/s total), HBM bytes.
TARGETS = {"h100": {"peak_flops": 989e12, "link_bytes_per_s": 450e9,
                    "hbm_bytes": 80e9}}


def target_spec(kind: str) -> dict:
    """The data-sheet figures of a preflight target (``TARGETS``)."""
    key = kind.lower()
    for name, spec in TARGETS.items():
        if name in key:
            return spec
    raise ValueError(f"unknown preflight target {kind!r}; known: "
                     f"{sorted(TARGETS)}")


def transformer_flops_per_token(n_params: int, n_layers: int,
                                hidden_size: int, seq_len: int,
                                include_embedding: bool = False,
                                vocab_size: int = 0,
                                attn_kv_len: Optional[float] = None) -> float:
    """Training FLOPs (forward + backward) per token. ``attn_kv_len``: the
    mean keys a query attends (default ``seq_len``, the conventional dense
    count; ``banded_attention_kv_length`` for windowed attention)."""
    params = n_params
    if not include_embedding and vocab_size:
        params = n_params - vocab_size * hidden_size
    return 6.0 * params + 12.0 * n_layers * hidden_size * (
        seq_len if attn_kv_len is None else attn_kv_len)


def banded_attention_kv_length(cfg, seq_len: int) -> float:
    """Mean keys per query over the layers under the config's windows
    (``layer_windows``, 0 = full attention on that layer, or a uniform
    ``sliding_window``); ``seq_len`` when unwindowed."""
    lw = getattr(cfg, "layer_windows", None)
    if lw:
        return sum(min(seq_len, w) if w else seq_len for w in lw) / len(lw)
    w = getattr(cfg, "sliding_window", None)
    if w:
        return float(min(seq_len, w))
    return float(seq_len)


def device_peak_flops(device: Optional[torch.device] = None) -> float:
    """Peak bf16 FLOP/s of ``device``; NaN for a card not in the table."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return 1e12
    name = torch.cuda.get_device_name(device)
    for key, flops in _PEAK_FLOPS:
        if key in name:
            return flops
    return float("nan")


def compute_mfu(tokens_per_s: float, flops_per_token: float,
                n_chips: int = 1,
                peak_flops_per_chip: Optional[float] = None,
                device: Optional[torch.device] = None) -> float:
    peak = peak_flops_per_chip or device_peak_flops(device)
    return (tokens_per_s * flops_per_token) / (peak * n_chips)
