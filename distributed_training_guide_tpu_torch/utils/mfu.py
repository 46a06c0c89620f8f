"""Model-FLOPs-utilization accounting.

Counterpart of ``distributed_training_guide_tpu/utils/mfu.py``: ``6 *
n_params`` matmul FLOPs per token for forward + backward (embedding
excluded when ``vocab_size`` is given), plus the dense attention term
``12 * n_layers * hidden * seq``. The peak is the card's dense bf16
tensor-core rate, from its name: NVIDIA's data sheets give 989 TFLOP/s for
the H100 and H200 SXM parts. The CPU gets a nominal 1e12, so CPU runs give
a finite MFU that means nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

# Peak dense bf16 FLOP/s by card-name substring (data sheets).
_PEAK_FLOPS = [("H100", 989e12), ("H200", 989e12)]


def transformer_flops_per_token(n_params: int, n_layers: int,
                                hidden_size: int, seq_len: int,
                                include_embedding: bool = False,
                                vocab_size: int = 0) -> float:
    """Training FLOPs (forward + backward) per token."""
    params = n_params
    if not include_embedding and vocab_size:
        params = n_params - vocab_size * hidden_size
    return 6.0 * params + 12.0 * n_layers * hidden_size * seq_len


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
