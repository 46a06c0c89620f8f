"""The weight bridge: the JAX package's params pytree, as numpy, to the
port's nested dict of torch tensors and back, leaf for leaf.

The port never imports jax: the caller turns the JAX tree into numpy
first (``jax.tree.map(np.asarray, params)``). Both packages keep every
per-layer leaf stacked on a leading ``[L]`` axis and weights as
``[in, out]``, so no leaf is transposed or reshaped. bf16 leaves arrive
as ml_dtypes' bfloat16 (the dtype numpy gets from jax) and are carried
bit for bit. A block-quantized leaf (the serve engine's int8 weights, a
NamedTuple with ``q`` and ``scale`` in either package) crosses as a
``train/precision.py`` ``Quantized`` of the two arrays, untouched: the
payload stays int8 and the scales fp32 whatever ``dtype`` asks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..train.precision import Quantized


def _to_torch(x, device, dtype) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":     # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _is_quantized(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "q") and hasattr(x, "scale")


def params_from_numpy(tree, *, device, dtype: Optional[torch.dtype] = None):
    """Nested dict of numpy arrays -> the same nested dict of torch
    tensors on ``device`` (float leaves cast to ``dtype`` when given;
    quantized leaves keep their int8 payload and fp32 scales)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if _is_quantized(tree):
        dev = torch.device(device)
        return Quantized(q=_to_torch(tree.q, dev, None),
                         scale=_to_torch(tree.scale, dev, None))
    return _to_torch(tree, torch.device(device), dtype)


def params_to_numpy(tree):
    """The inverse: nested dict of torch tensors -> numpy arrays (bf16 as
    ml_dtypes' bfloat16, the dtype jax reads); a ``Quantized`` leaf
    becomes a ``Quantized`` pair of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, Quantized):
        return Quantized(q=params_to_numpy(tree.q),
                         scale=params_to_numpy(tree.scale))
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def lora_from_numpy(tree, *, device, dtype: Optional[torch.dtype] = None):
    """The JAX package's LoRA trees, as numpy, to the port's: a LoRA
    trainer's params (``{"base": ..., "lora": {t: {"a", "b"}}}``), an
    adapter payload (``{t: {"a" [L, in, r], "b" [L, r, out]}}``, the
    ``params["lora"]`` subtree ``publish_adapter`` takes) or the engine's
    adapter stacks (``{t: {"a" [L, G, in, r], "b" [L, G, r, out]}}``).
    Both packages keep the same keys and shapes, so every leaf crosses as
    it is (cast to ``dtype`` when given); a tree of another layout is
    refused, naming what it holds."""
    def adapters(sub, where):
        for t, pair in sub.items():
            if not isinstance(pair, dict) or sorted(pair) != ["a", "b"]:
                raise ValueError(
                    f"{where}{t!r} must hold leaves {{'a', 'b'}}, got "
                    f"{sorted(pair) if isinstance(pair, dict) else pair!r}")

    if not isinstance(tree, dict):
        raise ValueError(f"a LoRA tree is a dict, got {type(tree).__name__}")
    if sorted(tree) == ["base", "lora"]:
        adapters(tree["lora"], "params['lora']")
    else:
        adapters(tree, "adapter target ")
    return params_from_numpy(tree, device=device, dtype=dtype)
