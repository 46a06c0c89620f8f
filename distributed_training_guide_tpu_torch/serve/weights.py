"""Serve-weight storage precision (``weight_dtype=`` on the engine).

Counterpart of ``distributed_training_guide_tpu/serve/weights.py``: which
leaves quantize, at what block size, and what the bytes cost per dtype.
The mechanism (block dequant inside the product) is
``ops/quantized_matmul.py``.

Under "int8" the llama family's projection leaves (the embedding,
``lm_head``, ``wq/wk/wv/wo`` and ``gate/up/down``) become
``train/precision.py`` ``Quantized`` containers: an int8 payload of the
leaf's shape and one fp32 absmax scale per block of 32 along the trailing
axis (clamped so every leaf has at least two blocks). Norms and biases
keep the param dtype. Other families refuse rather than serve a
half-quantized model. "fp32" / "bf16" cast every float leaf.

Byte tables take a shapes tree of ``torch.empty(shape, dtype=...,
device="meta")`` leaves, so a model prices without being allocated.
"""
from __future__ import annotations

import re
from typing import Optional

import torch

from ..train.precision import Quantized, cast_floats, quantize_blockwise

__all__ = ["WEIGHT_DTYPES", "WEIGHT_BLOCK", "weight_dtype_name",
           "weight_block_size", "is_quantizable_path", "store_weights",
           "params_nbytes", "weight_tree_bytes", "weight_bytes_by_dtype"]

WEIGHT_DTYPES = ("fp32", "bf16", "int8")

# trailing-axis block size
WEIGHT_BLOCK = 32

# llama-family projection leaves that quantize ("/"-joined dict keys, the
# stacked "layers" level included)
_QUANTIZABLE = re.compile(
    r"^(embed/embedding|lm_head"
    r"|layers/attn/(wq|wk|wv|wo)"
    r"|layers/mlp/(gate|up|down))$")


def weight_dtype_name(config, weight_dtype=None) -> str:
    """The engine's ``weight_dtype=`` knob as a name: None inherits the
    model's param storage dtype (and means no transform at all),
    otherwise one of ``WEIGHT_DTYPES``."""
    if weight_dtype is None:
        pdt = getattr(config, "param_dtype", config.dtype)
        return "bf16" if pdt == torch.bfloat16 else "fp32"
    name = str(weight_dtype).lower()
    name = {"float32": "fp32", "bfloat16": "bf16"}.get(name, name)
    if name not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be one of {WEIGHT_DTYPES}, "
                         f"got {weight_dtype!r}")
    return name


def weight_block_size(d: int) -> int:
    """Block size for a leaf with trailing dim ``d``: WEIGHT_BLOCK, clamped
    so the leaf always splits into >= 2 blocks."""
    if d >= 2 * WEIGHT_BLOCK:
        return WEIGHT_BLOCK
    return max(1, d // 2)


def is_quantizable_path(path) -> bool:
    """True for the llama-family projection leaves that go int8
    (``path``: an "a/b/c" string or a tuple of dict keys)."""
    s = path if isinstance(path, str) else "/".join(map(str, path))
    return bool(_QUANTIZABLE.match(s))


def require_llama(family: Optional[str]) -> None:
    if family != "llama":
        raise ValueError(
            f"weight_dtype='int8' leaf selection is defined for the llama "
            f"family only (got family={family!r}); extend "
            f"serve/weights.py _QUANTIZABLE before serving other families "
            f"quantized — silently skipping unknown leaves would serve a "
            f"half-quantized model")


def _leaves(tree, prefix=()):
    """(path tuple, leaf) pairs of a nested dict, in insertion order;
    a ``Quantized`` container yields its two tensors."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, Quantized):
        yield prefix + ("q",), tree.q
        yield prefix + ("scale",), tree.scale
    else:
        yield prefix, tree


def _quantize(leaf: torch.Tensor) -> Quantized:
    """Block-quantize a leaf; a stacked [L, ..] leaf one layer at a time
    (the same bits, since every block lies in one row of one layer, with
    one layer's fp32 transient instead of the whole leaf's)."""
    bs = weight_block_size(leaf.shape[-1])
    if leaf.ndim < 3:
        return quantize_blockwise(leaf, block_size=bs)
    out = None
    for i in range(leaf.shape[0]):
        part = quantize_blockwise(leaf[i], block_size=bs)
        if out is None:
            out = Quantized(
                q=torch.empty(leaf.shape, dtype=torch.int8,
                              device=leaf.device),
                scale=torch.empty((leaf.shape[0],) + part.scale.shape,
                                  dtype=torch.float32, device=leaf.device))
        out.q[i] = part.q
        out.scale[i] = part.scale
    return out


def store_weights(params, weight_dtype: str, *, family: Optional[str]):
    """fp-layout params -> storage-layout params for a ``weight_dtype``
    name: fp32 / bf16 cast every float leaf; int8 quantizes the selected
    projection leaves and keeps vectors (norms, biases) in their dtype."""
    if weight_dtype != "int8":
        return cast_floats(
            params, torch.float32 if weight_dtype == "fp32"
            else torch.bfloat16)
    require_llama(family)

    def one(tree, prefix):
        if isinstance(tree, dict):
            return {k: one(v, prefix + (k,)) for k, v in tree.items()}
        return _quantize(tree) if is_quantizable_path(prefix) else tree

    return one(params, ())


def params_nbytes(params) -> int:
    """Storage bytes of a (possibly quantized) param tree: int8 payloads
    and fp32 scales each at their own width."""
    return sum(x.element_size() * x.numel() for _, x in _leaves(params))


def _leaf_bytes(shape, dtype, name: str, quantizable: bool) -> int:
    n = 1
    for d in shape:
        n *= d
    if not dtype.is_floating_point:
        return n * dtype.itemsize                 # int leaves ride along
    if name == "int8" and quantizable:
        d = shape[-1] if shape else 1
        bs = weight_block_size(d)
        nblocks = -(-d // max(bs, 1))
        lead = n // max(d, 1)
        return n + lead * nblocks * 4             # int8 payload + fp32 scales
    if name in ("fp32", "bf16"):
        return n * (4 if name == "fp32" else 2)
    return n * dtype.itemsize                     # int8, non-quantized leaf


def weight_tree_bytes(shapes_tree, weight_dtype: str,
                      family: Optional[str]) -> int:
    """Storage bytes of an fp-layout shapes tree stored at
    ``weight_dtype``, computed from shapes alone."""
    name = weight_dtype_name(None, weight_dtype)  # explicit name required
    if name == "int8":
        require_llama(family)
    return sum(_leaf_bytes(tuple(leaf.shape), leaf.dtype, name,
                           name == "int8" and is_quantizable_path(path))
               for path, leaf in _leaves(shapes_tree))


def weight_bytes_by_dtype(shapes_tree, family: Optional[str]) -> dict:
    """{dtype name: storage bytes} for every supported weight_dtype; the
    int8 row only where the family has a leaf-selection rule."""
    out = {}
    for name in WEIGHT_DTYPES:
        if name == "int8" and family != "llama":
            continue
        out[name] = weight_tree_bytes(shapes_tree, name, family)
    return out
