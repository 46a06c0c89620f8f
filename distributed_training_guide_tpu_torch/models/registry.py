"""Model registry: name -> (config, init, apply) bundle.

Counterpart of ``distributed_training_guide_tpu/models/registry.py``: the
four families (gpt2, llama, moe, neox), their presets and the JAX
package's HF hub aliases (``openai-community/gpt2``,
``EleutherAI/pythia-1.4b``, ...). ``get_model(name, **overrides)``
replaces config fields, e.g. ``dtype=torch.bfloat16,
param_dtype=torch.bfloat16``; ``hf:<dir>`` names a model by its HF
``config.json`` (``models/auto.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from . import gpt2, llama, moe, neox

PORTED_FAMILIES = ("gpt2", "llama", "moe", "neox")
_FAMILIES = {"gpt2": gpt2, "llama": llama, "moe": moe, "neox": neox}

# HF hub names that resolve to a preset (the JAX package's table)
_HF_ALIASES = {
    "openai-community/gpt2": "gpt2",
    "tinyllama/tinyllama-1.1b-chat-v1.0": "tinyllama-1.1b",
    "tinyllama/tinyllama_v1.1": "tinyllama-1.1b",
    "meta-llama/llama-3.2-1b": "llama-3.2-1b",
    "meta-llama/llama-3.2-3b": "llama-3.2-3b",
    "meta-llama/llama-3.1-8b": "llama-3.1-8b",
    "meta-llama/meta-llama-3.1-8b": "llama-3.1-8b",
    "meta-llama/llama-3.1-70b": "llama-3.1-70b",
    "meta-llama/llama-3.1-405b": "llama-3.1-405b",
    "meta-llama/meta-llama-3.1-405b": "llama-3.1-405b",
    "eleutherai/pythia-70m": "pythia-70m",
    "eleutherai/pythia-160m": "pythia-160m",
    "eleutherai/pythia-410m": "pythia-410m",
    "eleutherai/pythia-1.4b": "pythia-1.4b",
    "eleutherai/pythia-6.9b": "pythia-6.9b",
    "eleutherai/gpt-neox-20b": "gpt-neox-20b",
}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    config: Any
    init: Callable          # (config, rng, *, device=None) -> params
    apply: Callable         # (config, params, input_ids, ...) -> logits
    family: str
    # MoE models: (config, params, ids, ...) -> (logits, aux_loss); the
    # trainer adds config.router_aux_coef * aux to the loss
    apply_with_aux: Optional[Callable] = None
    # (config,) -> axes / shapes trees; None: the family module's (a LoRA
    # bundle, models/lora.py, wraps the base's trees in its own)
    param_logical_axes: Optional[Callable] = None
    param_shapes: Optional[Callable] = None

    def logical_axes(self) -> dict:
        fn = self.param_logical_axes or family_module(
            self.family).param_logical_axes
        return fn(self.config)

    def shapes(self) -> dict:
        fn = self.param_shapes or family_module(self.family).param_shapes
        return fn(self.config)

    def num_params(self) -> int:
        return self.config.num_params()

    def num_active_params(self) -> int:
        """Per-token active params (MoE: k of E experts) for FLOPs/MFU."""
        fn = getattr(self.config, "num_active_params", None)
        return fn() if fn else self.config.num_params()


def family_module(family: str):
    """The module implementing a model family."""
    if family not in _FAMILIES:
        raise KeyError(f"unknown model family {family!r}")
    return _FAMILIES[family]


def list_models() -> list:
    return (sorted(gpt2.PRESETS) + sorted(llama.PRESETS)
            + sorted(moe.PRESETS) + sorted(neox.PRESETS))


def get_model(name: str, **overrides) -> ModelBundle:
    """The preset ``name`` with ``overrides`` replacing config fields; a
    field the family's config lacks raises ``TypeError``."""
    key = _HF_ALIASES.get(name.lower(), name.lower())
    for family, mod in _FAMILIES.items():
        if key in mod.PRESETS:
            config = mod.PRESETS[key]
            if overrides:
                config = dataclasses.replace(config, **overrides)
            return ModelBundle(
                key, config, mod.init, mod.apply, family=family,
                apply_with_aux=getattr(mod, "apply_with_aux", None))
    if name.startswith("hf:"):
        # the checkpoint's own config.json (models/auto.py)
        from .auto import config_from_hf

        family, config = config_from_hf(name[3:])
        if overrides:
            config = dataclasses.replace(config, **overrides)
        mod = family_module(family)
        return ModelBundle(name, config, mod.init, mod.apply, family=family,
                           apply_with_aux=getattr(mod, "apply_with_aux",
                                                  None))
    raise ValueError(
        f"Unknown model {name!r}. Available: {', '.join(list_models())} "
        f"(HF aliases: {', '.join(sorted(_HF_ALIASES))})")
