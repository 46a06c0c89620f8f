"""Model registry: name -> (config, init, apply) bundle.

Counterpart of ``distributed_training_guide_tpu/models/registry.py`` for
the families ported so far (llama and moe).
``get_model(name, **overrides)`` replaces config fields, e.g.
``dtype=torch.bfloat16, param_dtype=torch.bfloat16``; ``hf:<dir>`` names
a model by its HF ``config.json`` (``models/auto.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from . import llama, moe

PORTED_FAMILIES = ("llama", "moe")
_FAMILIES = {"llama": llama, "moe": moe}


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

    def num_params(self) -> int:
        return self.config.num_params()

    def num_active_params(self) -> int:
        """Per-token active params (MoE: k of E experts) for FLOPs/MFU."""
        fn = getattr(self.config, "num_active_params", None)
        return fn() if fn else self.config.num_params()


def family_module(family: str):
    """The module implementing a model family."""
    if family in _FAMILIES:
        return _FAMILIES[family]
    raise NotImplementedError(
        f"model family {family!r} is not ported yet (ported: "
        f"{PORTED_FAMILIES}): ROADMAP.md queue 1, 'Other dense families'")


def list_models() -> list:
    return sorted(llama.PRESETS) + sorted(moe.PRESETS)


def get_model(name: str, **overrides) -> ModelBundle:
    """The preset ``name`` with ``overrides`` replacing config fields; a
    field the family's config lacks raises ``TypeError``."""
    key = name.lower()
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
    raise NotImplementedError(
        f"model {name!r} is not a ported preset ({', '.join(list_models())}); "
        f"gpt2 and neox families are ROADMAP.md queue 1 items")
