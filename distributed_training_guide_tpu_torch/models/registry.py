"""Model registry: name -> (config, init, apply) bundle.

Counterpart of ``distributed_training_guide_tpu/models/registry.py`` for
the families this slice ports (the llama family).
``get_model(name, **overrides)`` replaces config fields, e.g.
``dtype=torch.bfloat16, param_dtype=torch.bfloat16``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from . import llama

PORTED_FAMILIES = ("llama",)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    config: Any
    init: Callable          # (config, rng, *, device=None) -> params
    apply: Callable         # (config, params, input_ids, ...) -> logits
    family: str

    def num_params(self) -> int:
        return self.config.num_params()

    def num_active_params(self) -> int:
        """Per-token active params (MoE: k of E experts) for FLOPs/MFU."""
        fn = getattr(self.config, "num_active_params", None)
        return fn() if fn else self.config.num_params()


def family_module(family: str):
    """The module implementing a model family."""
    if family == "llama":
        return llama
    raise NotImplementedError(
        f"model family {family!r} is not ported yet (this slice ports "
        f"{PORTED_FAMILIES}): ROADMAP.md queue 1, 'Other dense families' "
        f"and 'MoE'")


def list_models() -> list:
    return sorted(llama.PRESETS)


def get_model(name: str, **overrides) -> ModelBundle:
    key = name.lower()
    if key in llama.PRESETS:
        config = llama.PRESETS[key]
        if overrides:
            config = dataclasses.replace(config, **overrides)
        return ModelBundle(key, config, llama.init, llama.apply,
                           family="llama")
    if name.startswith("hf:"):
        raise NotImplementedError(
            "hf: configs (models/auto.py) are not ported yet: ROADMAP.md "
            "queue 1, 'Chapter 05 recipe and conversion'")
    raise NotImplementedError(
        f"model {name!r} is not a ported preset ({', '.join(list_models())}); "
        f"gpt2, neox and MoE families are ROADMAP.md queue 1 items")
