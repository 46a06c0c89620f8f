"""LoRA adapters for the llama family: parameter-efficient fine-tuning.

Counterpart of ``distributed_training_guide_tpu/models/lora.py``. The
base checkpoint is frozen and low-rank deltas ``W_eff = W + (alpha/r) *
A @ B`` train on chosen projections:

- each adapter is one pair of tensors stacked like its base leaf,
  ``A [L, in, r]`` / ``B [L, r, out]``, under ``params["lora"]``; the base
  params sit under ``params["base"]``;
- the merge happens at apply time (``W + scale * A @ B`` per step, a
  plain matmul: the JAX package's is an einsum outside any Pallas kernel);
  ``merge_lora`` folds the deltas into base-layout params for export;
- the adapters' logical axes derive from their base leaf's (A keeps the
  IN axis, B the OUT axis, the rank dim is never sharded), so every plan
  places them with their matrix: the merge runs on each rank's shards
  (``A_local @ B_local`` is the local block of ``A @ B``), and
  ``lora_partners`` names each adapter's base leaf so a plan sums over
  tp the grads a rank holds partially (``parallel/plans.py``);
- B starts at zero, so the wrapped model's first forward is exactly the
  base model's.

Freezing is ``Trainer(lora_only=True)`` (the CLI's ``--lora-rank``): the
optimizer holds only the adapter leaves, and the base leaves take no
gradient at all. That is JAX's ``mask_optimizer`` (base updates zeroed, no
moments for the base) without computing the base's grads, so the logged
``grad_norm`` is the adapters' norm, where the JAX step logs the norm over
the base's grads too.

Usage (any chapter CLI): ``--lora-rank 8 [--lora-alpha 16]
[--lora-targets wq,wv]``; it composes with ``--pretrained`` and with
every plan.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .registry import ModelBundle, family_module

# target short-name -> key path into the llama-family params tree. All are
# stacked [L, in, out] matmuls (biases and norms are not LoRA targets)
TARGET_PATHS = {
    "wq": ("layers", "attn", "wq"),
    "wk": ("layers", "attn", "wk"),
    "wv": ("layers", "attn", "wv"),
    "wo": ("layers", "attn", "wo"),
    "gate": ("layers", "mlp", "gate"),
    "up": ("layers", "mlp", "up"),
    "down": ("layers", "mlp", "down"),
}

DEFAULT_TARGETS = ("wq", "wv")   # the classic LoRA-paper pair
ADAPTER_SEED = 0x10FA            # the adapters' seed offset (JAX's fold_in)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree, path, value):
    """A copy of ``tree`` with ``path`` replaced (the spine copied, the
    other leaves shared)."""
    if not path:
        return value
    out = dict(tree)
    out[path[0]] = _set(tree[path[0]], path[1:], value)
    return out


def lora_bundle(base: ModelBundle, *, rank: int = 8, alpha: float = 16.0,
                targets: Sequence[str] = DEFAULT_TARGETS) -> ModelBundle:
    """Wrap ``base`` so params = {"base": <frozen>, "lora": {t: {"a",
    "b"}}}. Only the llama family, as in the JAX package."""
    if base.family != "llama":
        raise ValueError(
            f"LoRA targets are defined for the llama family only (got "
            f"{base.family!r}); gpt2/neox fuse QKV and moe stacks experts — "
            f"extend TARGET_PATHS if you need them")
    if rank < 1:
        raise ValueError(f"lora rank must be >= 1, got {rank}")
    unknown = [t for t in targets if t not in TARGET_PATHS]
    if unknown:
        raise ValueError(f"unknown lora targets {unknown}; "
                         f"choose from {sorted(TARGET_PATHS)}")
    targets = tuple(targets)
    scale = alpha / rank
    mod = family_module(base.family)

    def adapter_shapes(cfg) -> dict:
        shapes = mod.param_shapes(cfg)
        out = {}
        for t in targets:
            l, fan_in, fan_out = _get(shapes, TARGET_PATHS[t])
            out[t] = {"a": (l, fan_in, rank), "b": (l, rank, fan_out)}
        return out

    def init_adapters(cfg, rng, *, device=None) -> dict:
        """Adapter leaves only (shapes from the base's meta init: a
        pretrained load never materializes a random base). A ~ N(0, 0.02),
        B = 0."""
        from .llama import init_target

        gen, dev = init_target(rng, device)
        pdt = cfg.param_dtype
        out = {}
        for t, shp in adapter_shapes(cfg).items():
            a = torch.randn(shp["a"], generator=gen, device=dev,
                            dtype=torch.float32)
            out[t] = {"a": a.mul_(0.02).to(pdt),
                      "b": torch.zeros(shp["b"], device=dev, dtype=pdt)}
        return out

    def init(cfg, rng, *, device=None) -> dict:
        adapter_rng = (rng if isinstance(rng, torch.Generator)
                       else int(rng) + ADAPTER_SEED)
        return {"base": base.init(cfg, rng, device=device),
                "lora": init_adapters(cfg, adapter_rng, device=device)}

    def merge(cfg, params) -> dict:
        merged = params["base"]
        for t in targets:
            pair = params["lora"][t]
            w = _get(merged, TARGET_PATHS[t])
            delta = torch.matmul(pair["a"].to(w.dtype), pair["b"].to(w.dtype))
            merged = _set(merged, TARGET_PATHS[t],
                          w + torch.tensor(scale, dtype=w.dtype,
                                           device=w.device) * delta)
        return merged

    def apply(cfg, params, *args, activation_sharding=None, **kwargs):
        if activation_sharding is not None:       # the base's own specs
            activation_sharding = activation_sharding.scoped("base")
        return base.apply(cfg, merge(cfg, params), *args,
                          activation_sharding=activation_sharding, **kwargs)

    def param_logical_axes(cfg) -> dict:
        base_axes = mod.param_logical_axes(cfg)
        lora_axes = {}
        for t in targets:
            layers_ax, in_ax, out_ax = _get(base_axes, TARGET_PATHS[t])
            lora_axes[t] = {"a": (layers_ax, in_ax, None),
                            "b": (layers_ax, None, out_ax)}
        return {"base": base_axes, "lora": lora_axes}

    def param_shapes(cfg) -> dict:
        return {"base": mod.param_shapes(cfg), "lora": adapter_shapes(cfg)}

    bundle = ModelBundle(
        name=f"{base.name}+lora(r={rank},alpha={alpha:g},{','.join(targets)})",
        config=base.config, init=init, apply=apply, family=base.family,
        param_logical_axes=param_logical_axes, param_shapes=param_shapes)
    # tooling (merge_lora, the CLI loader, the Trainer and the plans)
    for key, value in (("lora_base", base), ("lora_merge", merge),
                       ("lora_init_adapters", init_adapters),
                       ("lora_targets", targets)):
        object.__setattr__(bundle, key, value)
    return bundle


def is_lora(bundle) -> bool:
    return getattr(bundle, "lora_base", None) is not None


def lora_partners(bundle) -> dict:
    """{adapter leaf path: the base leaf path it adapts} ("/"-joined)."""
    return {f"lora/{t}/{x}": "base/" + "/".join(TARGET_PATHS[t])
            for t in bundle.lora_targets for x in ("a", "b")}


def load_pretrained_lora(bundle: ModelBundle, plan, out_dir, seed: int = 0,
                         *, param_dtype=None, device=None) -> dict:
    """Pretrained BASE weights (a converted checkpoint, this rank's slices
    under ``plan``) plus fresh adapters (this rank's shards of them): the
    finetune-a-checkpoint entry."""
    from ..train.state import named_leaves
    from .hf_convert import load_pretrained

    if not is_lora(bundle):
        raise ValueError("load_pretrained_lora needs a lora_bundle")
    base_params = load_pretrained(bundle.lora_base, plan, out_dir,
                                  param_dtype=param_dtype, device=device)
    adapters = bundle.lora_init_adapters(bundle.config, seed + ADAPTER_SEED,
                                         device=device)
    if plan is not None:
        specs = dict(named_leaves(plan.param_specs(
            bundle.logical_axes(), bundle.shapes())["lora"]))
        adapters = {t: {x: plan.shard(specs[f"{t}/{x}"], v).clone()
                        for x, v in pair.items()}
                    for t, pair in adapters.items()}
    return {"base": base_params, "lora": adapters}


def num_trainable_params(bundle: ModelBundle) -> int:
    """Adapter parameters (from shapes alone)."""
    import math

    shapes = bundle.param_shapes(bundle.config)["lora"]
    return sum(math.prod(s) for pair in shapes.values() for s in pair.values())


def jit_merge(bundle: ModelBundle):
    """ONE merge function ``{"base", "lora"} -> base-layout params``, built
    once and reused at every publish (``post/loop.py``), where the JAX
    package compiles one program. The output matches the base bundle's
    layout leaf for leaf (each target ``W + scale * A @ B`` in ``W``'s
    dtype, the other leaves the base's own), which is what
    ``ModelPrograms.publish_params`` validates and copies."""
    merge = getattr(bundle, "lora_merge", None)
    if merge is None:
        raise ValueError("jit_merge needs a bundle built by lora_bundle")
    cfg = bundle.config

    @torch.no_grad()
    def merged(params: dict) -> dict:
        return merge(cfg, params)

    return merged


def merge_lora(bundle: ModelBundle, params: dict) -> dict:
    """Fold the trained deltas into base-layout params (for ``hf_export``,
    sampling through the base bundle, or a plain checkpoint)."""
    if not is_lora(bundle):
        raise ValueError("merge_lora needs a bundle built by lora_bundle")
    with torch.no_grad():
        return bundle.lora_merge(bundle.config, params)

