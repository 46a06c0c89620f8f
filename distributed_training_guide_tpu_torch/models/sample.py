"""Text sampling from any model of the zoo: a qualitative check for
trained or converted checkpoints.

Counterpart of ``distributed_training_guide_tpu/models/sample.py``. The
default mode re-runs the whole forward over a fixed buffer for every
token (any family); ``--kv-cache`` goes through the serving engine
(``serve/engine.py``) at ``n_slots=1``: one bucketed prefill, then one
single-token paged step per token (K4 on the card). Greedy decoding gives
the same tokens in both modes, and JAX's (tested per family). At a
temperature > 0 both modes draw from the engine's counter-based stream of
(seed, position), so they agree with each other; the bits differ from
jax's ``fold_in`` keys, the contract the engine keeps::

    python -m distributed_training_guide_tpu_torch.models.sample \\
        -m gpt2-debug --prompt-ids 3,17,42 --steps 16 --device cpu
    python -m distributed_training_guide_tpu_torch.models.sample \\
        -m gpt2 --prompt-ids 3,17,42 --steps 32 --kv-cache
"""
from __future__ import annotations

from typing import Optional

import torch

PAGE = 16     # the kv_cache mode's page size


def make_sampler(bundle, temperature: float = 0.0, kv_cache: bool = False,
                 *, device=None):
    """``sample(params, prompt_ids, steps, rng=None) -> token ids`` (the
    prompt and the generated tokens). ``rng`` is an int seed (default 0).
    Recompute mode runs ``bundle.apply`` over the whole buffer per token;
    ``kv_cache=True`` serves the request through a one-slot
    ``ServeEngine`` on ``device`` (default cuda), one per page-rounded
    capacity. A generation past the position table is refused."""
    from ..serve.engine import _sample_tokens
    from ..train.state import named_leaves

    max_pos = getattr(bundle.config, "max_position_embeddings", None)

    def check_length(n_prompt: int, steps: int) -> None:
        if max_pos and n_prompt + steps > max_pos:
            raise ValueError(
                f"prompt ({n_prompt}) + steps ({steps}) exceeds the model's "
                f"max_position_embeddings ({max_pos})")

    if kv_cache:
        from .registry import family_module

        if not hasattr(family_module(bundle.family), "decode_step"):
            raise ValueError(f"family {bundle.family!r} has no KV-cached "
                             f"decode; use kv_cache=False")
        engines: dict = {}

        def sample(params, prompt_ids, steps: int,
                   rng: Optional[int] = None) -> list:
            from ..serve.api import generate_many
            from ..serve.engine import ServeEngine
            from ..serve.scheduler import Request

            n = len(prompt_ids)
            check_length(n, steps)
            capacity = -(-(n + steps) // PAGE) * PAGE
            # the engine holds its params, so the id key stays pinned
            eng = engines.get((id(params), capacity))
            if eng is None:
                eng = ServeEngine(bundle, params, n_slots=1, page_size=PAGE,
                                  max_len=capacity, device=device)
                engines[(id(params), capacity)] = eng
            res = generate_many(eng, [Request(
                prompt_ids=[int(t) for t in prompt_ids],
                max_new_tokens=steps, temperature=temperature,
                seed=int(rng or 0))])
            return res[0].token_ids

        return sample

    def pick(logit: torch.Tensor, seed: int, position: int) -> int:
        def one(x, dtype):
            return torch.tensor([x], dtype=dtype, device=logit.device)

        return int(_sample_tokens(
            logit.float()[None], one(seed, torch.int32),
            one(position, torch.int32), one(temperature, torch.float32),
            one(0, torch.int32), one(1.0, torch.float32),
            stochastic=temperature > 0)[0])

    @torch.no_grad()
    def sample(params, prompt_ids, steps: int,
               rng: Optional[int] = None) -> list:
        n = len(prompt_ids)
        check_length(n, steps)
        dev = named_leaves(params)[0][1].device
        buf = torch.zeros((1, n + steps), dtype=torch.long, device=dev)
        buf[0, :n] = torch.tensor([int(t) for t in prompt_ids], device=dev)
        for t in range(n, n + steps):
            logits = bundle.apply(bundle.config, params, buf)
            buf[0, t] = pick(logits[0, t - 1], int(rng or 0), t)
        return [int(x) for x in buf[0].tolist()]

    return sample


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        prog="python -m distributed_training_guide_tpu_torch.models.sample")
    parser.add_argument("-m", "--model-name", required=True)
    parser.add_argument("--prompt", default=None,
                        help="text prompt (needs the model's HF tokenizer "
                             "in the local cache)")
    parser.add_argument("--prompt-ids", default=None,
                        help="comma-separated token ids, the hermetic path")
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--kv-cache", action="store_true",
                        help="prefill + cached one-token decode steps "
                             "through the serving engine instead of full "
                             "recompute")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pretrained", default=None, metavar="DIR",
                        help="converted checkpoint dir (models/hf_convert); "
                             "random init otherwise")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where sampling runs (default cuda)")
    args = parser.parse_args(argv)
    if (args.prompt is None) == (args.prompt_ids is None):
        raise SystemExit("pass exactly one of --prompt / --prompt-ids")

    from .registry import get_model

    bundle = get_model(args.model_name, dtype=torch.float32)
    tokenizer = None
    if args.prompt is not None:
        from ..data import get_tokenizer

        tokenizer = get_tokenizer(args.model_name)
        prompt_ids = tokenizer(args.prompt)["input_ids"]
        if prompt_ids and isinstance(prompt_ids[0], list):
            prompt_ids = prompt_ids[0]  # batched tokenizers (ByteTokenizer)
    else:
        prompt_ids = [int(t) for t in args.prompt_ids.split(",")]
    if args.pretrained:
        from .hf_convert import load_pretrained

        params = load_pretrained(bundle, None, args.pretrained,
                                 device=args.device)
    else:
        params = bundle.init(bundle.config, args.seed, device=args.device)
    sample = make_sampler(bundle, temperature=args.temperature,
                          kv_cache=args.kv_cache, device=args.device)
    out = sample(params, prompt_ids, args.steps, rng=args.seed)
    if tokenizer is not None:
        print(tokenizer.decode(out))
    else:
        print(",".join(str(t) for t in out))


if __name__ == "__main__":
    main()
