"""CLI for the on-policy post-training loop.

Counterpart of ``distributed_training_guide_tpu/post/cli.py``, with its
flags and ``--device`` / ``--dtype``. Runs rollout -> score -> update ->
publish end to end on one device: the policy trains through the Trainer
(LoRA adapters by default: the update is adapter-sized) while a
co-resident ServeEngine generates the rollouts and receives the refreshed
weights after every update.

Examples::

    # REINFORCE on the synthetic match-token preference task (the CPU)
    python -m distributed_training_guide_tpu_torch.post \\
        --model llama-debug --lora-rank 8 --reward match:7 \\
        --iterations 5 --rollout-batch 8 --max-new-tokens 16 --lr 0.05 \\
        --device cpu

    # on-policy distillation against a teacher of another seed, on the card
    python -m distributed_training_guide_tpu_torch.post \\
        --model llama-3.2-1b --dtype bfloat16 --objective distill_kl \\
        --teacher-model llama-3.2-1b --teacher-seed 1 --iterations 3

Each iteration prints one JSON line (reward, loss, rollout tok/s, publish
latency: the JAX CLI's keys). ``--ledger`` makes rollout batches
crash-recoverable; rerunning the same command resumes from it.
``--memory-budget-gb`` prices the co-resident policy, teacher and pool on
the meta device (``train/preflight.py:price_post_colocation``) and
refuses an impossible colocation before anything is allocated.
"""
from __future__ import annotations

import argparse
import json
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_training_guide_tpu_torch.post",
        description="on-policy post-training: trainer-driven rollouts "
                    "through the serve engine")
    p.add_argument("--model", default="llama-debug")
    p.add_argument("--lora-rank", type=int, default=8,
                   help="0 trains full parameters; >0 wraps the model in "
                        "LoRA adapters and restricts the optimizer to them")
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--objective", default="reinforce",
                   choices=("reinforce", "distill_kl"))
    p.add_argument("--baseline", default="batch",
                   choices=("batch", "group", "none"),
                   help="'group' is the GRPO group-relative baseline "
                        "(rollouts sharing a prompt form a group)")
    p.add_argument("--reward", default="band:64",
                   help="'band:<n>' (fraction of generated tokens with "
                        "id < n — the dense synthetic task), 'match:<id>' "
                        "(fraction equal to <id> — sparse), or 'model' "
                        "(likelihood under --reward-model)")
    p.add_argument("--reward-model", default=None,
                   help="preset name for --reward model")
    p.add_argument("--teacher-model", default=None,
                   help="preset name scoring distill_kl teacher logits")
    p.add_argument("--teacher-seed", type=int, default=1,
                   help="init seed for the teacher (debug runs; a real "
                        "teacher loads a checkpoint)")
    p.add_argument("--iterations", type=int, default=5)
    p.add_argument("--rollout-batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=3)
    p.add_argument("--group-size", type=int, default=1,
                   help=">1 repeats each prompt group-size times "
                        "(the GRPO grouping)")
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--publish-every", type=int, default=1,
                   help="publish after every N updates (the staleness "
                        "knob); 0 never publishes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ledger", default=None,
                   help="rollout ledger path (crash-recoverable batches)")
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--weight-dtype", default=None,
                   choices=("fp32", "bf16", "int8"),
                   help="serve-engine param storage (serve/weights.py). "
                        "'int8' with --lora-rank > 0 is the QLoRA shape: "
                        "the frozen base is SNAPPED onto the engine's "
                        "int8 grid (post.qlora_base) so the adapters "
                        "train against the policy actually served, and "
                        "every publish moves the quantized payload")
    p.add_argument("--speculate", default="off", choices=("off", "ngram"))
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--guard-policy", default="skip",
                   choices=("off", "skip", "abort"),
                   help="'skip' (default) leaves a non-finite update "
                        "unapplied and gates the publish on the flag")
    p.add_argument("--memory-budget-gb", type=float, default=None,
                   help="refuse before anything is allocated if the "
                        "co-resident policy+teacher+pool exceed this")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu' (the plain PyTorch "
                        "path)")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="compute dtype of the policy, the engine and the "
                        "scoring models (params stay in the preset's "
                        "param dtype)")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = build_parser().parse_args(argv)
    group = max(args.group_size, 1)
    if args.rollout_batch % group:
        raise SystemExit(
            f"--rollout-batch {args.rollout_batch} is not divisible by "
            f"--group-size {group}: the loop would silently run "
            f"{(args.rollout_batch // group) * group} rollouts instead — "
            f"pick a divisible pair")
    if args.baseline == "group" and group < 2:
        raise SystemExit(
            "--baseline group needs --group-size >= 2: singleton groups "
            "make every advantage (r - mean_g)/std_g exactly zero, so "
            "the loop would train nothing while looking busy")
    import torch

    from .._device import resolve_device
    from ..models import get_model
    from ..serve.engine import ServeEngine
    from ..train.optimizer import adamw_cosine
    from ..train.preflight import price_post_colocation
    from ..train.step import Trainer
    from .loop import PostTrainingLoop, merged_params
    from .rollout import RolloutLedger
    from .score import (band_reward, ProgrammaticScorer,
                        RewardModelScorer, TeacherScorer, match_reward)

    dtype = getattr(torch, args.dtype)
    device = resolve_device(args.device)
    base = get_model(args.model, dtype=dtype)
    bundle = base
    if args.lora_rank > 0:
        from ..models.lora import lora_bundle

        bundle = lora_bundle(base, rank=args.lora_rank,
                             alpha=args.lora_alpha)
    teacher = None
    if args.objective == "distill_kl":
        if args.teacher_model is None:
            raise SystemExit("--objective distill_kl needs --teacher-model")
        teacher = get_model(args.teacher_model, dtype=dtype)
    trainer = Trainer(bundle=bundle, optimizer=adamw_cosine(args.lr),
                      lora_only=args.lora_rank > 0,
                      guard_policy=args.guard_policy, device=device)

    max_len = args.prompt_len + args.max_new_tokens + args.page_size
    budget = (int(args.memory_budget_gb * 2**30)
              if args.memory_budget_gb else None)
    colo = price_post_colocation(
        trainer, n_slots=args.n_slots, page_size=args.page_size,
        max_len=max_len, weight_dtype=args.weight_dtype,
        teacher_bundle=teacher, budget_bytes=budget)

    if args.weight_dtype == "int8" and args.lora_rank > 0:
        # the QLoRA shape: the frozen base snapped onto the engine's int8
        # grid before training (idempotent, so the engine's quantization
        # of every merged publish reproduces it)
        from .loop import qlora_base

        init = bundle.init(bundle.config, args.seed, device=device)
        init = {"base": qlora_base(init["base"]), "lora": init["lora"]}
        state = trainer.init_state_from_params(init, seed=args.seed)
    else:
        state = trainer.init_state(args.seed)
    engine = ServeEngine(base, merged_params(trainer, state),
                         n_slots=args.n_slots, page_size=args.page_size,
                         max_len=max_len, weight_dtype=args.weight_dtype,
                         speculate=args.speculate
                         if args.speculate != "off" else None,
                         spec_k=args.spec_k, device=device)

    if args.reward == "model" or args.reward_model:
        rm = get_model(args.reward_model or args.model, dtype=dtype)
        scorer = RewardModelScorer(
            rm, rm.init(rm.config, args.teacher_seed, device=device))
    elif args.objective == "distill_kl":
        scorer = TeacherScorer(
            teacher, teacher.init(teacher.config, args.teacher_seed,
                                  device=device))
    elif args.reward.startswith("match:"):
        scorer = ProgrammaticScorer(
            match_reward(int(args.reward.split(":", 1)[1])))
    elif args.reward.startswith("band:"):
        scorer = ProgrammaticScorer(
            band_reward(int(args.reward.split(":", 1)[1])))
    else:
        raise SystemExit(f"unknown --reward {args.reward!r}")

    n_unique = max(1, args.rollout_batch // group)
    prompts, group_ids = [], []
    for g in range(n_unique):
        prompt = [3 + (g * 7 + j) % (base.config.vocab_size - 3)
                  for j in range(args.prompt_len)]
        for _ in range(group):
            prompts.append(prompt)
            group_ids.append(g)

    loop = PostTrainingLoop(
        trainer, engine, scorer, prompts, state=state,
        objective=args.objective, baseline=args.baseline,
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        base_seed=args.seed, publish_every=args.publish_every,
        ledger=RolloutLedger(args.ledger) if args.ledger else None,
        group_ids=group_ids)
    print(json.dumps({"colocation_total_bytes": colo["total_bytes"],
                      "pad_to": loop.pad_to,
                      "policy": bundle.name}))
    for _ in range(args.iterations):
        print(json.dumps(loop.run_iteration()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
