"""Chapter 5 — training Llama-3.1-405B.

Counterpart of ``05-training-llama-405b/train_llm.py``. The reference's
recipe on 64 H100s needs a rank-0 CPU load and broadcast of the weights, CPU
optimizer offload, activation checkpointing and a hand-done memory walk;
here each is a flag of the same chapter:

- the weights: convert once (``c05_convert_llama``), then every rank reads
  only its own shards of the converted memmaps (``--pretrained DIR``,
  ``models/hf_convert.py:load_pretrained``): no rank-0 load, no broadcast;
- ``--offload-opt-state`` / ``--offload-params``: the optimizer state /
  params in pinned host memory between steps (``train/offload.py``);
- activation checkpointing is on by default
  (``--no-checkpoint-activations`` turns it off);
- the memory walk: ``--preflight`` prints the per-GPU budget and the comm
  roofline without allocating anything, for ``--preflight-world`` ranks.

The plan is ``tp_fsdp`` with ``--tensor-parallel`` > 1 (the reference's
fsdp 8 x tp 8 on 64 GPUs), else ``fsdp``.

    # the reference's 64-GPU shape, priced from one CPU host
    python -m distributed_training_guide_tpu_torch.chapters.c05_llama405b \\
        -m llama-3.1-405b -s 4096 -b 1 --tensor-parallel 8 \\
        --preflight --preflight-world 64
    # converted weights, optimizer state offloaded, on one card
    torchrun --standalone --nproc-per-node 1 -m \\
        distributed_training_guide_tpu_torch.chapters.c05_llama405b \\
        -m llama-3.2-1b --pretrained <converted-dir> -d synthetic:400000 \\
        -s 2048 -b 4 --offload-opt-state --max-steps 8

``main(argv, model_overrides=...)`` cuts a preset's depth (``chip_smoke.py``
trains one full-width layer of llama-3.1-405b on one card that way).
"""
from __future__ import annotations

from ..launch.errors import record
from ..parallel import make_mesh, make_plan
from ..train.cli import get_parser
from . import run_chapter


def make_parser():
    parser = get_parser()
    parser.prog = ("python -m "
                   "distributed_training_guide_tpu_torch.chapters.c05_llama405b")
    parser.add_argument("--tensor-parallel", type=int, default=1)
    parser.add_argument("--offload-params", action="store_true",
                        help="params live in pinned host memory between "
                             "steps (fetched for each step); with "
                             "--offload-opt-state the reference's full "
                             "CPUOffloadPolicy")
    parser.add_argument("--offload-opt-state", action="store_true",
                        help="optimizer state in pinned host memory "
                             "between steps (reference 05:69-72)")
    parser.add_argument("--no-checkpoint-activations",
                        dest="checkpoint_activations", action="store_false")
    parser.set_defaults(checkpoint_activations=True)
    return parser


def plan_for(tp: int):
    """The chapter's plan maker: tp_fsdp for tp > 1, else fsdp."""
    def make(n: int, device):
        strategy = "tp_fsdp" if tp > 1 else "fsdp"
        return make_plan(strategy, make_mesh(tp=tp, fsdp=n // tp,
                                             device=device))
    return make


@record
def main(argv=None, **train_kw) -> dict:
    """``train_kw`` passes through to ``run_training`` (e.g.
    ``model_overrides``)."""
    args = make_parser().parse_args(argv)
    return run_chapter(args, plan_for(args.tensor_parallel),
                       offload_opt_state=args.offload_opt_state,
                       offload_params=args.offload_params, **train_kw)


if __name__ == "__main__":
    main()
