"""Chapter 8 — context parallelism for long sequences.

Counterpart of ``08-context-parallel/train_llm.py``: the sequence
dimension itself is sharded over the ``cp`` mesh axis. Embedding, norms,
MLP and loss are position-local and run on each rank's shard (RoPE at the
shard's global positions, the targets shifted before the sequence was
sharded); attention is the zigzag ring (``ops/ring_attention.py``: K / V
blocks rotate to the next rank while each attends its resident queries,
merged by the online softmax) or, with ``--context-impl ulysses``, the
all-to-all layout flip (``ops/ulysses_attention.py``). Composes with fsdp
(``--fsdp``). Max context scales with cp: each rank holds the activations
of S / cp tokens.

    python -m distributed_training_guide_tpu_torch.launch.local --nproc 4 \\
        -- python -m distributed_training_guide_tpu_torch.chapters.\\
c08_context_parallel -m llama-debug -d synthetic:20000 -s 256 -b 2 \\
        --context-parallel 4 --max-steps 4 --log-freq 2 --device cpu
"""
from __future__ import annotations

from ..launch.errors import record
from ..parallel import make_mesh, make_plan
from ..train.cli import get_parser
from . import run_chapter


@record
def main(argv=None) -> dict:
    parser = get_parser()
    parser.prog = ("python -m distributed_training_guide_tpu_torch.chapters."
                   "c08_context_parallel")
    parser.add_argument("--context-parallel", type=int, default=None,
                        help="cp size (default: all ranks over --fsdp)")
    parser.add_argument("--fsdp", type=int, default=1,
                        help="fsdp size alongside cp")
    args = parser.parse_args(argv)

    def plan_for(n, device):
        cp = args.context_parallel or n // args.fsdp
        strategy = "fsdp" if args.fsdp > 1 else "ddp"
        return make_plan(strategy, make_mesh(cp=cp, fsdp=args.fsdp,
                                             device=device))

    return run_chapter(args, plan_for)


if __name__ == "__main__":
    main()
