"""Chapter 2 — data parallelism (+ ZeRO-1 / ZeRO-2).

Counterpart of ``02-distributed-data-parallel/train_llm.py``: params
replicated, each rank reads its rows of the global batch, grads summed over
the data ranks. ``--zero1`` shards the optimizer state over the data ranks
(each rank steps its slice, then the params are all-gathered); ``--zero2``
also reduce-scatters the grad-accumulation buffer (``--grad-accum`` > 1).

    python -m distributed_training_guide_tpu_torch.launch.local --nproc 4 \\
        -- python -m distributed_training_guide_tpu_torch.chapters.c02_ddp \\
        -m llama-debug -d synthetic:20000 -s 64 -b 2 --max-steps 6 \\
        --device cpu
"""
from __future__ import annotations

from ..launch.errors import record
from ..parallel import make_mesh, make_plan
from ..train.cli import get_parser
from . import run_chapter


@record
def main(argv=None) -> dict:
    parser = get_parser()
    parser.prog = "python -m distributed_training_guide_tpu_torch.chapters.c02_ddp"
    parser.add_argument("--zero2", action="store_true",
                        help="ZeRO-2: optimizer state AND the grad-"
                             "accumulation buffer sharded over data ranks "
                             "(params replicated); without --grad-accum > 1 "
                             "it is ZeRO-1")
    parser.add_argument("--zero1", action="store_true",
                        help="shard optimizer state across data-parallel "
                             "ranks")
    args = parser.parse_args(argv)
    strategy = "zero2" if args.zero2 else ("zero1" if args.zero1 else "ddp")
    return run_chapter(args, lambda n, device: make_plan(
        strategy, make_mesh(device=device)))


if __name__ == "__main__":
    main()
