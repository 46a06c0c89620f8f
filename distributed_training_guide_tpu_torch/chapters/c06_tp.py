"""Chapter 6 — tensor parallelism + sequence parallelism.

Counterpart of ``06-tensor-parallel/train_llm.py``: column-parallel
wq / wk / wv / gate / up and row-parallel wo / down on the tp axis, the
residual stream's sequence sharded on tp between sublayers (an all-gather
before attention and the MLP, a reduce-scatter after), the vocab-parallel
embedding and loss. Attention runs on each rank's own heads. Ranks of one
tp group read the same rows.

    python -m distributed_training_guide_tpu_torch.launch.local --nproc 4 \\
        -- python -m distributed_training_guide_tpu_torch.chapters.c06_tp \\
        -m llama-debug -d synthetic:20000 -s 64 -b 2 --max-steps 6 \\
        --tensor-parallel 4 --device cpu
"""
from __future__ import annotations

from ..launch.errors import record
from ..parallel import make_mesh, make_plan
from ..train.cli import get_parser
from . import run_chapter


@record
def main(argv=None) -> dict:
    parser = get_parser()
    parser.prog = "python -m distributed_training_guide_tpu_torch.chapters.c06_tp"
    parser.add_argument("--tensor-parallel", type=int, default=None,
                        help="tp size (default: all ranks)")
    parser.add_argument("--no-sequence-parallel", action="store_true",
                        help="disable seq-dim sharding of the residual stream")
    args = parser.parse_args(argv)
    return run_chapter(args, lambda n, device: make_plan(
        "tp", make_mesh(tp=args.tensor_parallel or n, device=device),
        sequence_sharded=not args.no_sequence_parallel))


if __name__ == "__main__":
    main()
