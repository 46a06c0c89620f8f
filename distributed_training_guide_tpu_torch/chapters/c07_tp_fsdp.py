"""Chapter 7 — 2-D parallelism: FSDP x TP on one mesh.

Counterpart of ``07-2d-parallel/train_llm.py``: one rules table
("tp_fsdp") puts the head / kv / mlp / vocab dims on tp and the embed dims
on fsdp, two orthogonal mesh axes; the diff against chapter 6 is one flag.

    python -m distributed_training_guide_tpu_torch.launch.local --nproc 4 \\
        -- python -m distributed_training_guide_tpu_torch.chapters.c07_tp_fsdp \\
        -m llama-debug -d synthetic:20000 -s 64 -b 2 --max-steps 6 \\
        --tensor-parallel 2 --device cpu
"""
from __future__ import annotations

from ..launch.errors import record
from ..parallel import make_mesh, make_plan
from ..train.cli import get_parser
from . import run_chapter


@record
def main(argv=None) -> dict:
    parser = get_parser()
    parser.prog = "python -m distributed_training_guide_tpu_torch.chapters.c07_tp_fsdp"
    parser.add_argument("--tensor-parallel", type=int, default=1)
    args = parser.parse_args(argv)
    tp = args.tensor_parallel
    return run_chapter(args, lambda n, device: make_plan(
        "tp_fsdp", make_mesh(tp=tp, fsdp=n // tp, device=device)))


if __name__ == "__main__":
    main()
