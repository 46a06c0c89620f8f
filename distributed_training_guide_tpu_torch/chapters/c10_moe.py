"""Chapter 10 — a mixture of experts with expert parallelism.

Counterpart of ``10-mixture-of-experts/train_llm.py``: a Mixtral / Qwen-MoE
style model (``models/moe.py``: top-k router, stacked expert FFNs, the
Switch load-balance aux loss) with the expert dim of its stacks sharded
over the ``ep`` mesh axis, which is also a data axis: each rank holds
``E / ep`` experts and its rows of the batch. ``--moe-dispatch ragged``
exchanges sorted expert groups (all-gather of the ep group's rows, each
rank's experts on their window of the sorted buffer through the grouped
GEMMs K5 / K6, reduce-scatter home: ``make_ragged_ep_dispatch``); the
dense dispatch fills each rank's ``[E / ep, C, D]`` capacity buffers from
the global slot map. ``--fsdp`` shards the other dims beside ep
(``ep_fsdp``).

    python -m distributed_training_guide_tpu_torch.launch.local --nproc 4 \\
        -- python -m distributed_training_guide_tpu_torch.chapters.c10_moe \\
        -m moe-debug -d synthetic:20000 -s 64 -b 2 --expert-parallel 4 \\
        --moe-dispatch ragged --max-steps 4 --log-freq 2 --device cpu
"""
from __future__ import annotations

from ..launch.errors import record
from ..parallel import make_mesh, make_plan
from ..train.cli import get_parser
from . import run_chapter


@record
def main(argv=None, **train_kw) -> dict:
    """``train_kw`` goes to ``run_training`` (e.g. ``model_overrides``)."""
    parser = get_parser()
    parser.prog = ("python -m distributed_training_guide_tpu_torch.chapters."
                   "c10_moe")
    parser.add_argument("--expert-parallel", type=int, default=None,
                        help="ep size (default: all ranks over --fsdp)")
    parser.add_argument("--fsdp", type=int, default=1,
                        help="fsdp size alongside ep")
    args = parser.parse_args(argv)

    def plan_for(n, device):
        ep = args.expert_parallel or n // args.fsdp
        strategy = "ep_fsdp" if args.fsdp > 1 else "ep"
        return make_plan(strategy, make_mesh(ep=ep, fsdp=args.fsdp,
                                             device=device))

    return run_chapter(args, plan_for, **train_kw)


if __name__ == "__main__":
    main()
