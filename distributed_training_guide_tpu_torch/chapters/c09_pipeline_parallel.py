"""Chapter 9 — pipeline parallelism.

Counterpart of ``09-pipeline-parallel/train_llm.py``: the stacked layer
dim of every per-layer weight is sharded over the ``pp`` mesh axis (stage
s owns layers [s L/pp, (s+1) L/pp)) and the step runs the
hand-differentiated 1F1B schedule of ``parallel/pipeline.py``:
activations hop to the next stage and cotangents back by neighbour send /
receive, each stage recomputes its forward from a saved-input ring (O(pp)
activation memory), the embedding runs on the first stage and the head
and loss on the last. Composes with fsdp (``--fsdp``), tp (megatron
shards and the vocab-parallel embed / head / loss) and cp (the ring or
Ulysses inside each stage; the schedule then runs every tick, masked).
Bubble overhead is (pp-1)/(M+pp-1) for M microbatches (2 pp by default).

    python -m distributed_training_guide_tpu_torch.launch.local --nproc 4 \\
        -- python -m distributed_training_guide_tpu_torch.chapters.\\
c09_pipeline_parallel -m llama-debug -d synthetic:20000 -s 64 -b 2 \\
        --pipeline-parallel 2 --max-steps 4 --log-freq 2 --device cpu
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
                   "c09_pipeline_parallel")
    parser.add_argument("--pipeline-parallel", type=int, default=2)
    parser.add_argument("--pp-microbatches", type=int, default=None)
    parser.add_argument("--fsdp", type=int, default=1,
                        help="fsdp size alongside pp (2-D pp x fsdp)")
    parser.add_argument("--tensor-parallel", type=int, default=1,
                        help="tp size inside each stage (megatron layer "
                             "shards + vocab-parallel embed / head)")
    parser.add_argument("--context-parallel", type=int, default=1,
                        help="cp size alongside pp: the ring or Ulysses "
                             "(--context-impl) inside each stage; the "
                             "schedule then runs every tick, masked")
    args = parser.parse_args(argv)

    def plan_for(n, device):
        tp, fsdp = args.tensor_parallel, args.fsdp
        strategy = ("pp_tp_fsdp" if tp > 1 and fsdp > 1
                    else "pp_tp" if tp > 1
                    else "pp_fsdp" if fsdp > 1 else "pp")
        return make_plan(strategy, make_mesh(
            pp=args.pipeline_parallel, tp=tp, fsdp=fsdp,
            cp=args.context_parallel, device=device))

    return run_chapter(args, plan_for, pp_microbatches=args.pp_microbatches)


if __name__ == "__main__":
    main()
