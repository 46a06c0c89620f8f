"""Chapter 4 — fully-sharded data parallelism (FSDP / ZeRO-3).

Counterpart of ``04-fully-sharded-data-parallel/train_llm.py``: every
weight sharded on its embed (or vocab) dim over all ranks; each layer's
shards are all-gathered just before the layer and its grads
reduce-scattered in backward. Under ``--checkpoint-activations`` the
recompute gathers again (torch's ``reshard_after_forward``).

    python -m distributed_training_guide_tpu_torch.launch.local --nproc 4 \\
        -- python -m distributed_training_guide_tpu_torch.chapters.c04_fsdp \\
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
    parser.prog = "python -m distributed_training_guide_tpu_torch.chapters.c04_fsdp"
    parser.add_argument("--cpu-offload", action="store_true",
                        help="keep params AND optimizer state in host memory "
                             "between steps (not ported)")
    args = parser.parse_args(argv)
    if args.cpu_offload:
        raise NotImplementedError(
            "--cpu-offload is not ported yet (ROADMAP.md queue 1, "
            "'Chapter 05 recipe and conversion')")
    return run_chapter(args, lambda n, device: make_plan(
        "fsdp", make_mesh(fsdp=n, device=device)))


if __name__ == "__main__":
    main()
