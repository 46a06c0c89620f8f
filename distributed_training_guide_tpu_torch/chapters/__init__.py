"""The chapters' entry points of the port: each builds a sharding plan and
calls ``train/cli.py:run_training``, as the JAX package's
``0x-*/train_llm.py`` do. Run one with ``torchrun`` or
``python -m distributed_training_guide_tpu_torch.launch.local --nproc N --``
(``--device cpu`` for gloo ranks on the CPU), or alone as a world of one.
"""
from __future__ import annotations


def run_chapter(args, make_plan_for) -> dict:
    """Start the process group on ``args.device``, train under the plan
    ``make_plan_for(world_size, device)`` returns, and take the group
    down again."""
    import torch.distributed as dist

    from ..launch import maybe_initialize_distributed
    from ..train.cli import run_training

    maybe_initialize_distributed(args.device)
    try:
        return run_training(
            args, lambda: make_plan_for(dist.get_world_size(), args.device))
    finally:
        dist.destroy_process_group()
