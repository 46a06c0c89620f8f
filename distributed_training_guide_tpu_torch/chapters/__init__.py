"""The chapters' entry points of the port: each builds a sharding plan and
calls ``train/cli.py:run_training``, as the JAX package's
``0x-*/train_llm.py`` do. Run one with ``torchrun`` or
``python -m distributed_training_guide_tpu_torch.launch.local --nproc N --``
(``--device cpu`` for gloo ranks on the CPU), or alone as a world of one.
"""
from __future__ import annotations


def run_chapter(args, make_plan_for, **train_kw) -> dict:
    """Start the process group on ``args.device``, train under the plan
    ``make_plan_for(world_size, device)`` returns, and take the group
    down again. Under ``--preflight`` the group is a fake one of the
    target world (``train/preflight.py:fake_group``), the plan's mesh is
    built on it and nothing trains: the budget report is returned."""
    import torch.distributed as dist

    from ..launch import maybe_initialize_distributed
    from ..train.cli import run_training

    if getattr(args, "preflight", False):
        from ..train.preflight import fake_group, preflight_world

        world = preflight_world(args)
        with fake_group(world):
            return run_training(args, lambda: make_plan_for(world, "cpu"),
                                **train_kw)
    maybe_initialize_distributed(args.device)
    try:
        return run_training(
            args, lambda: make_plan_for(dist.get_world_size(), args.device),
            **train_kw)
    finally:
        dist.destroy_process_group()
