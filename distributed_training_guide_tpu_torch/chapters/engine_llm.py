"""Config-driven engine training.

Counterpart of ``alternative-frameworks/engine/train_llm.py`` (the
reference's ``alternative-frameworks/deepspeed/train_llm.py``): a JSON
config drives the ZeRO stage, batch sizes, precision and optimizer
(``train/engine.py``), and the loop calls ``engine.train_batch`` once a
step on this rank's rows.

    python -m distributed_training_guide_tpu_torch.launch.local --nproc 4 \\
        -- python -m distributed_training_guide_tpu_torch.chapters.engine_llm \\
        --config alternative-frameworks/engine/config.json \\
        -d synthetic:20000 -s 64 --max-steps 6 --log-freq 2 --device cpu
"""
from __future__ import annotations

import argparse
import logging
import time

from ..launch.errors import record

LOGGER = logging.getLogger(__name__)


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m distributed_training_guide_tpu_torch.chapters."
             "engine_llm")
    parser.add_argument("--config", required=True,
                        help="the engine's JSON config (train/engine.py)")
    parser.add_argument("-d", "--dataset-name", default="synthetic")
    parser.add_argument("--dataset-subset", default=None)
    parser.add_argument("-s", "--seq-length", type=int, default=1024)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--log-freq", type=int, default=10)
    parser.add_argument("--save-dir", default=None)
    parser.add_argument("--ckpt-freq", type=int, default=500)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


@record
def main(argv=None, **engine_kw) -> dict:
    """Returns each logged info dict and the per-step losses and grad
    norms; ``engine_kw`` passes through to ``initialize`` (e.g.
    ``model_overrides``)."""
    from ..data import BatchLoader, get_tokenizer, load_and_preprocess_data
    from ..train.engine import initialize
    from ..utils import init_logging
    from ..utils.procguards import process_count, process_index

    args = make_parser().parse_args(argv)
    engine = initialize(args.config, device=args.device, **engine_kw)
    try:
        init_logging(process_index(), process_count())
        cfg = engine.trainer.bundle.config
        plan = engine.trainer.plan
        seed = engine.config.get("seed", 0)
        seq = min(args.seq_length, cfg.max_position_embeddings)
        data = load_and_preprocess_data(
            args.dataset_name, get_tokenizer(engine.config["model"]), seq,
            max_position_embeddings=cfg.max_position_embeddings, seed=seed,
            dataset_subset=args.dataset_subset)
        loader = BatchLoader(data, engine.global_batch_size,
                             device=engine.trainer.device,
                             grad_accum=engine.trainer.grad_accum, seed=seed,
                             data_rank=plan.data_rank,
                             data_size=plan.data_parallel_size)
        LOGGER.info(f"engine: {plan.strategy} on {plan.sizes}, global "
                    f"batch {engine.global_batch_size}")
        losses, norms, infos = [], [], []
        t0 = time.perf_counter()
        for step, batch in enumerate(loader.epoch_batches(), start=1):
            metrics = engine.train_batch(batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            if step % args.log_freq == 0:
                dt = (time.perf_counter() - t0) / args.log_freq
                info = {"step": step, "loss": losses[-1],
                        "grad_norm": norms[-1], "step_ms": 1000 * dt,
                        "tokens_per_s": engine.global_batch_size * seq / dt}
                LOGGER.info(info)
                infos.append(info)
                t0 = time.perf_counter()
            if args.save_dir and step % args.ckpt_freq == 0:
                engine.save_checkpoint(args.save_dir)
            if args.max_steps and step >= args.max_steps:
                break
        LOGGER.info("done")
        return {"losses": losses, "grad_norms": norms, "infos": infos,
                "strategy": plan.strategy}
    finally:
        engine.close()


if __name__ == "__main__":
    main()
