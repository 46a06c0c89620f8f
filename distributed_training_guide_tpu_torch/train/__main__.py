"""Chapter 01 on one card: causal-LM training on a single device.

    python -m distributed_training_guide_tpu_torch.train -m llama-3.2-1b \\
        -d synthetic:400000 -s 2048 -b 4 --max-steps 8 --log-freq 2
    python -m distributed_training_guide_tpu_torch.train -m llama-debug \\
        -d synthetic:20000 -s 64 -b 2 --max-steps 6 --device cpu

The counterpart of ``01-single-chip/train_llm.py``: the same flags
(``train/cli.py``), random init from ``--seed``, bf16 compute from fp32
params and fp32 AdamW by default, attention through the flash kernels on
the card. ``-e NAME --save-dir DIR`` keeps checkpoints in ``DIR/NAME`` and
resumes from them when the command is run again.
"""
from __future__ import annotations

from ..launch.errors import record
from .cli import get_parser, run_training


@record
def main(argv=None) -> None:
    run_training(get_parser().parse_args(argv))


if __name__ == "__main__":
    main()
