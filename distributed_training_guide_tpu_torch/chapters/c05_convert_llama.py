"""One-time safetensors -> memmap conversion for pretrained weights.

Counterpart of ``05-training-llama-405b/convert_llama.py``: streams the HF
checkpoint tensor by tensor into the converted format of
``models/hf_convert.py`` (one ``.npy`` per leaf; the JAX package reads the
same directory), so peak host memory is a few tensors where the
reference's rank-0 load holds the whole state dict.

    python -m distributed_training_guide_tpu_torch.chapters.c05_convert_llama \\
        <hf_checkpoint_dir> <out_dir> <model-name or hf:<dir>>
"""
from __future__ import annotations

import sys


def main(argv=None) -> None:
    from ..models.hf_convert import convert_hf_checkpoint

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        raise SystemExit(__doc__)
    convert_hf_checkpoint(argv[0], argv[1], argv[2])
    print(f"converted -> {argv[1]}")


if __name__ == "__main__":
    main()
