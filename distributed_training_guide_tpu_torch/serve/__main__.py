"""Serve a model of the zoo: offline batch generation through the
continuous-batching paged-KV engine, on the card by default.

    python -m distributed_training_guide_tpu_torch.serve -m llama-debug \\
        --prompt-ids 3,17,42 --prompt-ids 5,6 --prompt-ids 9 \\
        --steps 16 --n-slots 4                    # cuda
    python -m distributed_training_guide_tpu_torch.serve -m llama-debug \\
        --prompt-ids 3,17,42 --device cpu         # the plain CPU path
    python -m distributed_training_guide_tpu_torch.serve -m qwen3-30b-a3b \\
        --dtype bfloat16 --prompt-ids 3,17,42     # MoE: K4 and K5
    python -m distributed_training_guide_tpu_torch.serve -m llama-3.1-8b \\
        --dtype bfloat16 --weight-dtype int8 --prompt-ids 3,17,42  # K7

The model is built from a random init of ``--seed``, in fp32 by default
(as the JAX package's CLI does); ``--dtype bfloat16`` keeps params and
compute in bf16, which a 30B model needs to fit one card.
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        prog="python -m distributed_training_guide_tpu_torch.serve")
    parser.add_argument("-m", "--model-name", required=True)
    parser.add_argument("--prompt-ids", action="append", default=[],
                        metavar="IDS", help="comma-separated token ids; "
                        "repeat for several requests")
    parser.add_argument("--steps", type=int, default=32,
                        help="max new tokens per request")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-k", type=int, default=0)
    parser.add_argument("--top-p", type=float, default=1.0)
    parser.add_argument("--eos-id", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n-slots", type=int, default=4,
                        help="concurrent decode slots")
    parser.add_argument("--page-size", type=int, default=16,
                        help="tokens per KV page")
    parser.add_argument("--n-pages", type=int, default=None,
                        help="KV pool size in pages (default: full "
                        "residency; smaller engages admission backpressure)")
    parser.add_argument("--max-len", type=int, default=None,
                        help="max prompt+generation context per request")
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="stream prompts in N-token chunks co-scheduled "
                        "with resident decodes (default: one bucketed "
                        "prefill per prompt)")
    parser.add_argument("--no-prefix-cache", action="store_true",
                        help="disable copy-on-write prefix sharing")
    parser.add_argument("--kv-dtype", default=None,
                        choices=("fp32", "bf16", "int8"),
                        help="KV page pool storage (default: the model "
                        "dtype); 'int8' stores absmax-quantized payloads "
                        "with per-(position, kv-head) fp32 scales")
    parser.add_argument("--weight-dtype", default=None,
                        choices=("fp32", "bf16", "int8"),
                        help="param storage (default: the model dtype). "
                        "'int8' stores block-wise absmax-quantized "
                        "projection weights with per-(row, 32-col-block) "
                        "fp32 scales, dequantized inside the matmul loop "
                        "(the K7 kernel on the card; llama family only); "
                        "a weight_report line prices it")
    parser.add_argument("--attend-impl", default="auto",
                        choices=("auto", "flash", "xla"),
                        help="paged attend family: the CUDA kernel "
                        "('flash'/'auto') or the gather path ('xla', "
                        "--device cpu only)")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="params and compute dtype (default float32)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the engine runs (default cuda; cpu runs "
                        "the plain PyTorch path)")
    args = parser.parse_args(argv)

    import torch

    from ..models.registry import get_model
    from .api import generate_many, throughput_stats
    from .engine import ServeEngine
    from .scheduler import Request

    dtype = getattr(torch, args.dtype)
    bundle = get_model(args.model_name, dtype=dtype, param_dtype=dtype)
    params = bundle.init(bundle.config, args.seed, device=args.device)
    engine = ServeEngine(
        bundle, params, n_slots=args.n_slots, page_size=args.page_size,
        n_pages=args.n_pages, max_len=args.max_len,
        prefill_chunk=args.prefill_chunk,
        prefix_cache=not args.no_prefix_cache, attend_impl=args.attend_impl,
        kv_dtype=args.kv_dtype, weight_dtype=args.weight_dtype,
        device=args.device)
    out = {"kv_report": engine.kv_report()}
    if args.weight_dtype is not None:
        out["weight_report"] = engine.weight_report()
    print(json.dumps(out))
    prompts = [[int(t) for t in ids.split(",")] for ids in args.prompt_ids]
    if not prompts:
        raise SystemExit("pass at least one --prompt-ids")
    requests = [Request(prompt_ids=p, max_new_tokens=args.steps,
                        temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed + i,
                        eos_id=args.eos_id)
                for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    results = generate_many(engine, requests)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    for res in results:
        print(json.dumps({"request_id": res.request_id,
                          "finish_reason": res.finish_reason,
                          "latency_s": round(res.latency_s, 4),
                          "token_ids": res.token_ids}))
    print(json.dumps({"stats": {**throughput_stats(results, wall, engine),
                                "device": str(engine.device)}}))


if __name__ == "__main__":
    main()
