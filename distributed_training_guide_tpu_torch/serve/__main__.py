"""Serve a model of the zoo: offline batch generation or an HTTP
endpoint, both through the continuous-batching paged-KV engine, on the
card by default.

    python -m distributed_training_guide_tpu_torch.serve -m llama-debug \\
        --prompt-ids 3,17,42 --prompt-ids 5,6 --prompt-ids 9 \\
        --steps 16 --n-slots 4                    # cuda
    python -m distributed_training_guide_tpu_torch.serve -m llama-debug \\
        --prompt-ids 3,17,42 --device cpu         # the plain CPU path
    python -m distributed_training_guide_tpu_torch.serve -m qwen3-30b-a3b \\
        --dtype bfloat16 --prompt-ids 3,17,42     # MoE: K4 and K5
    python -m distributed_training_guide_tpu_torch.serve -m llama-3.1-8b \\
        --dtype bfloat16 --weight-dtype int8 --prompt-ids 3,17,42  # K7
    python -m distributed_training_guide_tpu_torch.serve -m llama-debug \\
        --prompt-ids 1,2,3,1,2,3,1,2 --speculate ngram --spec-k 4 \\
        --device cpu                              # speculative decoding
    python -m distributed_training_guide_tpu_torch.serve -m llama-debug \\
        --http-port 8000 --device cpu             # POST /generate, GET
                                                  # /healthz, /readyz
    python -m distributed_training_guide_tpu_torch.serve -m llama-debug \\
        --prompt-ids 3,17,42 --device cpu --disagg --transport cross_host
                                                  # prefill / decode pair
    python -m distributed_training_guide_tpu_torch.serve -m llama-debug \\
        --prompt-ids 3,17,42 --device cpu --replicas 2    # a routed fleet
    python -m distributed_training_guide_tpu_torch.launch.local --nproc 2 \\
        -- python -m distributed_training_guide_tpu_torch.serve \\
        -m llama-debug --prompt-ids 3,17,42 --device cpu --tp 2 --shard-kv
                                                  # tp 2, the pool on kv heads

The model is built from a random init of ``--seed``, in fp32 by default
(as the JAX package's CLI does); ``--dtype bfloat16`` keeps params and
compute in bf16, which a 30B model needs to fit one card. ``--pretrained
DIR`` loads a converted checkpoint (``models/hf_convert.py``) instead.
Under ``--weight-dtype int8`` the full-precision tree is dropped once the
engine has stored the int8 one, so only the int8 weights stay resident.

``--disagg`` serves through the disaggregated prefill / decode pair
(``--prefill-slots`` concurrent prefills; ``--transport cross_host`` moves
every handoff's pages over the CRC-framed wire between two pools), and
``--replicas N`` fronts N engines sharing one set of programs with the
fleet router; the two do not combine.

``--tp N`` serves under a tp plan of N ranks, one process each, started
by ``launch.local --nproc N`` (or torchrun: the env contract's world size
must be N); ``--shard-kv`` splits the page pool on its kv heads over
them. Rank 0 builds the engine and prints what the single-device CLI
prints (``--http-port`` serves from it); every other rank runs the
engine's programs as rank 0 broadcasts them (``serve/sharding.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time


def _tp_plan(args):
    """The tp plan of ``--tp`` (None at 1), its process group started from
    the env contract, whose world size must be ``--tp``."""
    if args.tp < 1:
        raise SystemExit(f"--tp must be >= 1, got {args.tp}")
    if args.tp == 1:
        if args.shard_kv:
            raise SystemExit("--shard-kv needs a tp mesh: pass --tp > 1")
        return None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != args.tp:
        raise SystemExit(
            f"--tp {args.tp} runs one process per rank and this process "
            f"sees a world of {world}: start it as `python -m "
            f"distributed_training_guide_tpu_torch.launch.local --nproc "
            f"{args.tp} -- python -m distributed_training_guide_tpu_torch."
            f"serve --tp {args.tp} ...` (or torchrun --nproc-per-node "
            f"{args.tp})")
    from ..launch import maybe_initialize_distributed
    from ..parallel import make_mesh, make_plan

    maybe_initialize_distributed(args.device)
    return make_plan("tp", make_mesh(tp=args.tp, device=args.device))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        prog="python -m distributed_training_guide_tpu_torch.serve")
    parser.add_argument("-m", "--model-name", required=True)
    parser.add_argument("--prompt-ids", action="append", default=[],
                        metavar="IDS", help="comma-separated token ids; "
                        "repeat for several requests")
    parser.add_argument("--prompt", action="append", default=[],
                        help="text prompt through the model's tokenizer "
                        "when it is in the local cache, else the byte "
                        "tokenizer (nothing is downloaded); repeatable")
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
    parser.add_argument("--speculate", default="off",
                        choices=("off", "ngram", "draft"),
                        help="speculative decoding: 'ngram' is the "
                        "prompt-lookup drafter, 'draft' a co-resident "
                        "--draft-model; the verify draws the decode step's "
                        "own tokens")
    parser.add_argument("--spec-k", type=int, default=4,
                        help="candidate tokens drafted per slot per "
                        "iteration")
    parser.add_argument("--draft-model", default=None, metavar="NAME",
                        help="model zoo name for --speculate draft (loads "
                        "--draft-pretrained or a random init of --seed + 1)")
    parser.add_argument("--draft-pretrained", default=None, metavar="DIR",
                        help="converted checkpoint dir for the draft model")
    parser.add_argument("--decode-horizon", type=int, default=1,
                        help="decode steps per host read (not with "
                        "--speculate)")
    parser.add_argument("--max-queue", type=int, default=None,
                        help="admission queue bound; submits past it are "
                        "refused with 429")
    parser.add_argument("--priority", type=int, default=0,
                        help="priority of the offline requests (higher "
                        "admits first)")
    parser.add_argument("--deadline-s", type=float, default=None,
                        help="per-request deadline in seconds from submit "
                        "(an expired request is evicted)")
    parser.add_argument("--pretrained", default=None, metavar="DIR",
                        help="converted checkpoint dir (models/hf_convert); "
                        "random init otherwise")
    parser.add_argument("--http-port", type=int, default=None,
                        help="serve the HTTP endpoint on this port until "
                        "SIGTERM (then drain) instead of the offline batch")
    parser.add_argument("--disagg", action="store_true",
                        help="disaggregated serving: separate prefill and "
                        "decode engines joined by a KV-page handoff")
    parser.add_argument("--prefill-slots", type=int, default=1,
                        help="concurrent prefill slots of the --disagg "
                        "prefill engine")
    parser.add_argument("--transport", default="same_host",
                        choices=("same_host", "cross_host"),
                        help="--disagg handoff: 'same_host' moves page "
                        "refcounts over one pool; 'cross_host' moves the "
                        "pages' bytes between two pools over the "
                        "crash-safe serve/transport.py wire")
    parser.add_argument("--replicas", type=int, default=1,
                        help="front N engine replicas with the fleet "
                        "router (prefix affinity, spillover, heartbeat "
                        "fencing, resubmission replay); replicas share "
                        "one set of programs")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel ranks (one process each, "
                        "under launch.local --nproc N); params shard on "
                        "heads / MLP columns / vocab")
    parser.add_argument("--shard-kv", action="store_true",
                        help="split the KV page pool on its kv-head axis "
                        "over the --tp ranks (per-rank pool slices; "
                        "requires --tp > 1)")
    args = parser.parse_args(argv)
    plan = _tp_plan(args)
    if args.replicas > 1 and args.disagg:
        raise SystemExit("--replicas fronts ServeEngine replicas; combining "
                         "it with --disagg per replica is not supported")

    import torch

    from ..models.registry import get_model
    from .engine import ModelPrograms

    dtype = getattr(torch, args.dtype)

    def load(name: str, pretrained, seed: int):
        bundle = get_model(name, dtype=dtype, param_dtype=dtype)
        if pretrained:
            from ..models.hf_convert import load_pretrained

            return bundle, load_pretrained(bundle, None, pretrained,
                                           param_dtype=dtype,
                                           device=args.device)
        return bundle, bundle.init(bundle.config, args.seed + seed,
                                   device=args.device)

    shared = None
    if plan is not None:
        # every rank builds the programs over its shards; rank 0 drives
        shared = ModelPrograms(
            *load(args.model_name, args.pretrained, 0), device=args.device,
            plan=plan, shard_kv=args.shard_kv, attend_impl=args.attend_impl,
            kv_dtype=args.kv_dtype, weight_dtype=args.weight_dtype)
        if not shared.leads:
            shared.follow()
            return
    try:
        _serve(args, load, shared)
    finally:
        if shared is not None:
            shared.release()


def _serve(args, load, shared) -> None:
    """The CLI on rank 0 (or the only process): build the engine, over the
    plan's ``shared`` programs or its own, and serve."""
    import torch

    from ..models.registry import get_model
    from .api import generate_many, serve_http, throughput_stats
    from .engine import ServeEngine
    from .scheduler import Request

    tokenizer = None
    if args.prompt or args.http_port is not None:
        from ..data import get_tokenizer

        tokenizer = get_tokenizer(args.model_name)
    speculate = None if args.speculate == "off" else args.speculate
    if args.speculate == "draft":
        from .engine import resolve_context_bounds
        from .spec import DraftModelDrafter

        if args.draft_model is None:
            raise SystemExit("--speculate draft needs --draft-model NAME")
        draft_bundle, draft_params = load(args.draft_model,
                                          args.draft_pretrained, 1)
        target_len = resolve_context_bounds(
            get_model(args.model_name).config, args.max_len,
            args.page_size)[0]
        speculate = DraftModelDrafter(
            draft_bundle, draft_params, n_slots=args.n_slots,
            max_len=target_len, k=args.spec_k, page_size=args.page_size,
            attend_impl=args.attend_impl, device=args.device)
        del draft_params
    common = dict(n_slots=args.n_slots, page_size=args.page_size,
                  n_pages=args.n_pages, max_len=args.max_len,
                  prefill_chunk=args.prefill_chunk,
                  prefix_cache=not args.no_prefix_cache,
                  attend_impl=args.attend_impl, kv_dtype=args.kv_dtype,
                  weight_dtype=args.weight_dtype, device=args.device,
                  max_queue=args.max_queue, speculate=speculate,
                  spec_k=args.spec_k, decode_horizon=args.decode_horizon)
    # the engine holds the params it serves; under --weight-dtype int8
    # that is the int8 tree alone, the full-precision one dies with load
    # (under a plan the shared programs hold this rank's shards)
    def model():
        if shared is not None:
            return shared.bundle, None
        return load(args.model_name, args.pretrained, 0)

    if shared is not None:
        common["programs"] = shared
    if args.replicas > 1:
        from .router import local_fleet

        engine = local_fleet(*model(), args.replicas, **common)
        first = engine.replicas["r0"].engine
        report = {"replicas": args.replicas, **first.kv_report()}
        programs = first.programs
    elif args.disagg:
        from .disagg import DisaggEngine

        engine = DisaggEngine(*model(), n_prefill_slots=args.prefill_slots,
                              transport=args.transport, **common)
        report, programs = engine.kv_report(), engine.programs
    else:
        engine = ServeEngine(*model(), **common)
        report, programs = engine.kv_report(), engine.programs
    out = {"kv_report": report}
    if args.weight_dtype is not None:
        from .engine import build_weight_report

        out["weight_report"] = build_weight_report(programs)
    print(json.dumps(out))

    if args.http_port is not None:
        import signal

        server, worker = serve_http(engine, port=args.http_port,
                                    tokenizer=tokenizer)
        print(json.dumps({
            "serving": f"http://127.0.0.1:{server.server_address[1]}",
            "endpoints": ["/generate", "/healthz", "/readyz"]}), flush=True)
        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
        try:
            while not stop.wait(timeout=1.0):
                pass
            # refuse new work (503 + Retry-After), finish what is in
            # flight, then exit: a SIGTERM loses no accepted request
            print(json.dumps({"draining": True}), flush=True)
            worker.stop(drain=True)
        except KeyboardInterrupt:
            worker.stop()
        server.shutdown()
        server.server_close()
        worker.join(timeout=5.0)
        return

    prompts = [[int(t) for t in ids.split(",")] for ids in args.prompt_ids]
    for text in args.prompt:
        ids = tokenizer(text)["input_ids"]
        if ids and isinstance(ids[0], list):
            ids = ids[0]
        prompts.append(ids)
    if not prompts:
        raise SystemExit("pass at least one --prompt-ids / --prompt (or "
                         "--http-port for the online endpoint)")
    requests = [Request(prompt_ids=p, max_new_tokens=args.steps,
                        temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed + i,
                        eos_id=args.eos_id, priority=args.priority,
                        deadline_s=args.deadline_s)
                for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    results = generate_many(engine, requests)
    if programs.device.type == "cuda":
        torch.cuda.synchronize(programs.device)
    wall = time.perf_counter() - t0
    for res in results:
        line = {"request_id": res.request_id,
                "finish_reason": res.finish_reason,
                "latency_s": round(res.latency_s, 4),
                "token_ids": res.token_ids}
        if tokenizer is not None:
            line["text"] = tokenizer.decode(res.token_ids)
        print(json.dumps(line))
    print(json.dumps({"stats": {**throughput_stats(results, wall, engine),
                                "device": str(programs.device)}}))
    close = getattr(engine, "close", None)
    if close is not None:
        close()


if __name__ == "__main__":
    main()
