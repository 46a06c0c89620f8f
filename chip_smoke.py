#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its CUDA kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with one card. The
phases, each of which raises on failure:

1. device — the card's name and power limit; TF32 off for matmul and
   cuDNN, so fp32 references are full fp32;
2. build — every kernel under ``distributed_training_guide_tpu_torch/
   ops/csrc`` compiled by ``nvcc`` (one process per source, in parallel);
3. kernels — the paged-attention kernel against ``paged_attend_reference``
   at llama-3.1-8b's attention shape, over query tiles, pool dtypes,
   windows, softcaps and pad tails, each error against a stated bound;
4. timing — the kernel, its plain version and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick the port never calls) at
   the decode and prefill-chunk shapes, beside the bytes/operations bound;
5. serve — ``ServeEngine`` on llama-3.1-8b at full width and depth in
   bf16 (random weights from a seed), once with bucketed prefill and once
   with 256-token chunks, checking that the kernel carried both programs,
   batch invariance of a greedy request, first-token logits against the
   plain full-context prefill, and a torch.profiler breakdown of a decode
   step.

It ends with a ``{"kernels": [...]}`` line, the card's name and power
limit, and ``{"ok": true, "device": {...}}`` as the last line. Without a
card, or without the repository beside it, it exits non-zero first.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16
              "float32": 67e12}      # fp32 outside the tensor cores (TF32 off)
TOL = {"fp32": 2e-5, "bf16": 3e-2, "int8": 3e-2}
# relative L2 error of first-token logits against the plain prefill:
# bf16 through 32 random layers (rounding in another order and shape
# compounds layer by layer), and fp32 through 2 layers (order only)
LOGIT_REL_L2_BF16 = 1e-1
LOGIT_REL_L2_FP32 = 1e-4
SEED = 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(**kw) -> None:
    print(json.dumps(kw), flush=True)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls,
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

HQ, HKV, D, PAGE, S = 32, 8, 128, 16, 8      # llama-3.1-8b attention
MAX_CTX = 4096


def paged_case(torch, gen, *, t, pool, lengths, m):
    """Shuffled physical pages per slot, 0-filled (trash) table tails."""
    dev = torch.device("cuda")
    s = len(lengths)
    p = s * m + 1
    perm = torch.randperm(p - 1, generator=gen, device=dev).int() + 1
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tables = torch.zeros(s, m, dtype=torch.int32, device=dev)
    for i, n in enumerate(lengths):
        own = min(m, (n + t - 1) // PAGE + 1)
        tables[i, :own] = perm[i * m:i * m + own]
    kf = torch.randn(p, PAGE, HKV, D, generator=gen, device=dev)
    vf = torch.randn(p, PAGE, HKV, D, generator=gen, device=dev)
    qdt = torch.float32 if pool == "fp32" else torch.bfloat16
    q = torch.randn(s, t, HQ, D, generator=gen, device=dev).to(qdt)
    kn = torch.randn(s, t, HKV, D, generator=gen, device=dev).to(qdt)
    vn = torch.randn(s, t, HKV, D, generator=gen, device=dev).to(qdt)
    if pool == "int8":
        from distributed_training_guide_tpu_torch.serve.kv_pages import (
            quantize_kv)
        kp, vp = quantize_kv(kf), quantize_kv(vf)
    else:
        kp, vp = kf.to(qdt), vf.to(qdt)
    return q, kn, vn, kp, vp, tables, lens


def phase_kernels(torch) -> float:
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.serve import kv_pages as kv

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    m = MAX_CTX // PAGE + 16
    worst = 0.0
    n_cases = 0
    for t in (1, 5, 256):
        # mixed contexts up to 4096, one slot starting empty
        lengths = [MAX_CTX - t, 0, 17, 1000, 2047, 3000 - t, 63, 4000 - t]
        for pool in ("fp32", "bf16", "int8"):
            q, kn, vn, kp, vp, tables, lens = paged_case(
                torch, gen, t=t, pool=pool, lengths=lengths, m=m)
            # a pad tail on every other slot for T > 1 (its writes go to
            # the trash page; its query rows are computed and ignored)
            n_valid = torch.tensor([t - (i % 2) * (t // 2)
                                    for i in range(S)],
                                   dtype=torch.int32, device="cuda")
            for window in (None, 1024):
                for softcap in (None, 50.0):
                    out, (kp, vp) = kv.paged_attend(
                        q, kn, vn, kp, vp, tables, lens, window=window,
                        softcap=softcap, impl="flash",
                        n_valid=n_valid if t > 1 else None)
                    torch.cuda.synchronize()
                    scales = ({} if pool != "int8" else dict(
                        k_scale=kp.scale[..., 0], v_scale=vp.scale[..., 0]))
                    ref = pd.paged_attend_reference(
                        q, kp.q if pool == "int8" else kp,
                        vp.q if pool == "int8" else vp, tables, lens,
                        window=window, softcap=softcap, **scales)
                    check(out.shape == q.shape and out.dtype == q.dtype,
                          f"kernel output {out.shape} {out.dtype}")
                    check(bool(torch.isfinite(out.float()).all()),
                          "non-finite kernel output")
                    err = (out.float() - ref.float()).abs().max().item()
                    log(phase="kernels", kernel="paged_attend", T=t,
                        pool=pool, window=window, softcap=softcap,
                        max_abs_err=err, bound=TOL[pool],
                        ok=err <= TOL[pool])
                    check(err <= TOL[pool],
                          f"paged_attend T={t} {pool} window={window} "
                          f"softcap={softcap}: error {err} > {TOL[pool]}")
                    worst = max(worst, err)
                    n_cases += 1
            del q, kn, vn, kp, vp, tables, lens, out, ref
    torch.cuda.empty_cache()
    log(phase="kernels", cases=n_cases, max_abs_err=worst)
    return worst


# ---------------------------------------------------------------------------
# phase 4: timing beside the bound
# ---------------------------------------------------------------------------

def attend_bound(q, pool, lengths, t, itemsize):
    """(bound_ms, bound_by, bytes, flops) from this call's inputs: each
    live page read once (k and v), q read and out written once; 4 * D
    operations per (query row, key) pair inside the causal band."""
    s = len(lengths)
    pages = sum((n + t - 1) // PAGE + 1 for n in lengths)
    nbytes = (pages * PAGE * HKV * D * itemsize * 2
              + 2 * q.numel() * q.element_size() + s * 4)
    pairs = sum(n * t + t * (t + 1) // 2 for n in lengths)
    flops = 4 * D * HQ * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).replace("torch.", "")] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            ) + (nbytes, flops)


def phase_timing(torch) -> dict:
    import torch.nn.functional as F

    from distributed_training_guide_tpu_torch.ops import paged_decode as pd

    out = {}
    dev = torch.device("cuda")
    for name, s, t in (("decode", S, 1), ("chunk", 1, 256)):
        lengths = [MAX_CTX - t] * s
        m = MAX_CTX // PAGE
        n_pages = s * m + 1
        tables = (torch.arange(s * m, dtype=torch.int32, device=dev)
                  .reshape(s, m) + 1)
        tables = tables[:, torch.randperm(m, device=dev)].contiguous()
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kp = torch.randn(n_pages, PAGE, HKV, D, device=dev,
                         dtype=torch.bfloat16)
        vp = torch.randn_like(kp)
        q = torch.randn(s, t, HQ, D, device=dev, dtype=torch.bfloat16)
        launches = pd.LAUNCHES
        ms = cuda_ms(lambda: pd.paged_flash_attend(q, kp, vp, tables, lens),
                     iters=100)
        pd.LAUNCHES = launches   # timing launches are not main-path launches
        plain_ms = cuda_ms(lambda: pd.paged_attend_reference(
            q, kp, vp, tables, lens), iters=10, warmup=2)
        # the library yardstick: SDPA over an already contiguous cache of
        # the same live length, bottom-right causal for the chunk
        kc = kp[tables.long()].reshape(s, m * PAGE, HKV, D).transpose(1, 2)
        vc = vp[tables.long()].reshape(s, m * PAGE, HKV, D).transpose(1, 2)
        kc, vc = kc.contiguous(), vc.contiguous()
        qc = q.transpose(1, 2).contiguous()
        mask = None
        if t > 1:
            qpos = torch.arange(t, device=dev)[:, None] + (MAX_CTX - t)
            mask = torch.arange(MAX_CTX, device=dev)[None, :] <= qpos
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=mask, enable_gqa=True), iters=50)
        bound_ms, bound_by, nbytes, flops = attend_bound(q, kp, lengths, t, 2)
        out[name] = dict(S=s, T=t, context=MAX_CTX, dtype="bf16", ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                         flops=flops, share_of_bound=bound_ms / ms)
        log(phase="timing", shape=name, **out[name])
        del kp, vp, kc, vc, q, qc
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: serving llama-3.1-8b
# ---------------------------------------------------------------------------

def phase_serve(torch, card: str) -> dict:
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model, llama
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many, throughput_stats)

    class RecordingEngine(ServeEngine):
        """Keeps each request's first-token logits (what the last prefill
        forward produced) for the check against the plain prefill."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.first_logits = {}

        def _on_prefill_complete(self, adm, logit):
            self.first_logits[adm.request.request_id] = logit.float()
            return super()._on_prefill_complete(adm, logit)

    t0 = time.perf_counter()
    bundle = get_model("llama-3.1-8b", dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16)
    params = bundle.init(bundle.config, SEED, device="cuda")
    torch.cuda.synchronize()
    log(phase="serve", model="llama-3.1-8b", params=bundle.num_params(),
        layers=bundle.config.num_layers, dtype="bf16",
        init_s=time.perf_counter() - t0)
    vocab = bundle.config.vocab_size
    rng = np.random.default_rng(SEED)
    lens = [17, 2000] + [int(x) for x in rng.integers(17, 2001, 6)]
    specs = [dict(prompt_ids=[int(x) for x in rng.integers(0, vocab, n)],
                  max_new_tokens=32, seed=i,
                  **({"temperature": 0.8, "top_p": 0.9} if i >= 6 else {}))
             for i, n in enumerate(lens)]
    common = dict(n_slots=8, page_size=16, max_len=4096)
    results = {}
    pd.LAUNCHES = 0                           # the main path starts here
    for mode, chunk in (("bucketed", None), ("chunked", 256)):
        eng = RecordingEngine(bundle, params, prefill_chunk=chunk, **common)
        torch.cuda.reset_peak_memory_stats()
        before = pd.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = generate_many(eng, [Request(**r) for r in specs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pd.LAUNCHES - before
        for r in res:
            check(r.finish_reason == "length" and len(r.generated_ids) == 32,
                  f"{mode}: request {r.request_id} ended "
                  f"{r.finish_reason} after {len(r.generated_ids)} tokens")
            check(all(0 <= x < vocab for x in r.generated_ids),
                  f"{mode}: token id out of range")
        decode_launches = bundle.config.num_layers * eng.decode_steps
        prefill_launches = launches - decode_launches
        check(launches > 0 and eng.decode_steps > 0,
              f"{mode}: the decode program launched no kernel")
        if chunk is None:
            check(prefill_launches == 0, "bucketed prefill must not use "
                  "the paged kernel (it runs the plain causal prefill)")
        else:
            check(prefill_launches == bundle.config.num_layers
                  * eng.programs.prefill_calls and prefill_launches > 0,
                  f"chunked: {prefill_launches} chunk launches for "
                  f"{eng.programs.prefill_calls} chunk forwards")
        stats = throughput_stats(res, wall, eng)
        results[mode] = dict(
            engine=eng, res=res, launches=launches,
            decode_launches=decode_launches,
            prefill_launches=prefill_launches)
        log(phase="serve", mode=mode, card=card, wall_s=wall,
            tokens_per_s=stats["tokens_per_s"],
            ttft_s_p50=stats["ttft_s_p50"],
            latency_s_p50=stats["latency_s_p50"],
            itl_s_avg=eng.stats()["itl_s_avg"],
            decode_steps=eng.decode_steps,
            prefill_forwards=eng.programs.prefill_calls,
            kernel_launches=launches,
            kernel_launches_per_decode_step=(decode_launches
                                             / eng.decode_steps),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if mode == "bucketed":
            results[mode]["logits1"] = eng.first_logits[res[1].request_id]
            del eng
            results[mode].pop("engine")
        torch.cuda.empty_cache()
    main_path_launches = pd.LAUNCHES          # ... and ends here

    # one greedy request served alone gives the tokens it got co-batched
    alone = generate_many(ServeEngine(bundle, params, **common),
                          [Request(**specs[0])])[0]
    check(alone.token_ids == results["bucketed"]["res"][0].token_ids,
          "greedy request 0: alone and co-batched tokens differ")
    torch.cuda.empty_cache()

    agree = sum(a.token_ids == b.token_ids
                for a, b in zip(results["bucketed"]["res"],
                                results["chunked"]["res"]))
    log(phase="serve", requests_identical_bucketed_vs_chunked=agree,
        of=len(specs))

    # first-token logits of the 2000-token prompt from the kernel's last
    # chunk (chunked engine) and from the bucketed engine, against the
    # plain full-context prefill of the same prompt
    ids = torch.tensor([specs[1]["prompt_ids"]], device="cuda")
    cache = llama.init_cache(bundle.config, 1, ids.shape[1], device="cuda")
    ref = llama.prefill(bundle.config, params, ids, cache)[0][0].float()
    del cache
    for mode in ("chunked", "bucketed"):
        got = (results["chunked"]["engine"].first_logits[
            results["chunked"]["res"][1].request_id]
            if mode == "chunked" else results["bucketed"]["logits1"])
        check(bool(torch.isfinite(got).all()) and got.shape == (vocab,),
              f"{mode} first-token logits not finite / wrong shape")
        rel = ((got - ref).norm() / ref.norm()).item()
        log(phase="serve", check=f"first-token logits, {mode} vs plain "
            f"prefill, bf16 full depth", prompt_tokens=ids.shape[1],
            rel_l2=rel, bound=LOGIT_REL_L2_BF16,
            max_abs=(got - ref).abs().max().item(),
            argmax_equal=bool(got.argmax() == ref.argmax()))
        check(rel <= LOGIT_REL_L2_BF16, f"{mode} first-token logits rel L2 "
              f"{rel} > {LOGIT_REL_L2_BF16}")
    del results, ref
    torch.cuda.empty_cache()
    log(phase="serve", profile="decode step, bucketed engine, 8 slots",
        card=card, **profile_decode(torch, bundle, params, specs))
    del params
    torch.cuda.empty_cache()
    check_fp32_chunk_path(torch, specs[1]["prompt_ids"])
    return dict(launches=main_path_launches,
                per_step=bundle.config.num_layers)


def profile_decode(torch, bundle, params, specs) -> dict:
    """Device time of steady decode steps, by kernel, from torch.profiler:
    8 slots decoding at prompt lengths of the main run, 4 steps after
    every slot is admitted. Returns per-step device ms, the K4 share, the
    device's idle share of the window (host clock, profiler on), or
    "not measured" when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_guide_tpu_torch.serve import (Request,
                                                            ServeEngine)

    eng = ServeEngine(bundle, params, n_slots=8, page_size=16, max_len=4096)
    for r in specs:
        eng.submit(Request(**{**r, "max_new_tokens": 16}))
    eng.step()                       # admission + every prefill + 1 decode
    check(len(eng.scheduler.active_indices()) == 8, "profile: 8 decoding")
    eng.step()                       # warm
    steps = 4
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3
    if busy == 0:
        return {"device_ms_per_step": "not measured"}
    k4 = sum(dev_us(e) for e in events if "paged_attend" in e.key) / 1e3
    gemm = sum(dev_us(e) for e in events       # cuBLAS / cuBLASLt GEMMs
               if any(w in e.key.lower() for w in ("gemm", "nvjet", "xmma",
                                                   "cutlass"))) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:6]
    out = {"wall_ms_per_step": wall * 1e3 / steps,
           "device_ms_per_step": busy / steps,
           "paged_attend_ms_per_step": k4 / steps,
           "gemm_ms_per_step": gemm / steps,
           "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
           "kernels_per_step": sum(e.count for e in events) / steps,
           "top": [(e.key[:60], dev_us(e) / 1e3 / steps) for e in top]}
    del eng
    torch.cuda.empty_cache()
    return out


def check_fp32_chunk_path(torch, prompt) -> None:
    """llama-3.1-8b at full width, cut to 2 layers, in fp32: the chunked
    engine's first-token logits (every chunk through the kernel) against
    the plain full-context prefill. In fp32 only the summation order
    differs, so this carries the correctness claim the bf16 comparison
    cannot make tightly."""
    from distributed_training_guide_tpu_torch.models import get_model, llama
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many)

    bundle = get_model("llama-3.1-8b", dtype=torch.float32,
                       param_dtype=torch.float32, num_layers=2)
    params = bundle.init(bundle.config, SEED + 1, device="cuda")
    logits = {}

    class Recording(ServeEngine):
        def _on_prefill_complete(self, adm, logit):
            logits[adm.request.request_id] = logit.float()
            return super()._on_prefill_complete(adm, logit)

    eng = Recording(bundle, params, n_slots=1, page_size=16, max_len=4096,
                    prefill_chunk=256)
    rid = generate_many(eng, [Request(prompt_ids=prompt,
                                      max_new_tokens=1)])[0].request_id
    ids = torch.tensor([prompt], device="cuda")
    cache = llama.init_cache(bundle.config, 1, ids.shape[1], device="cuda")
    ref = llama.prefill(bundle.config, params, ids, cache)[0][0].float()
    got = logits[rid]
    rel = ((got - ref).norm() / ref.norm()).item()
    log(phase="serve", check="first-token logits, chunked vs plain "
        "prefill, fp32, full width, 2 layers", prompt_tokens=len(prompt),
        rel_l2=rel, bound=LOGIT_REL_L2_FP32,
        max_abs=(got - ref).abs().max().item(),
        argmax_equal=bool(got.argmax() == ref.argmax()))
    check(bool(torch.isfinite(got).all()), "fp32 logits not finite")
    check(rel <= LOGIT_REL_L2_FP32, f"fp32 chunked logits rel L2 {rel} > "
          f"{LOGIT_REL_L2_FP32}")
    del eng, params, cache
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "distributed_training_guide_tpu_torch" / "ops" / "csrc"
            ).is_dir():
        print(f"chip_smoke: the repository is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_training_guide_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    smi = smi_name_power()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(phase="device", name=card, nvidia_smi=smi,
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, matmul_allow_tf32=False,
        cudnn_allow_tf32=False)

    t0 = time.perf_counter()
    sources = _build.all_sources()
    _build.build(sources)
    log(phase="build", sources=sources, seconds=time.perf_counter() - t0)
    for name in sources:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    worst = phase_kernels(torch)
    timing = phase_timing(torch)
    serve = phase_serve(torch, smi)

    dec = timing["decode"]
    kernels = [{
        "name": "paged_attend", "route": "cuda",
        "source": "distributed_training_guide_tpu_torch/ops/csrc/"
                  "paged_attend.cu",
        "replaces": "distributed_training_guide_tpu/ops/paged_decode.py:107",
        "launches": serve["launches"], "max_abs_err": worst,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "launches_per_decode_step": serve["per_step"],
        "shapes": {k: {kk: v[kk] for kk in ("S", "T", "context", "dtype",
                                            "ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by")}
                   for k, v in timing.items()},
    }]
    log(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
