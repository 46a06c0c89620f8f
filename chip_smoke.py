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
3. kernels — the paged-attention kernel (K4) against
   ``paged_attend_reference`` at llama-3.1-8b's attention shape, over query
   tiles, pool dtypes, windows, softcaps and pad tails, each error against
   a stated bound;
4. timing — K4, its plain version and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick the port never calls) at
   the decode and prefill-chunk shapes, beside the bytes/operations bound;
5. flash — the flash-attention forward (K1) and its backward kernels
   (K2 dq, K3 dk/dv) against their plain versions at llama-3.2-1b's and
   llama-3.1-8b's attention shapes, head_dim 256 and ragged lengths, fp32
   and bf16, causal, windowed, softcapped and banded;
6. flash timing — K1, K2 and K3 at the training path's shape beside their
   plain versions, their bounds and SDPA forward / backward;
7. serve — ``ServeEngine`` on llama-3.1-8b at full width and depth in
   bf16 (random weights from a seed), once with bucketed prefill and once
   with 256-token chunks, checking that K4 carried both programs, batch
   invariance of a greedy request, first-token logits against the plain
   full-context prefill, and a torch.profiler breakdown of a decode step;
8. train — chapter 01's ``run_training`` on llama-3.2-1b at full width
   and depth (bf16 compute, fp32 params and AdamW, synthetic data, 2048
   tokens x 4 sequences), checking finite falling loss and exactly 16
   launches of each of K1-K3 per step (32 of K1 under
   ``--checkpoint-activations``), a torch.profiler breakdown of one step,
   and the loss and grad norm of a step through the kernels against the
   einsum attention (fp32 at 2 layers; bf16 loss at full depth).

It ends with a ``{"kernels": [...]}`` line, the card's name and power
limit, and ``{"ok": true, "device": {...}}`` as the last line. Without a
card, or without the repository beside it, it exits non-zero first.
"""
from __future__ import annotations

import json
import math
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
# phase 7: serving llama-3.1-8b
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


# ---------------------------------------------------------------------------
# phase 5: the flash kernels (K1-K3) against their plain versions
# ---------------------------------------------------------------------------

# fp32 max abs error: the same fp32 arithmetic summed in another order over
# up to 2048 keys (x the GQA group for dk/dv) on O(1)-O(10) values; bf16
# relative L2 per output: the kernels round p (and ds) to bf16 before the
# tensor-core products that follow and the outputs to bf16, where the plain
# version keeps fp32 to the end (ulp 2**-8 relative, about 3e-3 rel L2)
FLASH_TOL_FP32 = {"o": 2e-5, "lse": 2e-5, "dq": 1e-4, "dk": 1e-4,
                  "dv": 1e-4}
FLASH_TOL_BF16_REL_L2 = 1e-2
# (name, B, Sq, Sk, Hq, Hkv, D, dtype, causal, window, softcap, scale, band
# offsets): llama-3.2-1b (the training path's shape first), llama-3.1-8b,
# head_dim 256 with Gemma-2's scale and cap, ragged lengths
FLASH_CASES = [
    ("1b-main", 4, 2048, 2048, 32, 8, 64, "bf16", True, None, None, None,
     None),
    ("1b", 1, 2048, 2048, 32, 8, 64, "fp32", True, None, None, None, None),
    ("1b-window", 1, 2048, 2048, 32, 8, 64, "fp32", True, 1024, None, None,
     None),
    ("1b-softcap", 1, 2048, 2048, 32, 8, 64, "bf16", True, None, 50.0, None,
     None),
    ("1b-noncausal", 1, 2048, 2048, 32, 8, 64, "fp32", False, None, None,
     None, None),
    ("8b", 1, 2048, 2048, 32, 8, 128, "fp32", True, None, None, None, None),
    ("8b-bf16", 2, 2048, 2048, 32, 8, 128, "bf16", True, None, None, None,
     None),
    ("8b-band", 1, 2048, 2048, 32, 8, 128, "fp32", True, 1024, None, None,
     (512, 0)),
    ("8b-window-softcap", 1, 2048, 2048, 32, 8, 128, "bf16", True, 1024,
     50.0, None, None),
    ("d256", 1, 1024, 1024, 8, 4, 256, "fp32", True, None, 50.0,
     256 ** -0.5, None),
    ("d256-window", 1, 1024, 1024, 8, 4, 256, "bf16", True, 512, None, None,
     None),
    ("ragged", 1, 1000, 1000, 32, 8, 64, "fp32", True, None, None, None,
     None),
    ("ragged-cross", 2, 777, 1000, 16, 4, 128, "bf16", False, None, None,
     None, None),
]


def flash_case(torch, gen, b, sq, sk, hq, hkv, d, dtype):
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    return (rand(b, sq, hq, d), rand(b, sk, hkv, d), rand(b, sk, hkv, d),
            rand(b, sq, hq, d))


def phase_flash(torch) -> dict:
    """Each case through K1, then K2 and K3 from the plain forward's lse
    and delta; returns the worst fp32 max abs error per kernel."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    for (name, b, sq, sk, hq, hkv, d, dtype, causal, window, softcap, scale,
         offs) in FLASH_CASES:
        q, k, v, do = flash_case(torch, gen, b, sq, sk, hq, hkv, d, dtype)
        kw = dict(causal=causal, softcap=softcap, scale=scale)
        if offs is None:
            kw["window"] = window
        else:
            kw["band"] = fa.pack_band(window, *offs)
        before = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             ro.float()).contiguous()
        dq = fa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw)
        torch.cuda.synchronize()
        check((fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
              == tuple(x + 1 for x in before), f"{name}: a kernel did not "
              f"launch")
        rdq = fa.flash_dq_reference(q, k, v, do, rlse, delta, **kw)
        rdk, rdv = fa.flash_dkv_reference(q, k, v, do, rlse, delta, **kw)
        pairs = {"o": (o, ro), "lse": (lse, rlse), "dq": (dq, rdq),
                 "dk": (dk, rdk), "dv": (dv, rdv)}
        errs = {}
        for key, (got, want) in pairs.items():
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name} {key}: {got.shape} {got.dtype} vs "
                  f"{want.shape} {want.dtype}")
            check(bool(torch.isfinite(got.float()).all()),
                  f"{name} {key}: non-finite kernel output")
            diff = got.float() - want.float()
            if dtype == "fp32" or key == "lse":
                err, bound = diff.abs().max().item(), FLASH_TOL_FP32[key]
            else:
                err = (diff.norm() / want.float().norm()).item()
                bound = FLASH_TOL_BF16_REL_L2
            errs[key] = err
            check(err <= bound, f"flash {name} {key}: error {err} > {bound}")
        log(phase="flash", case=name, B=b, Sq=sq, Sk=sk, Hq=hq, Hkv=hkv,
            D=d, dtype=dtype, causal=causal, window=window, softcap=softcap,
            band_offsets=offs,
            metric="max_abs" if dtype == "fp32" else "rel_l2 (lse max_abs)",
            **errs)
        if dtype == "fp32":
            worst["flash_fwd"] = max(worst["flash_fwd"], errs["o"],
                                     errs["lse"])
            worst["flash_dq"] = max(worst["flash_dq"], errs["dq"])
            worst["flash_dkv"] = max(worst["flash_dkv"], errs["dk"],
                                     errs["dv"])
        del q, k, v, do, o, lse, ro, rlse, delta, dq, dk, dv, rdq, rdk, rdv
        torch.cuda.empty_cache()
    # checking launches are not main-path launches
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = counts
    log(phase="flash", cases=len(FLASH_CASES), worst_fp32_max_abs=worst)
    return worst


# ---------------------------------------------------------------------------
# phase 6: flash timing at the training path's shape
# ---------------------------------------------------------------------------

def flash_bounds(b, s, hq, hkv, d, itemsize) -> dict:
    """(bound_ms, bound_by) per kernel from this shape: 2 * D operations
    per product per live (query, key) pair of the causal band (K1 two
    products, K2 three, K3 four); each input read and output written once
    (lse / delta fp32)."""
    pairs = b * hq * s * (s + 1) // 2
    q_bytes = b * s * hq * d * itemsize
    kv_bytes = b * s * hkv * d * itemsize
    stat = b * hq * s * 4
    work = {"flash_fwd": (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + stat),
            "flash_dq": (6 * d * pairs,
                         3 * q_bytes + 2 * kv_bytes + 2 * stat),
            "flash_dkv": (8 * d * pairs,
                          2 * q_bytes + 4 * kv_bytes + 2 * stat)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = dict(bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes", flops=flops, bytes=nbytes)
    return out


def phase_flash_timing(torch) -> dict:
    import torch.nn.functional as F

    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    b, s, hq, hkv, d = 4, 2048, 32, 8, 64      # llama-3.2-1b, -s 2048 -b 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q, k, v, do = flash_case(torch, gen, b, s, s, hq, hkv, d, "bf16")
    counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
    args = (q, k, v, do, lse, delta)
    out = {name: {} for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    out["flash_fwd"]["ms"] = cuda_ms(lambda: fa.flash_fwd(q, k, v), iters=10)
    out["flash_dq"]["ms"] = cuda_ms(lambda: fa.flash_bwd_dq(*args), iters=10)
    out["flash_dkv"]["ms"] = cuda_ms(lambda: fa.flash_bwd_dkv(*args),
                                     iters=10)
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = counts
    out["flash_fwd"]["plain_ms"] = cuda_ms(
        lambda: fa.flash_attention_reference(q, k, v), iters=3, warmup=1)
    out["flash_dq"]["plain_ms"] = cuda_ms(
        lambda: fa.flash_dq_reference(*args), iters=3, warmup=1)
    out["flash_dkv"]["plain_ms"] = cuda_ms(
        lambda: fa.flash_dkv_reference(*args), iters=3, warmup=1)
    torch.cuda.empty_cache()
    # the library yardstick: SDPA on [B, H, S, D], forward, and forward +
    # backward minus forward for K2 and K3 together
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        fwd_ms = cuda_ms(sdpa, iters=10)
    both_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                      iters=10)
    out["flash_fwd"]["library_ms"] = fwd_ms
    for name in ("flash_dq", "flash_dkv"):
        out[name]["library_ms"] = both_ms - fwd_ms
        out[name]["library_note"] = ("SDPA forward+backward minus forward: "
                                     "dq, dk and dv together")
    for name, bound in flash_bounds(b, s, hq, hkv, d, 2).items():
        out[name].update(bound)
        out[name]["share_of_bound"] = bound["bound_ms"] / out[name]["ms"]
        log(phase="flash_timing", kernel=name, B=b, S=s, Hq=hq, Hkv=hkv, D=d,
            dtype="bf16", causal=True, **out[name])
    del q, k, v, do, o, lse, delta, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: chapter 01's training loop on llama-3.2-1b
# ---------------------------------------------------------------------------

TRAIN_STEPS = 8
REMAT_STEPS = 2
TRAIN_ARGS = ["-m", "llama-3.2-1b", "-d", "synthetic:400000", "-s", "2048",
              "-b", "4", "--lr", "3e-4", "--seed", str(SEED)]
# one fp32 step through the kernels against one through the einsum
# attention, from the same params and batch: only the summation order
# differs (2 layers, full width)
TRAIN_FP32_REL = 1e-4
# the bf16 loss at full depth, kernels against the einsum attention:
# bf16 rounds at other places on the two paths, through 16 layers
TRAIN_BF16_LOSS_REL = 1e-2


def flash_counts():
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.FWD_LAUNCHES, "flash_dq": fa.DQ_LAUNCHES,
            "flash_dkv": fa.DKV_LAUNCHES}


def reset_flash_counts() -> None:
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0


def phase_train(torch, card: str) -> dict:
    from distributed_training_guide_tpu_torch.train import cli

    layers = 16
    args = cli.get_parser().parse_args(
        TRAIN_ARGS + ["--max-steps", str(TRAIN_STEPS), "--log-freq", "2"])
    reset_flash_counts()                      # the main path starts here
    t0 = time.perf_counter()
    out = cli.run_training(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_counts()                 # ... and ends here
    want = layers * TRAIN_STEPS
    check(launches == {k: want for k in launches},
          f"train: launches {launches}, want {want} of each "
          f"({layers} per step)")
    infos = out["infos"]
    losses = [i["running_loss"] for i in infos]
    check(len(infos) == TRAIN_STEPS // 2 and all(
        map(math.isfinite, losses)), f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    for info in infos:
        log(phase="train", model="llama-3.2-1b", card=card,
            **{k: info[k] for k in ("global_step", "running_loss",
                                    "grad_norm", "tokens_per_s", "mfu",
                                    "time/step", "time/data",
                                    "peak_alloc_gb")})
    log(phase="train", steps=TRAIN_STEPS, wall_s=wall,
        launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
        batch=4, seq=2048, layers=layers)
    state = out["state"]
    profile = profile_train_step(torch, state)
    log(phase="train", profile="one step, llama-3.2-1b, B 4, S 2048",
        card=card, **profile)
    check_bf16_loss(torch, state.params)
    del out, state
    torch.cuda.empty_cache()

    args = cli.get_parser().parse_args(
        TRAIN_ARGS + ["--max-steps", str(REMAT_STEPS), "--log-freq", "1",
                      "--checkpoint-activations"])
    reset_flash_counts()
    remat = cli.run_training(args)
    remat_counts = flash_counts()
    want_remat = {"flash_fwd": 2 * layers * REMAT_STEPS,
                  "flash_dq": layers * REMAT_STEPS,
                  "flash_dkv": layers * REMAT_STEPS}
    check(remat_counts == want_remat, f"remat: launches {remat_counts}, "
          f"want {want_remat}")
    log(phase="train", remat="all", steps=REMAT_STEPS, launches=remat_counts,
        losses=[i["running_loss"] for i in remat["infos"]],
        peak_alloc_gb=remat["last_info"]["peak_alloc_gb"],
        tokens_per_s=remat["last_info"]["tokens_per_s"])
    del remat
    torch.cuda.empty_cache()
    check_fp32_train_step(torch)
    return {"launches": launches, "per_step": layers, "infos": infos,
            "profile": profile}


def _train_batch(torch, vocab: int, b: int, s: int, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, vocab, (b, s), generator=gen, device="cuda")
    return {"input_ids": ids, "labels": ids}


def profile_train_step(torch, state) -> dict:
    """Device time of one optimizer step by kernel, from torch.profiler,
    on the trained state: K1-K3, cuBLAS GEMMs, the device's idle share
    (host clock, profiler on); "not measured" when the profiler reports no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.train.optimizer import (
        adamw_cosine)
    from distributed_training_guide_tpu_torch.train.step import Trainer

    trainer = Trainer(bundle=get_model("llama-3.2-1b"),
                      optimizer=adamw_cosine(3e-4), device="cuda")
    batch = _train_batch(torch, 259, 4, 2048, SEED + 4)
    trainer.step_fn(state, batch)             # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3
    if busy == 0:
        return {"device_ms_per_step": "not measured", "wall_ms": wall * 1e3}

    def ms_of(*words):
        return sum(dev_us(e) for e in events
                   if any(w in e.key.lower() for w in words)) / 1e3

    top = sorted(events, key=dev_us, reverse=True)[:12]
    return {"wall_ms": wall * 1e3, "device_ms": busy,
            "flash_fwd_ms": ms_of("flash_fwd"),
            "flash_dq_ms": ms_of("flash_dq"),
            "flash_dkv_ms": ms_of("flash_dkv"),
            "gemm_ms": ms_of("gemm", "nvjet", "xmma", "cutlass"),
            "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
            "kernels": sum(e.count for e in events),
            "top": [(e.key[:60], dev_us(e) / 1e3) for e in top]}


def check_bf16_loss(torch, params) -> None:
    """The full-depth bf16 loss of one batch through the kernels against
    the einsum attention, from the trained params (forward only)."""
    from distributed_training_guide_tpu_torch.models import get_model, llama
    from distributed_training_guide_tpu_torch.ops.cross_entropy import (
        causal_lm_loss)

    cfg = get_model("llama-3.2-1b").config
    batch = _train_batch(torch, 259, 4, 2048, SEED + 5)
    losses = {}
    with torch.no_grad():
        for impl in ("flash", "xla"):
            logits = llama.apply(cfg, params, batch["input_ids"],
                                 attn_impl=impl)
            losses[impl] = causal_lm_loss(logits, batch["labels"]).item()
            del logits
            torch.cuda.empty_cache()
    rel = abs(losses["flash"] - losses["xla"]) / abs(losses["xla"])
    log(phase="train", check="loss, kernels vs einsum attention, bf16, "
        "full depth, trained params", **losses, rel=rel,
        bound=TRAIN_BF16_LOSS_REL)
    check(rel <= TRAIN_BF16_LOSS_REL, f"bf16 loss rel {rel} > "
          f"{TRAIN_BF16_LOSS_REL}")


def check_fp32_train_step(torch) -> None:
    """llama-3.2-1b at full width cut to 2 layers, fp32 compute: one
    Trainer step through the kernels against one through the einsum
    attention, same params and batch: loss and global grad norm."""
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.train.optimizer import (
        adamw_cosine)
    from distributed_training_guide_tpu_torch.train.step import Trainer

    bundle = get_model("llama-3.2-1b", dtype=torch.float32, num_layers=2)
    params = bundle.init(bundle.config, SEED + 6, device="cuda")
    batch = _train_batch(torch, bundle.config.vocab_size, 2, 2048, SEED + 7)
    got, wq_grad = {}, {}
    for impl in ("flash", "xla"):
        trainer = Trainer(bundle=bundle, optimizer=adamw_cosine(3e-4),
                          attn_impl=impl, device="cuda")
        state = trainer.init_state_from_params(params, SEED)
        before = flash_counts()["flash_fwd"]
        _, metrics = trainer.step_fn(state, batch)
        check((flash_counts()["flash_fwd"] - before)
              == (2 if impl == "flash" else 0),
              f"fp32 step ({impl}): K1 launches")
        got[impl] = {k: v.item() for k, v in metrics.items()}
        # the q projection's grad reaches the loss only through the
        # attention backward (K2 on the kernel path)
        wq_grad[impl] = state.params["layers"]["attn"]["wq"].grad.clone()
        del trainer, state, metrics
        torch.cuda.empty_cache()
    rel = {k: abs(got["flash"][k] - got["xla"][k]) / abs(got["xla"][k])
           for k in ("loss", "grad_norm")}
    rel["wq_grad_rel_l2"] = ((wq_grad["flash"] - wq_grad["xla"]).norm()
                             / wq_grad["xla"].norm()).item()
    log(phase="train", check="one step, kernels vs einsum attention, fp32, "
        "full width, 2 layers, B 2, S 2048", flash=got["flash"],
        xla=got["xla"], rel=rel, bound=TRAIN_FP32_REL)
    for k, r in rel.items():
        check(r <= TRAIN_FP32_REL, f"fp32 train step {k} rel {r} > "
              f"{TRAIN_FP32_REL}")
    del params
    torch.cuda.empty_cache()


def ptxas_summary(build) -> dict:
    """kernel -> {instantiation: [registers, spill store bytes]} from
    ``nvcc -Xptxas -v``, names demangled by the toolkit's ``cu++filt``."""
    import re

    found = []                      # [mangled, registers, spill bytes]
    for name in sorted(build.build_logs):
        for line in build.build_logs[name].splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                found.append([m.group(1), None, None])
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and found:
                found[-1][2] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and found:
                found[-1][1] = int(m.group(1))
    filt = Path(build.nvcc_path()).with_name("cu++filt")
    names = [f[0] for f in found]
    if filt.exists() and names:
        names = subprocess.run([str(filt), *names], capture_output=True,
                               text=True, check=True,
                               timeout=60).stdout.split("\n")[:len(found)]
    out: dict = {}
    for (mangled, regs, spill), name in zip(found, names):
        m = re.search(r"\w+_kernel<[^>]*>", name.replace("(int)", ""))
        short = m.group(0) if m else name.strip()
        kernel = next((k for k in ("paged_attend", "flash_fwd", "flash_dq",
                                   "flash_dkv") if k in short), "other")
        out.setdefault(kernel, {})[short] = [regs, spill]
    return out


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
    ptxas = ptxas_summary(_build)
    log(phase="build", sources=sources, seconds=time.perf_counter() - t0,
        ptxas=ptxas)

    worst = phase_kernels(torch)
    timing = phase_timing(torch)
    flash_worst = phase_flash(torch)
    flash_timing = phase_flash_timing(torch)
    serve = phase_serve(torch, smi)
    train = phase_train(torch, smi)

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
        "ptxas_registers_spills": ptxas.get("paged_attend", {}),
        "shapes": {k: {kk: v[kk] for kk in ("S", "T", "context", "dtype",
                                            "ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by")}
                   for k, v in timing.items()},
    }]
    replaces = {"flash_fwd": 112, "flash_dq": 297, "flash_dkv": 341}
    for name, line in replaces.items():
        t = flash_timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distributed_training_guide_tpu_torch/ops/csrc/"
                      + ("flash_fwd.cu" if name == "flash_fwd"
                         else "flash_bwd.cu"),
            "replaces": f"distributed_training_guide_tpu/ops/"
                        f"flash_attention.py:{line}",
            "launches": train["launches"][name],
            "max_abs_err": flash_worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "launches_per_train_step": train["per_step"],
            "ptxas_registers_spills": ptxas.get(name, {}),
            "shape": "B 4, S 2048, Hq 32, Hkv 8, D 64, bf16, causal",
            **({"library_note": t["library_note"]}
               if "library_note" in t else {}),
        })
    log(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
