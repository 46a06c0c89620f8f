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
3. kernels — the paged-attention kernels (K4: the split-context body, the
   tensor-core body and the combine) against ``paged_attend_reference``
   at llama-3.1-8b's and qwen3-30b-a3b's attention shapes, over query
   tiles 1 to 256, pool dtypes, windows, softcaps, pad tails and contexts
   on split edges, each body's partials against
   ``split_partials_reference`` and the combine against
   ``combine_partials_reference``, each error against a stated bound, and
   rows bitwise equal between an 8-slot call and 1-slot calls;
4. timing — K4's kernels (device time from torch.profiler; the whole
   call with its host wrapper beside it), the plain versions and
   PyTorch's ``scaled_dot_product_attention`` (a yardstick the port never
   calls) at the llama-3.1-8b decode (context 4096 and 1024),
   qwen3-30b-a3b decode and prefill-chunk shapes, beside the
   bytes/operations bound;
5. flash — the flash-attention forward (K1) and its backward kernels
   (K2 dq, K3 dk/dv) against their plain versions at llama-3.2-1b's,
   llama-3.1-8b's and qwen3-30b-a3b's attention shapes, head_dim 256 and
   ragged lengths, fp32 and bf16, causal, windowed, softcapped and banded,
   and a q whose base lies off 16 bytes; every K1 launch through the body
   that ``_fwd_plan`` names; every bf16 Hopper-body launch (K1-K3 at
   head_dim 64 / 128) also against the plain version at its own
   arithmetic (K1: 64-key tiles with a running max, p rounded to bf16; K2
   / K3: p and ds rounded to bf16) and bitwise equal to a second launch;
6. flash timing — K1, K2 and K3 at both training paths' shapes
   (llama-3.2-1b and qwen3-30b-a3b) beside their plain versions, their
   bounds and SDPA forward / backward (device times, kernels and SDPA alike,
   with no host time: the calls queued behind a device-side sleep; the
   profiler's per-launch time beside them), and K3's causal tail (its time
   against its blocks' work at a non-causal launch's rate);
7. serve — ``ServeEngine`` on llama-3.1-8b at full width and depth in
   bf16 (random weights from a seed), once with bucketed prefill and once
   with 256-token chunks, checking that K4 carried both programs, that
   every K1 launch of the bucketed prefill ran the Hopper body with no
   operand copied, batch invariance of a greedy request, first-token
   logits against the plain full-context prefill, and a torch.profiler
   breakdown of a decode step;
8. train — chapter 01's ``run_training`` on llama-3.2-1b at full width
   and depth (bf16 compute, fp32 params and AdamW, synthetic data, 2048
   tokens x 4 sequences), checking finite falling loss, exactly 16
   launches of each of K1-K3 per step (32 of K1 under
   ``--checkpoint-activations``), every K1 launch through the Hopper body,
   no operand copied for the tensor maps, a torch.profiler breakdown of
   one step,
   and the loss and grad norm of a step through the kernels against the
   einsum attention (fp32 at 2 layers; bf16 loss at full depth);
9. grouped — the grouped matmul (K5) and its transposed form (K6) against
   their plain versions in fp32 and bf16 at qwen3-30b-a3b's decode, chunk
   and training shapes, moe-1b-8e's and qwen1.5-moe-a2.7b's widths, empty
   groups, a tail past ``sum(group_sizes)``, one group taking every row
   and widths off the tiles, the d_lhs form also at fp32 output within
   the fp32 bound, each K5 launch through the body that ``_gmm_plan``
   names (the Hopper body, WMMA, the split body and FMA each run), and the
   autograd Function's grads against plain autograd;
10. grouped timing — K5 at the decode and training shapes (forward and the
   backward's fp32 d_lhs, with the split body's two-pass bound beside the
   fp32 one) and K6 at the training shape beside their plain versions,
   bounds and ``torch._grouped_mm`` (a yardstick the port never calls),
   device times as in phase 6;
11. moe serve — ``ServeEngine`` on qwen3-30b-a3b at full width and depth
   in bf16 (random weights from a seed) with phase 7's traffic, bucketed
   and chunked: exactly 144 K5 launches per forward (every one through the
   Hopper body) and 48 K4 launches per decode step, every K1 launch of the
   bucketed prefill through the Hopper body with no operand copied,
   batch invariance of a greedy request, first-token logits
   against a plain prefill through the plain grouped matmul (bf16 full
   depth; fp32 at 2 layers), a torch.profiler breakdown of a decode step;
12. moe train — ``run_training`` on qwen3-30b-a3b at full width cut to 4
   layers with ``--moe-dispatch ragged`` (bf16 compute, fp32 params and
   AdamW, 2 x 2048 tokens, 6 steps): finite falling loss, no dropped
   pairs, exactly 6 K5 (3 forward through the Hopper body, 3 fp32 d_lhs
   through the split body), 3 K6 and 1 each of K1-K3 launches per layer per
   step (K1 through the Hopper body, no operand copied), a profiled step,
   an fp32 2-layer step through the kernels against
   one through the plain grouped matmul, and 2 dense-dispatch steps that
   launch no K5;
13. qmm — the block-dequant matmul of the int8 serve weights (K7)
   against ``quantized_matmul_reference`` at llama-3.1-8b's projection and
   head widths, M from 1 to 2048, block sizes 32, 128 and 24, a short last
   block, fp32 and bf16 x, fp32 and bf16 outputs, each launch through the
   body that ``_qmm_plan`` names (the tensor-core body and FMA each run),
   and rows bitwise the same whatever M;
14. qmm timing — K7 and its plain version at the gate decode, head decode
   and gate chunk shapes beside their bounds (fp32, and the tensor-core
   body's two passes), device times as in phase 10, with the bf16
   ``torch.mm`` on the unquantized weight as a control the port never
   calls;
15. int8 serve — ``ServeEngine(weight_dtype="int8")`` on llama-3.1-8b at
   full width and depth (bf16 compute) with phase 7's traffic, bucketed
   and chunked: exactly 225 K7 launches per forward, every one through the
   tensor-core body, and phase 7's K4 counts, batch invariance of a greedy request, the weight report
   against the resident bytes, first-token logits against the plain
   prefill over the snapped params (bf16 full depth; fp32 at 2 layers on
   llama-3.1-8b and on llama-3.2-1b, whose tied head runs the plain
   transpose form), and a torch.profiler breakdown of a decode step;
16. chapter 01 — ``run_training`` through the CLI parser on llama-3.2-1b
   (B 4, S 2048): (a) at full width cut to 2 layers, a straight 6-step run
   saving every 2 steps (``-e``, keep 2: exactly 2 retained, every manifest
   verifies), the same with ``--async-checkpoint`` (the same losses, its
   checkpoints bitwise the synchronous ones, checkpoint-4 written while
   steps 5 and 6 updated the state in place), the fallback past a
   corrupted latest checkpoint, and a run crashed at step 4 by the
   exception drill and resumed to step 6 with steps 5-6's losses bitwise
   the straight run's; the bytes and seconds of every save; (b) 4 steps at
   full depth under each precision policy (fp32, bf16-master, adam8bit,
   bf16-master+adam8bit): finite falling loss, 16 launches of K1-K3 per
   step, the peak falling by at least 80% of the state bytes the policy
   saves; (c) 3 steps under each remat policy: K1 32 / 32 / 16 / 16 per
   step (all / dots / attn / attn_mlp), K2 / K3 16, the step-1 loss
   bitwise the run's without remat, peak(all) <= peak(attn) <=
   peak(attn_mlp); (d) adafactor and lion, 4 steps: finite falling loss,
   their state bytes; (e) the NaN drill under ``--guard-policy skip``
   (one step skipped); and qwen3-30b-a3b cut to 2 layers (ragged) without
   remat and under "all" / "attn": K1, K5 and K6 per layer, the loss
   bitwise the same;
17. plans — the distributed plans of chapters 02, 04, 06 and 07 through
   their entry points (``chapters/c02_ddp.py`` plain, ``--zero1`` and
   ``--zero2``, ``c04_fsdp.py``, ``c06_tp.py``, ``c07_tp_fsdp.py``) on a
   one-rank NCCL group from the torchrun env contract (a TCPStore) and a
   six-axis ``DeviceMesh`` of size 1, on llama-3.2-1b at full width and
   depth (B 4, S 2048, 3 steps; zero2 as 2 microbatches of 2, with its
   sharded accumulation buffer): every loss and grad norm within
   ``PLAN_LOSS_REL`` / ``PLAN_NORM_REL`` of the single plan's on the same
   weights and batch (each collective is a copy at one rank), exactly 16
   launches of each of K1-K3 per step (32 for zero2's two microbatches:
   the einsum attention never ran), the step ms, tokens/s and peak GB of
   each beside the single plan's; and a run under chapter 04's plan at 2
   layers saving at step 2 of 3, resumed under chapter 07's plan, whose
   step-3 loss equals the fsdp run's.

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
# K4's partials against ``split_partials_reference`` at the body's own
# arithmetic (the split-context body dequantizes int8 in fp32, the
# tensor-core body rounds it to bf16 as the plain version does): m
# (absolute) and l (relative) are fp32 sums of the same products in
# another order; acc / l per row in relative L2, where the split-context
# body keeps fp32 to the end and the tensor-core body rounds p / l to
# bf16 for P V (2**-9 relative per probability, up to ~5e-3 per row where
# a few keys cancel). One key more or less in a split of 256 to 512 keys
# moves l by ~2e-3 to 4e-3 and acc / l by ~4e-2 to 6e-2.
PART_M_ABS = 1e-4
PART_L_REL = 1e-4
PART_ACC_REL_L2 = {"split": 1e-4, "mma": 2e-2}
# a bf16 output against the fp32 combine of its partials: rounded once,
# so within one bf16 ulp, plus the fp32 error of summing the splits'
# terms in another order (2**-24 of terms up to |v| ~ 5, a few times),
# which exceeds the ulp where an element cancels to |o| < ~5e-4
OUT_BF16_ULPS = 1.0
OUT_FLOOR = 2e-6
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
QWEN3_HEADS = (32, 4)                        # qwen3-30b-a3b: Hq, Hkv (D 128)
MAX_CTX = 4096


def paged_case(torch, gen, *, t, pool, lengths, m, hq=HQ, hkv=HKV):
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
    kf = torch.randn(p, PAGE, hkv, D, generator=gen, device=dev)
    vf = torch.randn(p, PAGE, hkv, D, generator=gen, device=dev)
    qdt = torch.float32 if pool == "fp32" else torch.bfloat16
    q = torch.randn(s, t, hq, D, generator=gen, device=dev).to(qdt)
    kn = torch.randn(s, t, hkv, D, generator=gen, device=dev).to(qdt)
    vn = torch.randn(s, t, hkv, D, generator=gen, device=dev).to(qdt)
    if pool == "int8":
        from distributed_training_guide_tpu_torch.serve.kv_pages import (
            quantize_kv)
        kp, vp = quantize_kv(kf), quantize_kv(vf)
    else:
        kp, vp = kf.to(qdt), vf.to(qdt)
    return q, kn, vn, kp, vp, tables, lens


def partials_err(torch, got, want) -> dict:
    """A body's partials against the plain ones on the (row, split) pairs
    with a live key (the pairs' liveness must agree): m absolute, l
    relative, and each split's normalised output acc / l, max absolute
    and per row in relative L2."""
    (m, l, acc), (rm, rl, racc) = got, want
    live = rl > 0
    check(torch.equal(live, l > 0), "partials: live splits differ")
    o, ro = acc[live] / l[live][:, None], racc[live] / rl[live][:, None]
    return dict(m_abs=(m - rm)[live].abs().max().item(),
                l_rel=(l / rl - 1)[live].abs().max().item(),
                acc_abs=(o - ro).abs().max().item(),
                acc_rel_l2=((o - ro).norm(dim=-1)
                            / ro.norm(dim=-1)).max().item())


def bf16_ulps(torch, got, want, floor=OUT_FLOOR) -> float:
    """max |got - want| in units of (one bf16 ulp of max(|got|, |want|)
    plus ``floor``)."""
    big = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return ((got.float() - want.float()).abs() / (ulp + floor)).max().item()


def phase_kernels(torch) -> dict:
    """Every K4 call against ``paged_attend_reference`` and, in bf16,
    within an ulp of the fp32 combine of its body's partials; the body
    alone (its partials) against ``split_partials_reference`` at the
    body's own arithmetic and the combine alone against
    ``combine_partials_reference`` on the same partials; and rows bitwise
    equal between an S = 8 call and S = 1 calls. Returns the worst max
    abs error of the whole call, of each body (acc / l) and of the
    combine."""
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.serve import kv_pages as kv

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    m = MAX_CTX // PAGE + 16
    counts = (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
              pd.COMBINE_LAUNCHES)
    worst = {"call": 0.0, "split": 0.0, "mma": 0.0, "combine": 0.0}
    tight = {b: {"m_abs": 0.0, "l_rel": 0.0, "acc_rel_l2": 0.0,
                 "out_ulps": 0.0} for b in ("split", "mma")}
    n_cases = 0
    # llama-3.1-8b at every tile and variant; qwen3-30b-a3b's attention
    # shape at every tile without window and softcap
    cases = [(t, HQ, HKV, w, c) for t in (1, 5, 16, 64, 256)
             for w in (None, 1024) for c in (None, 50.0)]
    cases += [(t, *QWEN3_HEADS, None, None) for t in (1, 5, 16, 64, 256)]
    for t, hq, hkv, window, softcap in cases:
        # mixed contexts up to 4096, one slot starting empty, and the
        # newest row on either side of a split edge of each body (256
        # tokens of the split-context body, 512 of the tensor-core one)
        lengths = [MAX_CTX - t, 0, 17, max(0, 256 - t), 257, 512 - t, 512,
                   3000 - t]
        for pool in ("fp32", "bf16", "int8"):
            q, kn, vn, kp, vp, tables, lens = paged_case(
                torch, gen, t=t, pool=pool, lengths=lengths, m=m, hq=hq,
                hkv=hkv)
            # a pad tail on every other slot for T > 1 (its writes go to
            # the trash page; its query rows are computed and ignored)
            n_valid = torch.tensor([t - (i % 2) * (t // 2)
                                    for i in range(S)],
                                   dtype=torch.int32, device="cuda")
            out, (kp, vp) = kv.paged_attend(
                q, kn, vn, kp, vp, tables, lens, window=window,
                softcap=softcap, impl="flash",
                n_valid=n_valid if t > 1 else None)
            torch.cuda.synchronize()
            scales = ({} if pool != "int8" else dict(
                k_scale=kp.scale[..., 0], v_scale=vp.scale[..., 0]))
            pools = ((kp.q, vp.q) if pool == "int8" else (kp, vp))
            kw = dict(window=window, softcap=softcap, **scales)
            ref = pd.paged_attend_reference(q, *pools, tables, lens, **kw)
            check(out.shape == q.shape and out.dtype == q.dtype,
                  f"kernel output {out.shape} {out.dtype}")
            check(bool(torch.isfinite(out.float()).all()),
                  "non-finite kernel output")
            err = (out.float() - ref.float()).abs().max().item()
            plan = pd._plan(t, hq // hkv, D, q.dtype, pools[0].dtype, m)
            parts = pd.split_partials(q, *pools, tables, lens, **kw)
            perr = partials_err(torch, parts, pd.split_partials_reference(
                q.float() if plan.body == "split" else q, *pools, tables,
                lens, pages_per_split=plan.pages_per_split, **kw))
            # the combine in fp32 out: a bf16 out would differ by an ulp
            # wherever ~1e-7 of reordering crosses a rounding edge
            comb = pd.combine_partials(
                *parts, lens, page=PAGE, table_pages=m,
                pages_per_split=plan.pages_per_split, window=window)
            comb_ref = pd.combine_partials_reference(*parts)
            comb_err = (comb - comb_ref).abs().max().item()
            # the call is the body and the combine, rounded once to q's
            # dtype
            out_ulps = (bf16_ulps(torch, out, comb_ref) if pool != "fp32"
                        else None)
            ok = dict(
                call=err <= TOL[pool],
                m=perr["m_abs"] <= PART_M_ABS,
                l=perr["l_rel"] <= PART_L_REL,
                acc=perr["acc_abs"] <= TOL[pool]
                and perr["acc_rel_l2"] <= PART_ACC_REL_L2[plan.body],
                combine=comb_err <= TOL["fp32"],
                out=out_ulps is None or out_ulps <= OUT_BF16_ULPS)
            log(phase="kernels", kernel="paged_attend", body=plan.body,
                T=t, heads=[hq, hkv], pool=pool, window=window,
                softcap=softcap, max_abs_err=err, bound=TOL[pool],
                partials=perr, combine_err=comb_err, out_ulps=out_ulps,
                ok=all(ok.values()))
            check(all(ok.values()),
                  f"paged_attend T={t} heads {hq}/{hkv} {pool} "
                  f"window={window} softcap={softcap}: error {err} (bound "
                  f"{TOL[pool]}), partials {perr}, combine {comb_err}, "
                  f"{out_ulps} ulps; failed: "
                  f"{[k for k, v in ok.items() if not v]}")
            worst["call"] = max(worst["call"], err)
            worst[plan.body] = max(worst[plan.body], perr["acc_abs"])
            worst["combine"] = max(worst["combine"], comb_err)
            for k, v in dict(perr, out_ulps=out_ulps or 0.0).items():
                if k in tight[plan.body]:
                    tight[plan.body][k] = max(tight[plan.body][k], v)
            n_cases += 1
            del q, kn, vn, kp, vp, tables, lens, out, ref, parts, comb
            del comb_ref
    # the plan reads no batch: each row of an S = 8 call equals the same
    # slot's row in an S = 1 call, bit for bit, through both bodies
    for t, pool in ((1, "bf16"), (1, "int8"), (1, "fp32"), (64, "bf16"),
                    (256, "int8")):
        q, _, _, kp, vp, tables, lens = paged_case(
            torch, gen, t=t, pool=pool, lengths=[MAX_CTX - t, 0, 17, 255,
                                                 257, 511, 513, 2000],
            m=m)
        pools, kw = (kp, vp), {}
        if pool == "int8":
            pools = (kp.q, vp.q)
            kw = dict(k_scale=kp.scale[..., 0], v_scale=vp.scale[..., 0])
        batched = pd.paged_flash_attend(q, *pools, tables, lens, **kw)
        same = all(torch.equal(batched[i], pd.paged_flash_attend(
            q[i:i + 1], *pools, tables[i:i + 1], lens[i:i + 1], **kw)[0])
            for i in range(S))
        log(phase="kernels", check="rows bitwise equal, S = 8 vs S = 1",
            T=t, pool=pool, ok=same)
        check(same, f"T={t} {pool}: a row differs between S = 8 and S = 1")
    (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
     pd.COMBINE_LAUNCHES) = counts    # checking launches are not main path
    torch.cuda.empty_cache()
    log(phase="kernels", cases=n_cases, max_abs_err=worst, worst=tight)
    return worst


# ---------------------------------------------------------------------------
# phase 4: timing beside the bound
# ---------------------------------------------------------------------------

def attend_bound(q, hkv, lengths, t, itemsize, extra_bytes=0):
    """(bound_ms, bound_by, bytes, flops) from this call's inputs: each
    live page read once (k and v), q read and out written once (plus
    ``extra_bytes``, a body's partials); 4 * D operations per (query row,
    key) pair inside the causal band."""
    s = len(lengths)
    hq = q.shape[2]
    pages = sum((n + t - 1) // PAGE + 1 for n in lengths)
    nbytes = (pages * PAGE * hkv * D * itemsize * 2
              + 2 * q.numel() * q.element_size() + s * 4 + extra_bytes)
    pairs = sum(n * t + t * (t + 1) // 2 for n in lengths)
    flops = 4 * D * hq * pairs
    return _bound(nbytes, flops, str(q.dtype).replace("torch.", ""))


def _live_splits(lengths, t, pages_per_split) -> int:
    """(slot, split) pairs a body writes partials for: the splits up to
    the one holding each slot's newest row."""
    return sum((n + t - 1) // PAGE // pages_per_split + 1 for n in lengths)


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _kernel_ms(torch, fn, iters: int) -> dict:
    """kernel name -> mean device milliseconds per call of ``fn``, from
    torch.profiler over ``iters`` calls after a warm-up. Each kernel's time
    is its mean per recorded launch times its launches per call (its
    recorded count over ``iters``, rounded), since a profile can miss a few
    launches' records; a kernel whose count is not a whole multiple of
    ``iters`` is logged. A profile that recorded no device time at all
    (its records can all go missing) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if _device_us(e) > 0 and e.count > 0]
        if events:
            break
        log(phase="profiler", attempt=attempt + 1,
            note="no device time recorded: profiling again")
    out = {}
    for e in events:
        per_call = max(1, round(e.count / iters))
        if e.count != per_call * iters:
            log(phase="profiler", kernel=e.key[:60], events=e.count,
                iters=iters, note="launch records missing or extra: the "
                "time is the mean per recorded launch")
        out[e.key] = _device_us(e) / e.count * per_call / 1e3
    check(out, "the profiler reports no device time")
    return out


def queued_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn`` with no host time in
    it: the calls are queued behind a device-side sleep longer than the
    host takes to issue them, then timed by CUDA events as they run back
    to back. Phases 6 and 10 time kernels and library calls (SDPA's
    backward, ``torch._grouped_mm``: several kernels a call) alike this
    way; torch.profiler can miss launch records."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4 * issue_s * 2e9) + 2_000_000)  # cycles at 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    check(start.query() is False, "queued_ms: the device caught up with "
          "the host before the last call was issued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int, names) -> dict:
    """Mean device milliseconds per call of ``fn`` spent in the kernels
    whose name holds each of ``names`` (``_kernel_ms``). A call that is
    host-bound (a ctypes wrapper around a few-microsecond kernel) reads its
    kernels' own time here, where CUDA events around back-to-back calls
    would read the host's."""
    per_kernel = _kernel_ms(torch, fn, iters)
    out = {n: sum(ms for key, ms in per_kernel.items() if n in key)
           for n in names}
    check(all(v > 0 for v in out.values()),
          f"the profiler reports no device time for {names}")
    return out


def phase_timing(torch) -> dict:
    """K4 at the serve shapes: each kernel's device time in the whole call
    (body + combine, as the serve path runs it; torch.profiler), the
    call's time with its host wrapper (CUDA events), the plain versions
    and SDPA, each beside its bound."""
    import torch.nn.functional as F

    from distributed_training_guide_tpu_torch.ops import paged_decode as pd

    out = {}
    dev = torch.device("cuda")
    counts = (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
              pd.COMBINE_LAUNCHES)
    for name, s, t, (hq, hkv), ctx in (
            ("decode", S, 1, (HQ, HKV), MAX_CTX),
            ("chunk", 1, 256, (HQ, HKV), MAX_CTX),
            ("decode-qwen3", S, 1, QWEN3_HEADS, MAX_CTX),
            ("decode-1k", S, 1, (HQ, HKV), 1024)):
        lengths = [ctx - t] * s
        m = MAX_CTX // PAGE
        n_pages = s * m + 1
        tables = (torch.arange(s * m, dtype=torch.int32, device=dev)
                  .reshape(s, m) + 1)
        tables = tables[:, torch.randperm(m, device=dev)].contiguous()
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kp = torch.randn(n_pages, PAGE, hkv, D, device=dev,
                         dtype=torch.bfloat16)
        vp = torch.randn_like(kp)
        q = torch.randn(s, t, hq, D, device=dev, dtype=torch.bfloat16)
        plan = pd._plan(t, hq // hkv, D, q.dtype, kp.dtype, m)
        body = f"paged_attend_{plan.body}"
        dev_ms = device_ms(torch, lambda: pd.paged_flash_attend(
            q, kp, vp, tables, lens), 50, (body, "paged_attend_combine"))
        body_ms, combine_ms = dev_ms[body], dev_ms["paged_attend_combine"]
        ms = body_ms + combine_ms
        call_ms = cuda_ms(lambda: pd.paged_flash_attend(
            q, kp, vp, tables, lens), iters=100)
        plain_ms = cuda_ms(lambda: pd.paged_attend_reference(
            q, kp, vp, tables, lens), iters=10, warmup=2)
        body_plain_ms = cuda_ms(lambda: pd.split_partials_reference(
            q, kp, vp, tables, lens, pages_per_split=plan.pages_per_split),
            iters=5, warmup=1)
        parts = pd.split_partials(q, kp, vp, tables, lens)
        combine_plain_ms = cuda_ms(lambda: pd.combine_partials_reference(
            *parts), iters=10, warmup=2)
        # the library yardstick: SDPA over an already contiguous cache of
        # the same live length, bottom-right causal for the chunk
        kc = kp[tables.long()].reshape(s, m * PAGE, hkv, D)[:, :ctx]
        vc = vp[tables.long()].reshape(s, m * PAGE, hkv, D)[:, :ctx]
        kc, vc = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
        qc = q.transpose(1, 2).contiguous()
        mask = None
        if t > 1:
            qpos = torch.arange(t, device=dev)[:, None] + (ctx - t)
            mask = torch.arange(ctx, device=dev)[None, :] <= qpos
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=mask, enable_gqa=True), iters=50)
        bound = attend_bound(q, hkv, lengths, t, 2)
        # a body writes m, l and acc (fp32) for each live (slot, split)
        # pair of each row; the combine reads them and writes out
        part_bytes = (_live_splits(lengths, t, plan.pages_per_split)
                      * t * hq * (D + 2) * 4)
        body_bound = attend_bound(q, hkv, lengths, t, 2, part_bytes)
        body_bound["bytes"] -= q.numel() * q.element_size()  # writes no out
        body_bound = _bound(body_bound["bytes"], body_bound["flops"],
                            "bfloat16")
        combine_bound = _bound(part_bytes + q.numel() * q.element_size()
                               + s * 4, 0, "float32")
        out[name] = dict(
            S=s, T=t, heads=[hq, hkv], context=ctx, dtype="bf16",
            plan=plan._asdict(), ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=bound["bound_ms"],
            bound_by=bound["bound_by"], bytes=bound["bytes"],
            flops=bound["flops"], share_of_bound=bound["bound_ms"] / ms,
            body_ms=body_ms, body_plain_ms=body_plain_ms,
            body_bound_ms=body_bound["bound_ms"],
            body_bound_by=body_bound["bound_by"],
            combine_ms=combine_ms, combine_plain_ms=combine_plain_ms,
            combine_bound_ms=combine_bound["bound_ms"])
        log(phase="timing", shape=name, **out[name])
        del kp, vp, kc, vc, q, qc, parts
        torch.cuda.empty_cache()
    (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
     pd.COMBINE_LAUNCHES) = counts   # timing launches are not main path
    return out


# ---------------------------------------------------------------------------
# phase 7: serving llama-3.1-8b
# ---------------------------------------------------------------------------

def phase_serve(torch, card: str) -> dict:
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model, llama
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
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
    (pd.LAUNCHES, pd.SPLIT_LAUNCHES, pd.MMA_LAUNCHES,
     pd.COMBINE_LAUNCHES) = (0, 0, 0, 0)      # the main path starts here
    reset_moe_counts()
    copies = fa.ALIGN_COPIES
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
    body_launches = {"split": pd.SPLIT_LAUNCHES, "mma": pd.MMA_LAUNCHES,
                     "combine": pd.COMBINE_LAUNCHES}
    k1 = check_hopper_path("serve", copies)["flash_fwd"]
    log(phase="serve", k4_calls=main_path_launches, k1_launches_by_body=k1,
        **{f"{k}_launches": v for k, v in body_launches.items()})
    for k, v in body_launches.items():
        check(v > 0, f"serve: the main path launched no {k} kernel")

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
    return dict(launches=main_path_launches, body_launches=body_launches,
                per_step=bundle.config.num_layers)


def profile_decode(torch, bundle, params, specs, **engine_kw) -> dict:
    """Device time of steady decode steps, by kernel, from torch.profiler:
    8 slots decoding at prompt lengths of the main run, 4 steps after
    every slot is admitted. Returns per-step device ms, the K4 share, the
    device's idle share of the window (host clock, profiler on), or
    "not measured" when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_guide_tpu_torch.serve import (Request,
                                                            ServeEngine)

    eng = ServeEngine(bundle, params, n_slots=8, page_size=16, max_len=4096,
                      **engine_kw)
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

    dev_us = _device_us
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3
    if busy == 0:
        return {"device_ms_per_step": "not measured"}
    k4 = sum(dev_us(e) for e in events if "paged_attend" in e.key) / 1e3
    k5 = sum(dev_us(e) for e in events if "gmm_" in e.key) / 1e3
    k7 = sum(dev_us(e) for e in events if "qmm_" in e.key) / 1e3
    gemm = sum(dev_us(e) for e in events       # cuBLAS / cuBLASLt GEMMs
               if any(w in e.key.lower() for w in ("gemm", "nvjet", "xmma",
                                                   "cutlass"))) / 1e3
    dtoh = sum(e.count for e in events if "DtoH" in e.key)
    top = sorted(events, key=dev_us, reverse=True)[:6]
    out = {"wall_ms_per_step": wall * 1e3 / steps,
           "device_ms_per_step": busy / steps,
           "paged_attend_ms_per_step": k4 / steps,
           "grouped_matmul_ms_per_step": k5 / steps,
           "quantized_matmul_ms_per_step": k7 / steps,
           "gemm_ms_per_step": gemm / steps,
           "device_to_host_copies_per_step": dtoh / steps,
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
# the Hopper bodies (bf16, D 64 / 128) against the plain version at their
# own arithmetic (K1 ``round_p``: 64-key tiles, a running max, p rounded to
# bf16 before P V; K2 / K3 ``round_p_ds``: p and ds rounded to bf16 before
# the products): only the fp32 summation order of the scores and products
# and the exp differ (~1e-6 relative), which flips the bf16 rounding of a
# few p / ds elements and outputs by one ulp (2**-8), about 1e-4 in
# relative L2 over a sum of hundreds of terms; 1e-3 leaves 10x room and is
# 10x below the fp32 bound
FLASH_TOL_KERNEL_ARITH_REL_L2 = 1e-3
# (name, B, Sq, Sk, Hq, Hkv, D, dtype, causal, window, softcap, scale, band
# offsets): llama-3.2-1b (the training path's shape first), llama-3.1-8b,
# head_dim 256 with Gemma-2's scale and cap, ragged lengths, qwen3-30b-a3b
# (the moe-train path's attention)
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
    ("qwen3-moe", 2, 2048, 2048, 32, 4, 128, "bf16", True, None, None, None,
     None),
    ("ragged-bf16", 2, 1000, 1000, 32, 8, 64, "bf16", True, None, None, None,
     None),
    ("ragged-off16", 2, 1000, 1000, 32, 4, 128, "bf16", True, None, None,
     None, None),
]
# the case whose q lies 8 bytes off 16: the Hopper bodies' wrappers copy it
# for their tensor maps (counted in ALIGN_COPIES)
FLASH_OFF16 = "ragged-off16"


def flash_case(torch, gen, b, sq, sk, hq, hkv, d, dtype):
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    return (rand(b, sq, hq, d), rand(b, sk, hkv, d), rand(b, sk, hkv, d),
            rand(b, sq, hq, d))


def off16(torch, x):
    """``x``'s values in a tensor of its shape whose base lies 8 bytes past
    a 16-byte boundary."""
    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    out = flat[4:].view(x.shape)
    out.copy_(x)
    check(out.data_ptr() % 16 == 8, "off16: base on 16 bytes")
    return out


def check_fwd_arith(torch, fa, name, args, kw, got) -> float:
    """bf16 K1 (the Hopper body) against the plain version at its own
    arithmetic, and a second launch bitwise equal to the first; returns
    the relative L2 error of o."""
    want, _ = fa.flash_attention_reference(*args, **kw, round_p=True)
    again = fa.flash_fwd(*args, **kw)
    torch.cuda.synchronize()
    for key, g, a in zip(("o", "lse"), got, again):
        check(torch.equal(g, a), f"flash {name} {key}: two launches differ")
    err = ((got[0].float() - want.float()).norm() / want.float().norm()).item()
    check(err <= FLASH_TOL_KERNEL_ARITH_REL_L2, f"flash {name} o: {err} from "
          f"the plain version at the kernel's arithmetic > "
          f"{FLASH_TOL_KERNEL_ARITH_REL_L2}")
    return err


def check_kernel_arith(torch, fa, name, args, kw, got) -> dict:
    """bf16 K2 / K3 outputs against the plain version at the kernels' own
    arithmetic, and a second launch of each bitwise equal to the first;
    returns the relative L2 errors."""
    want = (fa.flash_dq_reference(*args, **kw, round_p_ds=True),
            *fa.flash_dkv_reference(*args, **kw, round_p_ds=True))
    again = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    errs = {}
    for key, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
        check(torch.equal(g, a), f"flash {name} {key}: two launches differ")
        errs[key] = ((g.float() - w.float()).norm() / w.float().norm()).item()
        check(errs[key] <= FLASH_TOL_KERNEL_ARITH_REL_L2,
              f"flash {name} {key}: {errs[key]} from the plain version at "
              f"the kernel's arithmetic > {FLASH_TOL_KERNEL_ARITH_REL_L2}")
    return errs


def phase_flash(torch) -> dict:
    """Each case through K1, then K2 and K3 from the plain forward's lse
    and delta; returns the worst fp32 max abs error per kernel and, under
    "kernel_arith", the Hopper bodies' worst bf16 relative L2 error against
    the plain version at their own arithmetic. Every K1 launch runs the
    body that ``_fwd_plan`` names, and copies an operand for its tensor
    maps only in the case off 16 bytes."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    arith = {"flash_fwd": 0.0, "flash_dq": 0.0,   # bf16, rel L2
             "flash_dkv": 0.0}
    counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    for (name, b, sq, sk, hq, hkv, d, dtype, causal, window, softcap, scale,
         offs) in FLASH_CASES:
        q, k, v, do = flash_case(torch, gen, b, sq, sk, hq, hkv, d, dtype)
        if name == FLASH_OFF16:
            q = off16(torch, q)
        kw = dict(causal=causal, softcap=softcap, scale=scale)
        if offs is None:
            kw["window"] = window
        else:
            kw["band"] = fa.pack_band(window, *offs)
        before = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
        fwd_plan = fa._fwd_plan(d, q.dtype)
        bodies, copies = dict(fa.FWD_BODY_LAUNCHES), fa.ALIGN_COPIES
        o, lse = fa.flash_fwd(q, k, v, **kw)
        check(fa.FWD_BODY_LAUNCHES[fwd_plan] == bodies[fwd_plan] + 1,
              f"{name}: K1 did not run the {fwd_plan} body")
        want_copies = int(name == FLASH_OFF16)
        check(fa.ALIGN_COPIES - copies == want_copies, f"{name}: K1 copied "
              f"{fa.ALIGN_COPIES - copies} operands, want {want_copies}")
        ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             ro.float()).contiguous()
        dq = fa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw)
        torch.cuda.synchronize()
        check((fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
              == tuple(x + 1 for x in before), f"{name}: a kernel did not "
              f"launch")
        fwd_arith = (check_fwd_arith(torch, fa, name, (q, k, v), kw, (o, lse))
                     if fwd_plan == "wgmma" else None)
        if fwd_arith is not None:
            arith["flash_fwd"] = max(arith["flash_fwd"], fwd_arith)
        rdq = fa.flash_dq_reference(q, k, v, do, rlse, delta, **kw)
        rdk, rdv = fa.flash_dkv_reference(q, k, v, do, rlse, delta, **kw)
        if dtype == "bf16":
            tight = check_kernel_arith(torch, fa, name, (q, k, v, do, rlse,
                                                         delta), kw,
                                       (dq, dk, dv))
            arith["flash_dq"] = max(arith["flash_dq"], tight["dq"])
            arith["flash_dkv"] = max(arith["flash_dkv"], tight["dk"],
                                     tight["dv"])
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
            band_offsets=offs, fwd_body=fwd_plan,
            body=fa._bwd_plan(d, q.dtype), q_base_off16=name == FLASH_OFF16,
            metric="max_abs" if dtype == "fp32" else "rel_l2 (lse max_abs)",
            **errs, **({"kernel_arith_rel_l2": {"o": fwd_arith, **tight},
                        "bitwise_repeat": True}
                       if dtype == "bf16" else {}))
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
    log(phase="flash", cases=len(FLASH_CASES), worst_fp32_max_abs=worst,
        worst_bf16_kernel_arith_rel_l2=arith)
    return {**worst, "kernel_arith": arith}


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


# (B, S, Hq, Hkv, D) of the two training paths' attention, bf16, causal
FLASH_TIMING_SHAPES = {"1b-main": (4, 2048, 32, 8, 64),      # llama-3.2-1b
                       "moe-train": (2, 2048, 32, 4, 128)}   # qwen3-30b-a3b


def phase_flash_timing(torch) -> dict:
    """shape -> kernel -> times at each training path's shape: the
    kernels' device time ("ms", by ``queued_ms``, as SDPA's
    "library_ms"; torch.profiler's mean per launch as "profiler_ms"),
    CUDA events around back-to-back wrapper calls ("call_ms", SDPA's
    "library_call_ms"), the plain versions, the bound and K3's causal
    tail."""
    return {name: flash_timing_at(torch, *shape)
            for name, shape in FLASH_TIMING_SHAPES.items()}


def flash_timing_at(torch, b, s, hq, hkv, d) -> dict:
    import torch.nn.functional as F

    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q, k, v, do = flash_case(torch, gen, b, s, s, hq, hkv, d, "bf16")
    counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
    args = (q, k, v, do, lse, delta)
    calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v),
             "flash_dq": lambda: fa.flash_bwd_dq(*args),
             "flash_dkv": lambda: fa.flash_bwd_dkv(*args)}
    out = {name: {"call_ms": cuda_ms(fn, iters=10),
                  "ms": queued_ms(torch, fn, 10),
                  "profiler_ms": device_ms(torch, fn, 10, [name])[name]}
           for name, fn in calls.items()}
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

    def both():
        return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    with torch.no_grad():
        fwd_ms = queued_ms(torch, sdpa, 10)
        fwd_call_ms = cuda_ms(sdpa, iters=10)
    both_ms = queued_ms(torch, both, 10)
    both_call_ms = cuda_ms(both, iters=10)
    out["flash_fwd"]["library_ms"] = fwd_ms
    out["flash_fwd"]["library_call_ms"] = fwd_call_ms
    for name in ("flash_dq", "flash_dkv"):
        out[name]["library_ms"] = both_ms - fwd_ms
        out[name]["library_call_ms"] = both_call_ms - fwd_call_ms
        out[name]["library_note"] = ("SDPA forward+backward minus forward "
                                     "(device time): dq, dk and dv "
                                     "together")
    out["flash_dkv"]["causal_tail"] = k3_tail(
        torch, fa, q, k, v, do, out["flash_dkv"]["ms"])
    fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES = counts
    for name, bound in flash_bounds(b, s, hq, hkv, d, 2).items():
        out[name].update(bound)
        out[name]["share_of_bound"] = bound["bound_ms"] / out[name]["ms"]
        out[name]["body"] = (fa._fwd_plan if name == "flash_fwd"
                             else fa._bwd_plan)(d, q.dtype)
        log(phase="flash_timing", kernel=name, B=b, S=s, Hq=hq, Hkv=hkv, D=d,
            dtype="bf16", causal=True, **out[name])
    del q, k, v, do, o, lse, delta, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return out


def k3_tail(torch, fa, q, k, v, do, causal_ms: float) -> dict:
    """K3's causal tail at this shape (Sq = Sk, a multiple of 64): its
    device time against the sum of its blocks' work, priced at the rate
    of a non-causal launch, where every block does the same work (each
    group head's T = S / 64 q tiles). The causal blocks hold T (T + 1) / 2
    of the non-causal T^2 tiles; ``tail_share`` is the part of the causal
    time beyond that sum. ``heaviest_over_mean_slot`` is the heaviest
    block's tiles over the mean tiles per block slot (2 per SM): above 1,
    one block outlasts the even share of the card."""
    b, s, hq, _ = q.shape
    hkv = k.shape[2]
    tiles = s // 64
    o, lse = fa.flash_fwd(q, k, v, causal=False)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()
    full_ms = queued_ms(torch, lambda: fa.flash_bwd_dkv(
        q, k, v, do, lse, delta, causal=False), 10)
    even_ms = full_ms * (tiles + 1) / (2 * tiles)
    slots = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    heaviest = (hq // hkv) * tiles
    mean_slot = b * hq * tiles * (tiles + 1) / 2 / slots
    return {"noncausal_ms": full_ms, "even_ms": even_ms,
            "tail_share": 1 - even_ms / causal_ms,
            "heaviest_over_mean_slot": heaviest / mean_slot}


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
    fa.FWD_BODY_LAUNCHES.update({k: 0 for k in fa.FWD_BODY_LAUNCHES})


def check_hopper_path(where: str, copies: int) -> dict:
    """Every K1 launch since the counts were last reset ran the Hopper body
    and no operand was copied for a tensor map since ``copies`` was read;
    no K5 launch ran the WMMA body (bf16 forwards run the Hopper body,
    fp32-dy d_lhs the split body, fp32 operands the FMA body).
    Returns the launches by body."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    fwd, gmm = dict(fa.FWD_BODY_LAUNCHES), dict(gm.GMM_BODY_LAUNCHES)
    check(fwd["wgmma"] == fa.FWD_LAUNCHES, f"{where}: K1 launches by body "
          f"{fwd}, {fa.FWD_LAUNCHES} in all: not all the Hopper body")
    check(fa.ALIGN_COPIES == copies, f"{where}: {fa.ALIGN_COPIES - copies} "
          f"operands copied for the TMA bodies' 16-byte rule")
    check(gmm["wmma"] == 0 and sum(gmm.values()) == gm.GMM_LAUNCHES,
          f"{where}: K5 launches by body {gmm}, {gm.GMM_LAUNCHES} in all")
    return {"flash_fwd": fwd, "grouped_matmul": gmm}


def phase_train(torch, card: str) -> dict:
    from distributed_training_guide_tpu_torch.train import cli

    layers = 16
    args = cli.get_parser().parse_args(
        TRAIN_ARGS + ["--max-steps", str(TRAIN_STEPS), "--log-freq", "2"])
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    reset_moe_counts()                        # the main path starts here
    copies = fa.ALIGN_COPIES
    t0 = time.perf_counter()
    out = cli.run_training(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_counts()                 # ... and ends here
    bodies = check_hopper_path("train", copies)
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
        k1_launches_by_body=bodies["flash_fwd"], alignment_copies=0,
        batch=4, seq=2048, layers=layers)
    state = out["state"]
    from distributed_training_guide_tpu_torch.models import get_model

    profile = profile_train_step(torch, state, get_model("llama-3.2-1b"), 4,
                                 2048)
    log(phase="train", profile="one step, llama-3.2-1b, B 4, S 2048",
        card=card, **profile)
    check_bf16_loss(torch, state.params)
    del out, state
    torch.cuda.empty_cache()

    args = cli.get_parser().parse_args(
        TRAIN_ARGS + ["--max-steps", str(REMAT_STEPS), "--log-freq", "1",
                      "--checkpoint-activations"])
    reset_flash_counts()
    copies = fa.ALIGN_COPIES
    remat = cli.run_training(args)
    remat_counts = flash_counts()
    check_hopper_path("remat", copies)
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


def profile_train_step(torch, state, bundle, b: int, s: int) -> dict:
    """Device time of one optimizer step by kernel, from torch.profiler,
    on the trained state: K1-K3, K5 / K6, cuBLAS GEMMs, the device's idle
    share (host clock, profiler on); "not measured" when the profiler
    reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_guide_tpu_torch.train.optimizer import (
        adamw_cosine)
    from distributed_training_guide_tpu_torch.train.step import Trainer

    trainer = Trainer(bundle=bundle, optimizer=adamw_cosine(3e-4),
                      device="cuda")
    batch = _train_batch(torch, 259, b, s, SEED + 4)
    trainer.step_fn(state, batch)             # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    dev_us = _device_us
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3
    if busy == 0:
        return {"device_ms_per_step": "not measured", "wall_ms": wall * 1e3}

    def ms_of(*words, exclude=None):
        return sum(dev_us(e) for e in events
                   if any(w in e.key.lower() for w in words)
                   and not (exclude and exclude in e.key.lower())) / 1e3

    top = sorted(events, key=dev_us, reverse=True)[:12]
    return {"wall_ms": wall * 1e3, "device_ms": busy,
            "flash_fwd_ms": ms_of("flash_fwd"),
            "flash_dq_ms": ms_of("flash_dq"),
            "flash_dkv_ms": ms_of("flash_dkv"),
            "grouped_matmul_ms": ms_of("gmm_tc", "gmm_fma", "gmm_hopper",
                                       "gmm_split", exclude="tgmm"),
            "tgmm_ms": ms_of("tgmm_kernel", "tgmm_split"),
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


# ---------------------------------------------------------------------------
# phase 9: the grouped matmul kernels (K5, K6) against their plain versions
# ---------------------------------------------------------------------------

# relative L2 error against the plain version: in fp32 the same products
# summed in another order; with bf16 operands both sides sum exact fp32
# products in fp32 and round the result once to bf16 (half an ulp, 2**-9
# relative per element, about 2e-3 in L2), so the bound leaves 5x room
GMM_REL_L2 = {"fp32": 1e-5, "bf16": 1e-2}
QWEN3_G, QWEN3_TOPK, QWEN3_E, QWEN3_F = 128, 8, 2048, 768


def routed_sizes(torch, gen, tokens: int, experts: int, topk: int):
    """group_sizes [experts] int32 of a top-k routing of random scores."""
    idx = torch.rand(tokens, experts, generator=gen,
                     device="cuda").topk(topk, dim=-1).indices.flatten()
    return torch.zeros(experts, dtype=torch.int32, device="cuda").scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))


def fixed_sizes(torch, sizes):
    return torch.tensor(sizes, dtype=torch.int32, device="cuda")


def gmm_cases(torch, gen):
    """(name, M, K, N, group_sizes): qwen3-30b-a3b at decode (8 slots x
    top-8), a 256-token chunk and training (B 2 x S 2048), gate/up and
    down widths; moe-1b-8e (K 1024, N 2816, top-2 of 8) and
    qwen1.5-moe-a2.7b (G 60, N 1408, top-4) with a tail; empty groups,
    one group taking all rows, widths off every tile."""
    g, k8, e, f = QWEN3_G, QWEN3_TOPK, QWEN3_E, QWEN3_F
    dec = routed_sizes(torch, gen, 8, g, k8)
    chunk = routed_sizes(torch, gen, 256, g, k8)
    train = routed_sizes(torch, gen, 4096, g, k8)
    q15 = routed_sizes(torch, gen, 512, 60, 4)
    return [
        ("qwen3-decode-gate", 64, e, f, dec),
        ("qwen3-decode-down", 64, f, e, dec),
        ("qwen3-chunk-gate", 2048, e, f, chunk),
        ("qwen3-chunk-down", 2048, f, e, chunk),
        ("qwen3-train-gate", 32768, e, f, train),
        ("qwen3-train-down", 32768, f, e, train),
        ("moe-1b-8e", 4096, 1024, 2816, routed_sizes(torch, gen, 2048, 8, 2)),
        ("qwen1.5-moe-tail", 2048 + 37, 2048, 1408, q15),
        ("empty-groups-tail", 777, 256, 320,
         fixed_sizes(torch, [0, 100, 0, 0, 250, 0, 3, 0, 300, 0, 0, 0])),
        ("one-group", 1000, 256, 192, fixed_sizes(torch, [0, 0, 1000, 0])),
        ("off-tile", 1000, 100, 72, fixed_sizes(torch, [333, 0, 400, 17])),
    ]


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def phase_grouped(torch) -> dict:
    """Every case through K5 in fp32 and bf16 (the forward), the
    backward's d_lhs form (fp32 dy against an fp32 or bf16 rhs^T view: the
    FMA and the split body) in the operands' dtype and in fp32, and K6
    (bf16 or fp32 lhs, fp32 dy: the split and the FMA body) in the
    operands' dtype and in fp32, each launch through the body that
    ``_gmm_plan`` / ``_tgmm_plan`` names and each body reached; K6 over a
    NaN tail and a group moved among others; the autograd Function's
    grads against plain autograd. Returns the worst errors."""
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    counts = (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
    worst = {"grouped_matmul": 0.0, "tgmm": 0.0}        # fp32 max abs
    worst_rel = {"fp32": 0.0, "bf16": 0.0}
    n_checks = 0
    bodies_seen, tgmm_seen = set(), set()
    for name, m, k, n, sizes in gmm_cases(torch, gen):
        total = int(sizes.sum())
        g = sizes.shape[0]
        errs = {}
        for dtype in ("fp32", "bf16"):
            dt = torch.float32 if dtype == "fp32" else torch.bfloat16
            lhs = torch.randn(m, k, generator=gen, device="cuda").to(dt)
            rhs = torch.randn(g, k, n, generator=gen, device="cuda").to(dt)
            dy = torch.randn(m, n, generator=gen, device="cuda")
            before = (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
            plans = [gm._gmm_plan(lhs, rhs),
                     gm._gmm_plan(dy, rhs.transpose(1, 2))]
            bodies = dict(gm.GMM_BODY_LAUNCHES)
            tplans = [gm._tgmm_plan(lhs, dy, dt),
                      gm._tgmm_plan(lhs, dy, torch.float32)]
            tbodies = dict(gm.TGMM_BODY_LAUNCHES)
            out = gm.gmm(lhs, rhs, sizes)
            dlhs = gm.gmm(dy, rhs.transpose(1, 2), sizes, dt)
            # the d_lhs form at fp32 output too: the split body (bf16 rhs)
            # is held to the fp32 bound, not only to bf16's
            dlhs32 = gm.gmm(dy, rhs.transpose(1, 2), sizes, torch.float32)
            plans.append(plans[1])
            drhs = gm.tgmm(lhs, dy, sizes, g, dt)
            # K6 at fp32 output too: the split body (bf16 lhs) is held to
            # the fp32 bound, not only to bf16's
            drhs32 = gm.tgmm(lhs, dy, sizes, g, torch.float32)
            torch.cuda.synchronize()
            check((gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
                  == (before[0] + 3, before[1] + 2),
                  f"{name} {dtype}: a kernel did not launch")
            for body in set(tplans):
                check(gm.TGMM_BODY_LAUNCHES[body] - tbodies[body]
                      == tplans.count(body), f"{name} {dtype}: K6 did not "
                      f"run the bodies {tplans} that _tgmm_plan names")
            tgmm_seen |= set(tplans)
            errs[f"drhs_body_{dtype}"] = tplans[0]
            for body in set(plans):
                check(gm.GMM_BODY_LAUNCHES[body] - bodies[body]
                      == plans.count(body), f"{name} {dtype}: K5 did not "
                      f"run the bodies {plans} that _gmm_plan names")
            bodies_seen |= set(plans)
            errs[f"body_{dtype}"] = plans[0]
            errs[f"dlhs_body_{dtype}"] = plans[1]
            refs = {"out": gm.gmm_reference(lhs, rhs, sizes, dt),
                    "dlhs": gm.gmm_reference(dy, rhs.float().transpose(1, 2),
                                             sizes, dt),
                    "dlhs32": gm.gmm_reference(
                        dy, rhs.float().transpose(1, 2), sizes,
                        torch.float32),
                    "drhs32": gm.tgmm_reference(lhs.float(), dy, sizes, g,
                                                torch.float32)}
            refs["drhs"] = refs["drhs32"].to(dt)
            for key, got in (("out", out), ("dlhs", dlhs), ("dlhs32", dlhs32),
                             ("drhs", drhs), ("drhs32", drhs32)):
                want = refs[key]
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"{name} {key}: {got.shape} {got.dtype}")
                check(bool(torch.isfinite(got.float()).all()),
                      f"{name} {key}: non-finite kernel output")
                if not key.startswith("drhs"):
                    check(not bool(got[total:].any()),
                          f"{name} {key}: rows past the total not zero")
                else:
                    check(not bool(got[sizes == 0].any()),
                          f"{name} {key}: an empty group's grad not zero")
                # the backward's two products are fp32 arithmetic whatever
                # the output dtype; a bf16 output rounds once
                err = rel_l2(got, want)
                kind = "fp32" if key in ("dlhs32", "drhs32") else dtype
                bound = GMM_REL_L2[kind]
                errs[f"{key}_{dtype}"] = err
                check(err <= bound, f"grouped {name} {key} {dtype}: rel L2 "
                      f"{err} > {bound}")
                worst_rel[kind] = max(worst_rel[kind], err)
                if kind == "fp32":
                    kern = ("tgmm" if key.startswith("drhs")
                            else "grouped_matmul")
                    worst[kern] = max(worst[kern], (got - want).abs().max()
                                      .item())
                n_checks += 1
            if tplans[1] == "split":  # the split body at its own arithmetic
                err = rel_l2(drhs32, gm.tgmm_reference(
                    lhs, dy, sizes, g, torch.float32, split_dy=True))
                errs["drhs32_vs_split_dy"] = err
                check(err <= TGMM_VS_SPLIT_REL_L2, f"grouped {name} K6 split "
                      f"body vs split_dy plain version: rel L2 {err}")
                n_checks += 1
            del lhs, rhs, dy, out, dlhs, dlhs32, drhs, drhs32, refs
            torch.cuda.empty_cache()
        log(phase="grouped", case=name, M=m, K=k, N=n, G=g, rows=total,
            metric="rel_l2", bound=GMM_REL_L2, **errs)
    check(bodies_seen == set(gm.GMM_BODY_LAUNCHES), f"grouped: the cases "
          f"ran the bodies {bodies_seen}, not each of {set(gm.GMM_BODY_LAUNCHES)}")
    check(tgmm_seen == set(gm.TGMM_BODY_LAUNCHES), f"grouped: K6 ran the "
          f"bodies {tgmm_seen}, not each of {set(gm.TGMM_BODY_LAUNCHES)}")
    invariant = check_gmm_rows_invariant(torch, gm, gen)
    nan_tail = check_tgmm_nan_tail(torch, gm, gen)
    moved = check_tgmm_group_invariant(torch, gm, gen)
    drift = tc_sum_drift(torch, gm, gen)
    # the autograd Function against torch autograd through the plain scan
    # at moe-1b-8e's widths, fp32
    sizes = routed_sizes(torch, gen, 1024, 8, 2)
    lhs = torch.randn(2048 + 5, 1024, generator=gen, device="cuda")
    rhs = torch.randn(8, 1024, 2816, generator=gen, device="cuda") * 0.03
    cot = torch.randn(2048 + 5, 2816, generator=gen, device="cuda")

    def run(impl):
        lv, rv = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
        out = gm.grouped_matmul(lv, rv, sizes, impl=impl)
        torch.sum(out * cot).backward()
        return out.detach(), lv.grad, rv.grad

    got, want = run("auto"), run("scan")
    grad_errs = {key: rel_l2(a, b) for key, a, b in
                 zip(("out", "dlhs", "drhs"), got, want)}
    log(phase="grouped", check="autograd Function vs plain autograd, fp32, "
        "M 2053, K 1024, N 2816, G 8", rel_l2=grad_errs,
        bound=GMM_REL_L2["fp32"])
    for key, err in grad_errs.items():
        check(err <= GMM_REL_L2["fp32"], f"Function {key} rel L2 {err}")
    del lhs, rhs, cot, got, want
    torch.cuda.empty_cache()
    gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES = counts   # checks are not main path
    log(phase="grouped", checks=n_checks, worst_fp32_max_abs=worst,
        worst_rel_l2=worst_rel, rows_bitwise_equal_across_m=invariant,
        tgmm_nan_tail=nan_tail, tgmm_groups_bitwise_equal_moved=moved)
    return {**worst, "tc_sum_drift": drift, "worst_rel_l2": worst_rel}


# the split bodies against their own arithmetic summed in fp64: fp32
# rounding of a sum whose pieces of 128 k the tensor cores add up
SPLIT_VS_FP64_REL_L2 = 1e-6
# K6's split body against its plain version at its arithmetic
# (``split_dy``): the same products, both sums fp32 in other orders
TGMM_VS_SPLIT_REL_L2 = 2e-6


def check_tgmm_nan_tail(torch, gm, gen) -> dict:
    """K6's split body at qwen1.5-moe-a2.7b's widths (M 2085, K 2048, N
    1408, G 60 top-4) with the 37 rows past the total NaN in lhs and dy:
    d_rhs finite, within ``TGMM_VS_SPLIT_REL_L2`` of the plain version at
    its arithmetic and within the fp32 bound of the fp32 plain version
    (both mask the rows outside each group)."""
    m, k, n = 2048 + 37, 2048, 1408
    sizes = routed_sizes(torch, gen, 512, 60, 4)
    total = int(sizes.sum())
    lhs = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(m, n, generator=gen, device="cuda")
    lhs[total:], dy[total:] = float("nan"), float("nan")
    check(gm._tgmm_plan(lhs, dy, torch.float32) == "split",
          "tgmm nan tail: plan")
    got = gm.tgmm(lhs, dy, sizes, 60, torch.float32)
    check(bool(torch.isfinite(got).all()), "tgmm nan tail: a non-finite "
          "d_rhs")
    out = {"tail_rows": m - total,
           "rel_l2_vs_split_dy": rel_l2(got, gm.tgmm_reference(
               lhs, dy, sizes, 60, torch.float32, split_dy=True)),
           "rel_l2_vs_fp32": rel_l2(got, gm.tgmm_reference(
               lhs, dy, sizes, 60, torch.float32))}
    check(out["rel_l2_vs_split_dy"] <= TGMM_VS_SPLIT_REL_L2
          and out["rel_l2_vs_fp32"] <= GMM_REL_L2["fp32"],
          f"tgmm nan tail: {out}")
    del lhs, dy, got
    torch.cuda.empty_cache()
    return out


def check_tgmm_group_invariant(torch, gm, gen) -> list:
    """K6's split body at qwen3-30b-a3b's training gate shape: groups 1,
    64 and 127 of a routed M = 32768 call, each copied into a second call
    whose other groups have other sizes and rows (so that the group starts
    elsewhere) and whose rows past the total are NaN, come out bitwise
    equal. Returns the moved groups' (size, old start, new start)."""
    g, k8, e, f = QWEN3_G, QWEN3_TOPK, QWEN3_E, QWEN3_F
    sizes = routed_sizes(torch, gen, 4096, g, k8)
    lhs = torch.randn(4096 * k8, e, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(4096 * k8, f, generator=gen, device="cuda")
    full = gm.tgmm(lhs, dy, sizes, g, torch.bfloat16)
    offs = [0] + torch.cumsum(sizes, 0).tolist()
    moved = []
    for grp in (1, g // 2, g - 1):
        other = routed_sizes(torch, gen, 3000, g, k8)
        other[grp] = sizes[grp]
        if int(other[:grp].sum()) == offs[grp]:   # the group must move
            other[0] += 1
        starts = [0] + torch.cumsum(other, 0).tolist()
        m2 = starts[-1] + 100
        lhs2 = torch.randn(m2, e, generator=gen, device="cuda").bfloat16()
        dy2 = torch.randn(m2, f, generator=gen, device="cuda")
        lhs2[starts[-1]:], dy2[starts[-1]:] = float("nan"), float("nan")
        lo, lo2, rows = offs[grp], starts[grp], int(sizes[grp])
        check(lo != lo2, f"tgmm: group {grp} did not move")
        lhs2[lo2:lo2 + rows] = lhs[lo:lo + rows]
        dy2[lo2:lo2 + rows] = dy[lo:lo + rows]
        again = gm.tgmm(lhs2, dy2, other, g, torch.bfloat16)
        check(torch.equal(again[grp], full[grp]), f"tgmm: group {grp} "
              f"({rows} rows) moved from row {lo} to {lo2} differs")
        moved.append((rows, lo, lo2))
        del lhs2, dy2, again
    del lhs, dy, full
    torch.cuda.empty_cache()
    return moved


def tc_sum_drift(torch, gm, gen) -> dict:
    """What the tensor cores' own fp32 sum does over a long K, and what the
    split body's fp32 register sum makes of it: one group of 2048 rows, K
    8192, N 256. K5's bf16 Hopper body keeps one wgmma accumulator over K
    (exact bf16 products): its relative L2 error against fp64 and its bias
    (the mean error in the direction of each output's sign, over the mean
    magnitude; negative: toward zero) are logged. The split body (fp32 dy
    against the bf16 rhs^T), whose tensor cores sum 128 k at a time, is
    held within ``SPLIT_VS_FP64_REL_L2`` of its arithmetic (``split_bf16``
    dy) summed in fp64."""
    m, k, n = 2048, 8192, 256
    sizes = fixed_sizes(torch, [m])
    lhs = torch.randn(m, k, generator=gen, device="cuda")
    rhs = (torch.randn(1, k, n, generator=gen, device="cuda") * 0.05
           ).bfloat16()
    out = {}
    for name, a, b in (("wgmma", lhs.bfloat16(), rhs),
                       ("split", lhs, rhs.transpose(1, 2).contiguous()
                        .transpose(1, 2))):
        check(gm._gmm_plan(a, b) == name, f"tc_sum_drift: {name} plan")
        got = gm.gmm(a, b, sizes, torch.float32).double()
        exact = (gm.split_bf16(a.float()) if name == "split"
                 else a.float()).double() @ b[0].double()
        out[name] = {"rel_l2": rel_l2(got, exact), "bias": (
            ((got - exact) * exact.sign()).mean() / exact.abs().mean()
        ).item()}
    log(phase="grouped", check="tensor-core fp32 sum over K 8192 vs fp64: "
        "one accumulator (wgmma body) and 128-k pieces (split body)",
        M=m, K=k, N=n, **out, bound_split=SPLIT_VS_FP64_REL_L2)
    check(out["split"]["rel_l2"] <= SPLIT_VS_FP64_REL_L2, f"split body vs "
          f"fp64 rel L2 {out['split']['rel_l2']}")
    del lhs, rhs
    torch.cuda.empty_cache()
    return out


def check_gmm_rows_invariant(torch, gm, gen) -> list:
    """The bf16 Hopper body at qwen3-30b-a3b's training gate shape: the
    first rows (at most 200) of a few groups, run alone (decode-sized M:
    64 x 128 tiles), come out bitwise equal to the same rows of the full
    M = 32768 product (128 x 256 tiles). Returns the row counts."""
    g, k8, e, f = QWEN3_G, QWEN3_TOPK, QWEN3_E, QWEN3_F
    sizes = routed_sizes(torch, gen, 4096, g, k8)
    lhs = torch.randn(4096 * k8, e, generator=gen, device="cuda").bfloat16()
    rhs = (torch.randn(g, e, f, generator=gen, device="cuda") * 0.02
           ).bfloat16()
    full = gm.gmm(lhs, rhs, sizes)
    offs = [0] + torch.cumsum(sizes, 0).tolist()
    checked = []
    for grp in (0, g // 2, g - 1):
        rows = min(int(sizes[grp]), 200)      # a decode-sized M
        alone = torch.zeros_like(sizes)
        alone[grp] = rows
        lo = offs[grp]
        few = gm.gmm(lhs[lo:lo + rows].contiguous(), rhs, alone)
        check(torch.equal(few, full[lo:lo + rows]), f"grouped: group "
              f"{grp}'s first {rows} rows alone differ from the same rows "
              f"at M {full.shape[0]}")
        checked.append(rows)
    return checked


# ---------------------------------------------------------------------------
# phase 10: grouped matmul timing
# ---------------------------------------------------------------------------

def gmm_bound(m, k, n, sizes, lhs_b, rhs_b, out_b, peak) -> dict:
    """K5: lhs read once, the rhs slices of the non-empty groups read
    once, out written once; 2 K N operations per row below the total."""
    total = int(sizes.sum())
    live = int((sizes > 0).sum())
    nbytes = m * k * lhs_b + live * k * n * rhs_b + m * n * out_b
    return _bound(nbytes, 2 * total * k * n, peak)


def tgmm_bound(m, k, n, sizes, lhs_b, dy_b, out_b, peak) -> dict:
    """K6: lhs and dy read once, every group's [K, N] written once."""
    total = int(sizes.sum())
    g = sizes.shape[0]
    nbytes = m * k * lhs_b + m * n * dy_b + g * k * n * out_b
    return _bound(nbytes, 2 * total * k * n, peak)


def _bound(nbytes, flops, peak) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def tc_bound(nbytes, flops) -> float:
    """The least time of a product whose fp32 operand is split into two
    bf16 parts: twice its operations against the bf16 tensor-core peak,
    or its bytes, whichever is larger (ms)."""
    return max(nbytes / HBM_BYTES_PER_S, 2 * flops / PEAK_FLOPS["bfloat16"]
               ) * 1e3


def library_grouped_mm(torch, lhs, rhs, sizes):
    """``torch._grouped_mm`` on the same bf16 operands (offsets = the
    cumsum of the group sizes), as a yardstick: (device ms, CUDA-event ms,
    its output), or (None, None, why) where this torch lacks it or refuses
    the layout."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, None, "torch._grouped_mm is absent from this torch"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    errors = []
    for b in (rhs, rhs.transpose(1, 2).contiguous().transpose(1, 2)):
        try:
            out = fn(lhs, b, offs=offs)
            torch.cuda.synchronize()
        except RuntimeError as exc:        # layout refused: try the next
            errors.append(str(exc).splitlines()[0][:120])
            continue
        call = lambda: fn(lhs, b, offs=offs)      # noqa: E731
        return (queued_ms(torch, call, 20), cuda_ms(call, iters=20),
                out)
    return None, None, "; ".join(errors)


def phase_grouped_timing(torch) -> dict:
    """K5 at the decode and training shapes (forward and the fp32 d_lhs)
    and K6 at the training gate / up and down shapes: each kernel's device
    time ("ms", by ``queued_ms``, as ``torch._grouped_mm``'s "library_ms";
    torch.profiler's mean per launch as "profiler_ms"; CUDA events around
    back-to-back calls as "call_ms"), the plain versions and the bound
    (for the split bodies also their two-pass bound, "bound_tc_ms"; for
    K6 the FMA body's time on the same values, ``tgmm_timing_at``)."""
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    counts = (gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES)
    bf, f32 = torch.bfloat16, torch.float32
    g, k8, e, f = QWEN3_G, QWEN3_TOPK, QWEN3_E, QWEN3_F
    out = {}
    for name, tokens in (("decode", 8), ("train", 4096)):
        m = tokens * k8
        sizes = routed_sizes(torch, gen, tokens, g, k8)
        lhs = torch.randn(m, e, generator=gen, device="cuda").to(bf)
        rhs = (torch.randn(g, e, f, generator=gen, device="cuda") * 0.02
               ).to(bf)
        call = lambda: gm.gmm(lhs, rhs, sizes)   # noqa: E731
        ms = queued_ms(torch, call, 20)
        profiler_ms = device_ms(torch, call, 20, ["gmm_"])["gmm_"]
        call_ms = cuda_ms(call, iters=20)
        plain_ms = cuda_ms(lambda: gm.gmm_reference(lhs, rhs, sizes, bf),
                           iters=3, warmup=1)
        lib_ms, lib_call_ms, lib = library_grouped_mm(torch, lhs, rhs, sizes)
        row = dict(kernel="grouped_matmul", shape=name, M=m, K=e, N=f, G=g,
                   rows=int(sizes.sum()),
                   groups_nonempty=int((sizes > 0).sum()), dtype="bf16",
                   body=gm._gmm_plan(lhs, rhs), ms=ms,
                   profiler_ms=profiler_ms, call_ms=call_ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   library_call_ms=lib_call_ms,
                   **gmm_bound(m, e, f, sizes, 2, 2, 2, "bfloat16"))
        if lib_ms is None:
            row["library_note"] = lib
        else:
            total = int(sizes.sum())
            row["library_rel_l2_vs_kernel"] = rel_l2(
                lib[:total], gm.gmm(lhs, rhs, sizes)[:total])
        row["share_of_bound"] = row["bound_ms"] / ms
        out[name] = row
        log(phase="grouped_timing", **row)
        if name == "train":
            # the backward: fp32 d_lhs = dy @ rhs^T (K5, split body) and
            # d_rhs = lhs^T dy (K6), bf16 outputs as on the training path
            dy = torch.randn(m, f, generator=gen, device="cuda")
            rt = rhs.transpose(1, 2)
            call = lambda: gm.gmm(dy, rt, sizes, bf)   # noqa: E731
            ms = queued_ms(torch, call, 5)
            profiler_ms = device_ms(torch, call, 5, ["gmm_"])["gmm_"]
            call_ms = cuda_ms(call, iters=5)
            plain_ms = cuda_ms(lambda: gm.gmm_reference(
                dy, rhs.float().transpose(1, 2), sizes, bf), iters=2,
                warmup=1)
            row = dict(kernel="grouped_matmul", shape="train-dlhs", M=m, K=f,
                       N=e, G=g, dtype="fp32 dy, bf16 rhs^T, bf16 out",
                       body=gm._gmm_plan(dy, rt), ms=ms,
                       profiler_ms=profiler_ms, call_ms=call_ms,
                       plain_ms=plain_ms, library_ms=None,
                       library_note="no PyTorch call takes fp32 dy against "
                       "a bf16 rhs", **gmm_bound(m, f, e, sizes, 4, 2, 2,
                                                 "float32"))
            # the split body's own least time: two bf16 passes on the
            # tensor cores, the same bytes
            row["bound_tc_ms"] = tc_bound(row["bytes"], row["flops"])
            row["share_of_bound"] = row["bound_ms"] / ms
            row["share_of_tc_bound"] = row["bound_tc_ms"] / ms
            out["train-dlhs"] = row
            log(phase="grouped_timing", **row)
            out["tgmm-train"] = tgmm_timing_at(torch, gm, lhs, dy, sizes,
                                               "gate")
            # the down projection's d_rhs: its input [M, F] against its
            # fp32 dy [M, E]
            lhs_down = torch.randn(m, f, generator=gen, device="cuda").to(bf)
            dy_down = torch.randn(m, e, generator=gen, device="cuda")
            out["tgmm-train-down"] = tgmm_timing_at(torch, gm, lhs_down,
                                                    dy_down, sizes, "down")
            del lhs_down, dy_down
            del dy, rt
        del lhs, rhs, lib
        torch.cuda.empty_cache()
    gm.GMM_LAUNCHES, gm.TGMM_LAUNCHES = counts
    return out


def modelled_chunk_spread(sizes, k: int, n: int, blocks: int) -> dict:
    """How K6's split body's schedule deals its chunks to ``blocks``
    persistent blocks, by arithmetic alone (nothing is timed): its static
    grid of G x ceil(K / 128) x ceil(N / 128) tiles, group-major, block b
    taking tiles b, b + blocks, ...; a tile counted as its group's 64-row
    chunks (its epilogue and an empty group's zero stores left out). The
    largest block's chunks against the mean."""
    import numpy as np

    chunks = -(-np.maximum(sizes.cpu().numpy().astype(np.int64), 0) // 64)
    tiles = -(-k // 128) * -(-n // 128)
    cost = np.repeat(chunks, tiles)
    per_block = np.bincount(np.arange(cost.size) % blocks, weights=cost,
                            minlength=blocks)
    return {"blocks": blocks, "tiles": int(cost.size),
            "chunks_max": float(per_block.max()),
            "chunks_mean": float(per_block.mean()),
            "max_over_mean": float(per_block.max() / per_block.mean())}


def tgmm_timing_at(torch, gm, lhs, dy, sizes, shape: str) -> dict:
    """K6 (bf16 lhs [M, K], fp32 dy [M, N], bf16 out, as the training
    backward calls it) through the body ``_tgmm_plan`` names: device time
    by ``queued_ms`` ("ms"), torch.profiler ("profiler_ms"), CUDA events
    around back-to-back calls ("call_ms"); the plain version; the fp32 and
    the two-pass bound; the FMA body on the same values ("fma_ms": lhs
    through a row stride off 16 bytes, which ``_tgmm_plan`` sends to it);
    the all-bf16 ``torch._grouped_mm`` as a control (it takes no fp32
    dy); how the schedule deals the chunks to the SMs, by arithmetic
    (``modelled_chunk_spread``, kept out of the ``kernels`` line)."""
    bf = torch.bfloat16
    m, k = lhs.shape
    n, g = dy.shape[1], sizes.shape[0]
    call = lambda: gm.tgmm(lhs, dy, sizes, g, bf)   # noqa: E731
    ms = queued_ms(torch, call, 5)
    profiler_ms = device_ms(torch, call, 5, ["tgmm"])["tgmm"]
    call_ms = cuda_ms(call, iters=5)
    plain_ms = cuda_ms(lambda: gm.tgmm_reference(lhs, dy, sizes, g, bf),
                       iters=2, warmup=1)
    fma_lhs = torch.empty(m, k + 1, dtype=bf, device="cuda")[:, :k]
    fma_lhs.copy_(lhs)
    check(gm._tgmm_plan(fma_lhs, dy, bf) == "fma", "tgmm timing: FMA plan")
    fma_ms = queued_ms(
        torch, lambda: gm.tgmm(fma_lhs, dy, sizes, g, bf), 3)
    # the two bodies on the same values, fp32 out: the same products
    # summed in another order, and dy split in one of them
    bodies_rel_l2 = rel_l2(gm.tgmm(lhs, dy, sizes, g, torch.float32),
                           gm.tgmm(fma_lhs, dy, sizes, g, torch.float32))
    check(bodies_rel_l2 <= GMM_REL_L2["fp32"], f"tgmm {shape}: split vs FMA "
          f"body rel L2 {bodies_rel_l2}")
    row = dict(kernel="tgmm", shape=f"train-{shape}", M=m, K=k, N=n, G=g,
               rows=int(sizes.sum()), dtype="bf16 lhs, fp32 dy, bf16 out",
               body=gm._tgmm_plan(lhs, dy, bf), ms=ms, profiler_ms=profiler_ms,
               call_ms=call_ms, plain_ms=plain_ms, fma_ms=fma_ms,
               split_vs_fma_rel_l2=bodies_rel_l2, library_ms=None,
               library_note="no PyTorch call takes fp32 dy against bf16 "
               "lhs (torch._grouped_mm is bf16 only)",
               modelled_chunk_spread=modelled_chunk_spread(
                   sizes, k, n,
                   torch.cuda.get_device_properties(0).multi_processor_count),
               **tgmm_bound(m, k, n, sizes, 2, 4, 2, "float32"))
    row["bound_tc_ms"] = tc_bound(row["bytes"], row["flops"])
    row["share_of_bound"] = row["bound_ms"] / ms
    row["share_of_tc_bound"] = row["bound_tc_ms"] / ms
    fn = getattr(torch, "_grouped_mm", None)
    if fn is not None:      # a control: the all-bf16 variant
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        dyb = dy.to(bf)
        try:
            row["library_bf16_dy_ms"] = queued_ms(
                torch, lambda: fn(lhs.t(), dyb, offs=offs), 5)
        except RuntimeError as exc:
            row["library_bf16_dy_note"] = str(exc).splitlines()[0][:120]
    log(phase="grouped_timing", **row)
    del fma_lhs
    return row


# ---------------------------------------------------------------------------
# phase 11: serving qwen3-30b-a3b
# ---------------------------------------------------------------------------

MOE_LOGIT_REL_L2_BF16 = 1e-1   # as phase 7: bf16 rounding through 48 layers


def serve_specs(np, vocab: int) -> list:
    """Phase 7's traffic: prompts of 17, 2000 and six seeded lengths in
    [17, 2000], 32 new tokens, 6 greedy and 2 at temperature 0.8 / top-p
    0.9."""
    rng = np.random.default_rng(SEED)
    lens = [17, 2000] + [int(x) for x in rng.integers(17, 2001, 6)]
    return [dict(prompt_ids=[int(x) for x in rng.integers(0, vocab, n)],
                 max_new_tokens=32, seed=i,
                 **({"temperature": 0.8, "top_p": 0.9} if i >= 6 else {}))
            for i, n in enumerate(lens)]


def recording_engine(logits: dict):
    """A ServeEngine that keeps each request's first-token logits (what
    the last prefill forward produced) in ``logits``."""
    from distributed_training_guide_tpu_torch.serve import ServeEngine

    class Recording(ServeEngine):
        def _on_prefill_complete(self, adm, logit):
            logits[adm.request.request_id] = logit.float()
            return super()._on_prefill_complete(adm, logit)

    return Recording


def phase_moe_serve(torch, card: str) -> dict:
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model, moe
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.serve import (
        Request, ServeEngine, generate_many, throughput_stats)

    t0 = time.perf_counter()
    bundle = get_model("qwen3-30b-a3b", dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16)
    cfg = bundle.config
    params = bundle.init(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    layers = cfg.num_layers
    log(phase="moe_serve", model="qwen3-30b-a3b", params=bundle.num_params(),
        active_params=bundle.num_active_params(), layers=layers,
        dtype="bf16", init_s=time.perf_counter() - t0,
        params_gib=torch.cuda.memory_allocated() / 2 ** 30)
    specs = serve_specs(np, cfg.vocab_size)
    common = dict(n_slots=8, page_size=16, max_len=4096)
    results, first = {}, {}
    gm.GMM_LAUNCHES = pd.LAUNCHES = 0         # the main path starts here
    reset_moe_counts()
    copies = fa.ALIGN_COPIES
    for mode, chunk in (("bucketed", None), ("chunked", 256)):
        logits: dict = {}
        eng = recording_engine(logits)(bundle, params, prefill_chunk=chunk,
                                       **common)
        torch.cuda.reset_peak_memory_stats()
        k5, k4 = gm.GMM_LAUNCHES, pd.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = generate_many(eng, [Request(**r) for r in specs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k5, k4 = gm.GMM_LAUNCHES - k5, pd.LAUNCHES - k4
        for r in res:
            check(r.finish_reason == "length" and len(r.generated_ids) == 32,
                  f"moe {mode}: request {r.request_id} ended "
                  f"{r.finish_reason} after {len(r.generated_ids)} tokens")
            check(all(0 <= x < cfg.vocab_size for x in r.generated_ids),
                  f"moe {mode}: token id out of range")
        forwards = eng.decode_steps + eng.programs.prefill_calls
        check(k5 == 3 * layers * forwards and eng.decode_steps > 0,
              f"moe {mode}: {k5} K5 launches for {forwards} forwards "
              f"(want {3 * layers} each)")
        want_k4 = layers * (eng.decode_steps
                            + (eng.programs.prefill_calls if chunk else 0))
        check(k4 == want_k4, f"moe {mode}: {k4} K4 launches, want {want_k4}")
        stats = throughput_stats(res, wall, eng)
        results[mode] = dict(res=res, k5=k5, k4=k4)
        first[mode] = logits[res[1].request_id]
        log(phase="moe_serve", mode=mode, card=card, wall_s=wall,
            tokens_per_s=stats["tokens_per_s"],
            ttft_s_p50=stats["ttft_s_p50"],
            latency_s_p50=stats["latency_s_p50"],
            itl_s_avg=eng.stats()["itl_s_avg"],
            decode_steps=eng.decode_steps,
            prefill_forwards=eng.programs.prefill_calls,
            k5_launches=k5, k5_per_forward=k5 / forwards, k4_launches=k4,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del eng
        torch.cuda.empty_cache()
    main_path = (gm.GMM_LAUNCHES, pd.LAUNCHES)  # ... and ends here
    bodies = check_hopper_path("moe serve", copies)
    check(bodies["grouped_matmul"]["wgmma"] == main_path[0],
          f"moe serve: K5 launches by body {bodies['grouped_matmul']}")
    log(phase="moe_serve", launches_by_body=bodies)

    alone = generate_many(ServeEngine(bundle, params, **common),
                          [Request(**specs[0])])[0]
    check(alone.token_ids == results["bucketed"]["res"][0].token_ids,
          "moe greedy request 0: alone and co-batched tokens differ")
    agree = sum(a.token_ids == b.token_ids
                for a, b in zip(results["bucketed"]["res"],
                                results["chunked"]["res"]))
    log(phase="moe_serve", greedy_alone_equals_cobatched=True,
        requests_identical_bucketed_vs_chunked=agree, of=len(specs))
    torch.cuda.empty_cache()

    # the 2000-token prompt's first-token logits against a plain prefill
    # through the plain grouped matmul and the einsum attention
    ids = torch.tensor([specs[1]["prompt_ids"]], device="cuda")
    cache = moe.init_cache(cfg, 1, ids.shape[1], device="cuda")
    before = gm.GMM_LAUNCHES
    ref = moe.prefill(cfg, params, ids, cache, gmm_impl="scan")[0][0].float()
    check(gm.GMM_LAUNCHES == before, "the plain prefill launched K5")
    del cache
    for mode, got in first.items():
        check(bool(torch.isfinite(got).all()) and got.shape == (
            cfg.vocab_size,), f"moe {mode} first-token logits")
        rel = ((got - ref).norm() / ref.norm()).item()
        log(phase="moe_serve", check=f"first-token logits, {mode} vs plain "
            f"prefill (plain grouped matmul), bf16 full depth",
            prompt_tokens=ids.shape[1], rel_l2=rel,
            bound=MOE_LOGIT_REL_L2_BF16,
            max_abs=(got - ref).abs().max().item(),
            argmax_equal=bool(got.argmax() == ref.argmax()))
        check(rel <= MOE_LOGIT_REL_L2_BF16, f"moe {mode} first-token logits "
              f"rel L2 {rel} > {MOE_LOGIT_REL_L2_BF16}")
    del results, ref, first
    torch.cuda.empty_cache()
    profile = profile_decode(torch, bundle, params, specs)
    log(phase="moe_serve", profile="decode step, bucketed engine, 8 slots",
        card=card, **profile)
    del params
    torch.cuda.empty_cache()
    check_moe_fp32_chunk_path(torch, specs[1]["prompt_ids"])
    return dict(launches=main_path[0], k4_launches=main_path[1],
                per_forward=3 * layers)


def check_moe_fp32_chunk_path(torch, prompt) -> None:
    """qwen3-30b-a3b at full width cut to 2 layers, fp32: the chunked
    engine's first-token logits (K4 and K5 in every chunk) against the
    plain prefill through the plain grouped matmul."""
    from distributed_training_guide_tpu_torch.models import get_model, moe
    from distributed_training_guide_tpu_torch.serve import (Request,
                                                            generate_many)

    bundle = get_model("qwen3-30b-a3b", dtype=torch.float32,
                       param_dtype=torch.float32, num_layers=2)
    params = bundle.init(bundle.config, SEED + 1, device="cuda")
    logits: dict = {}
    eng = recording_engine(logits)(bundle, params, n_slots=1, page_size=16,
                                   max_len=4096, prefill_chunk=256)
    rid = generate_many(eng, [Request(prompt_ids=prompt,
                                      max_new_tokens=1)])[0].request_id
    ids = torch.tensor([prompt], device="cuda")
    cache = moe.init_cache(bundle.config, 1, ids.shape[1], device="cuda")
    ref = moe.prefill(bundle.config, params, ids, cache,
                      gmm_impl="scan")[0][0].float()
    got = logits[rid]
    rel = ((got - ref).norm() / ref.norm()).item()
    log(phase="moe_serve", check="first-token logits, chunked vs plain "
        "prefill, fp32, full width, 2 layers", prompt_tokens=len(prompt),
        rel_l2=rel, bound=LOGIT_REL_L2_FP32,
        max_abs=(got - ref).abs().max().item(),
        argmax_equal=bool(got.argmax() == ref.argmax()))
    check(bool(torch.isfinite(got).all()), "moe fp32 logits not finite")
    check(rel <= LOGIT_REL_L2_FP32, f"moe fp32 chunked logits rel L2 {rel} "
          f"> {LOGIT_REL_L2_FP32}")
    del eng, params, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: chapter 10's training loop on qwen3-30b-a3b, 4 layers
# ---------------------------------------------------------------------------

MOE_TRAIN_LAYERS = 4
MOE_TRAIN_STEPS = 6
MOE_DENSE_STEPS = 2
MOE_TRAIN_ARGS = ["-m", "qwen3-30b-a3b", "-d", "synthetic:400000", "-s",
                  "2048", "-b", "2", "--lr", "3e-4", "--seed", str(SEED)]
# one fp32 step through the kernels against one through the plain grouped
# matmul, same params and batch: only the summation order differs
MOE_TRAIN_FP32_REL = 1e-5


def moe_counts() -> dict:
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    return {**flash_counts(), "grouped_matmul": gm.GMM_LAUNCHES,
            "tgmm": gm.TGMM_LAUNCHES}


def reset_moe_counts() -> None:
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm

    reset_flash_counts()
    gm.GMM_LAUNCHES = gm.TGMM_LAUNCHES = 0
    gm.GMM_BODY_LAUNCHES.update({k: 0 for k in gm.GMM_BODY_LAUNCHES})
    gm.TGMM_BODY_LAUNCHES.update({k: 0 for k in gm.TGMM_BODY_LAUNCHES})


def phase_moe_train(torch, card: str) -> dict:
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm
    from distributed_training_guide_tpu_torch.train import cli

    layers = MOE_TRAIN_LAYERS
    over = {"num_layers": layers}
    args = cli.get_parser().parse_args(
        MOE_TRAIN_ARGS + ["--moe-dispatch", "ragged", "--max-steps",
                          str(MOE_TRAIN_STEPS), "--log-freq", "2"])
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    reset_moe_counts()                        # the main path starts here
    copies = fa.ALIGN_COPIES
    t0 = time.perf_counter()
    out = cli.run_training(args, model_overrides=over)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = moe_counts()                   # ... and ends here
    bodies = check_hopper_path("moe train", copies)
    tgmm_bodies = dict(gm.TGMM_BODY_LAUNCHES)
    per_step = {"flash_fwd": layers, "flash_dq": layers, "flash_dkv": layers,
                "grouped_matmul": 6 * layers, "tgmm": 3 * layers}
    want = {k: v * MOE_TRAIN_STEPS for k, v in per_step.items()}
    check(launches == want, f"moe train: launches {launches}, want {want}")
    # the forward's three products per layer run the Hopper body, the
    # backward's fp32-dy d_lhs the split body
    half = 3 * layers * MOE_TRAIN_STEPS
    check(bodies["grouped_matmul"] == {"fma": 0, "wmma": 0, "wgmma": half,
                                       "split": half},
          f"moe train: K5 launches by body {bodies['grouped_matmul']}")
    # every d_rhs (bf16 expert inputs against fp32 dy) the split body
    check(tgmm_bodies == {"fma": 0, "split": half},
          f"moe train: K6 launches by body {tgmm_bodies}")
    infos = out["infos"]
    losses = [i["running_loss"] for i in infos]
    check(len(infos) == MOE_TRAIN_STEPS // 2 and all(
        map(math.isfinite, losses)), f"moe train: losses {losses}")
    check(losses[-1] < losses[0], f"moe train: loss did not fall: {losses}")
    check(all(i["moe_dropped_frac"] == 0.0 for i in infos),
          "moe train: ragged dispatch dropped pairs")
    for info in infos:
        log(phase="moe_train", model="qwen3-30b-a3b", layers=layers,
            card=card, **{k: info[k] for k in (
                "global_step", "running_loss", "grad_norm",
                "moe_dropped_frac", "tokens_per_s", "mfu", "time/step",
                "time/data", "peak_alloc_gb")})
    bundle = get_model("qwen3-30b-a3b", moe_dispatch="ragged", **over)
    log(phase="moe_train", steps=MOE_TRAIN_STEPS, wall_s=wall,
        launches_per_step={k: v / MOE_TRAIN_STEPS
                           for k, v in launches.items()},
        launches_by_body={**bodies, "tgmm": tgmm_bodies},
        batch=2, seq=2048, params=bundle.num_params(),
        active_params=bundle.num_active_params())
    state = out["state"]
    profile = profile_train_step(torch, state, bundle, 2, 2048)
    log(phase="moe_train", profile="one step, qwen3-30b-a3b 4 layers, B 2, "
        "S 2048", card=card, **profile)
    del out, state
    torch.cuda.empty_cache()
    check_moe_fp32_train_step(torch)

    args = cli.get_parser().parse_args(
        MOE_TRAIN_ARGS + ["--moe-dispatch", "dense", "--max-steps",
                          str(MOE_DENSE_STEPS), "--log-freq", "1"])
    reset_moe_counts()
    dense = cli.run_training(args, model_overrides=over)
    dense_counts = moe_counts()
    check(dense_counts["grouped_matmul"] == 0 and dense_counts["tgmm"] == 0,
          f"dense dispatch launched K5 / K6: {dense_counts}")
    dense_losses = [i["running_loss"] for i in dense["infos"]]
    check(all(map(math.isfinite, dense_losses)),
          f"dense losses {dense_losses}")
    log(phase="moe_train", dispatch="dense", steps=MOE_DENSE_STEPS,
        launches=dense_counts, losses=dense_losses,
        moe_dropped_frac=[i["moe_dropped_frac"] for i in dense["infos"]],
        tokens_per_s=dense["last_info"]["tokens_per_s"],
        peak_alloc_gb=dense["last_info"]["peak_alloc_gb"])
    del dense
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step, "infos": infos,
            "profile": profile, "launches_by_body": bodies["grouped_matmul"],
            "tgmm_launches_by_body": tgmm_bodies}


def check_moe_fp32_train_step(torch) -> None:
    """qwen3-30b-a3b at full width cut to 2 layers, fp32 compute, ragged
    dispatch: the loss and global grad norm of one batch (B 1, S 512)
    through K5 / K6 against the same through the plain grouped matmul
    (whose autograd keeps a masked copy of the rows per expert, hence the
    short sequence)."""
    from distributed_training_guide_tpu_torch.models import get_model, moe
    from distributed_training_guide_tpu_torch.ops import grouped_matmul as gm
    from distributed_training_guide_tpu_torch.ops.cross_entropy import (
        causal_lm_loss)

    bundle = get_model("qwen3-30b-a3b", dtype=torch.float32, num_layers=2,
                       moe_dispatch="ragged")
    cfg = bundle.config
    params = bundle.init(cfg, SEED + 6, device="cuda")
    leaves = []

    def collect(tree):
        for v in tree.values():
            if isinstance(v, dict):
                collect(v)
            else:
                v.requires_grad_(True)
                leaves.append(v)

    collect(params)
    batch = _train_batch(torch, cfg.vocab_size, 1, 512, SEED + 7)
    got = {}
    for impl in ("auto", "scan"):
        reset_moe_counts()
        logits, aux = moe.apply_with_aux(cfg, params, batch["input_ids"],
                                         gmm_impl=impl)
        loss = (causal_lm_loss(logits, batch["labels"])
                + cfg.router_aux_coef * aux)
        del logits
        loss.backward()
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            [p.grad for p in leaves])))
        counts = moe_counts()
        want = (12, 6) if impl == "auto" else (0, 0)
        check((counts["grouped_matmul"], counts["tgmm"]) == want,
              f"fp32 step ({impl}): K5 / K6 launches {counts}")
        check(gm.TGMM_BODY_LAUNCHES == {"fma": want[1], "split": 0},
              f"fp32 step ({impl}): K6 by body {gm.TGMM_BODY_LAUNCHES}")
        got[impl] = {"loss": loss.item(), "grad_norm": norm.item()}
        for p in leaves:
            p.grad = None
        torch.cuda.empty_cache()
    rel = {k: abs(got["auto"][k] - got["scan"][k]) / abs(got["scan"][k])
           for k in ("loss", "grad_norm")}
    log(phase="moe_train", check="one step, kernels vs plain grouped "
        "matmul, fp32, full width, 2 layers, B 1, S 512",
        kernels=got["auto"], plain=got["scan"], rel=rel,
        bound=MOE_TRAIN_FP32_REL)
    for k, r in rel.items():
        check(r <= MOE_TRAIN_FP32_REL, f"moe fp32 step {k} rel {r} > "
              f"{MOE_TRAIN_FP32_REL}")
    reset_moe_counts()
    del params, leaves
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the block-dequant matmul (K7) against its plain version
# ---------------------------------------------------------------------------

# relative L2 error against the plain version: an fp32 output is the same
# fp32 products summed in another order; a bf16 output rounds that fp32
# sum once (half an ulp, 2**-9 relative)
QMM_REL_L2 = {"fp32": 1e-5, "bf16": 1e-2}
# llama-3.1-8b's widths: wq / wo, wk / wv, gate / up, down, the head
QMM_SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024), "gate": (4096, 14336),
              "down": (14336, 4096), "head": (4096, 128256)}


def qmm_weight(torch, gen, k, n, bs):
    from distributed_training_guide_tpu_torch.train.precision import (
        quantize_blockwise)

    w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
    return quantize_blockwise(w, block_size=bs)


def qmm_cases():
    """(shape name, K, N, bs, M list, x dtypes): every width at the engine's
    block size over decode and prefill rows (the head only at the rows the
    engine gives it), bs 128 and 24, a short last block with N % 4 != 0."""
    rows = (1, 8, 37, 256, 2048)
    out = [(name, k, n, 32, rows if name != "head" else (1, 8, 37),
            ("bf16", "fp32") if name in ("wq", "down", "head") else ("bf16",))
           for name, (k, n) in QMM_SHAPES.items()]
    out += [("gate-bs128", 4096, 14336, 128, (8, 256), ("bf16",)),
            ("wq-bs24", 4096, 4096, 24, (8, 37), ("bf16", "fp32")),
            ("tail", 4096, 4096 + 17, 32, (8, 256), ("bf16", "fp32"))]
    return out


def phase_qmm(torch) -> float:
    """Every case through K7 in both output dtypes, each launch through the
    body that ``_qmm_plan`` names and both bodies reached; rows of M = 37
    and M = 2048 products against the M = 1 product of the same row,
    bitwise. Returns the worst fp32-output max abs error."""
    from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    count = qm.LAUNCHES
    worst, worst_rel, n_checks = 0.0, {"fp32": 0.0, "bf16": 0.0}, 0
    bodies_seen = set()
    for name, k, n, bs, rows, xdts in qmm_cases():
        qt = qmm_weight(torch, gen, k, n, bs)
        errs = {}
        for xdt in xdts:
            dt = torch.float32 if xdt == "fp32" else torch.bfloat16
            for m in rows:
                x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
                want = qm.quantized_matmul_reference(x, qt.q, qt.scale)
                plan = qm._qmm_plan(x, qt.q, qt.scale)
                bodies_seen.add(plan)
                errs[f"body-x{xdt}"] = plan
                for odt in ("fp32", "bf16"):
                    out_dtype = (torch.float32 if odt == "fp32"
                                 else torch.bfloat16)
                    before = qm.LAUNCHES
                    by_body = dict(qm.BODY_LAUNCHES)
                    got = qm.dequant_matmul(x, qt.q, qt.scale, out_dtype)
                    torch.cuda.synchronize()
                    check(qm.LAUNCHES == before + 1, f"qmm {name}: no launch")
                    check(qm.BODY_LAUNCHES[plan] == by_body[plan] + 1,
                          f"qmm {name}: the launch did not run the body "
                          f"{plan} that _qmm_plan names")
                    check(got.shape == (m, n) and got.dtype == out_dtype,
                          f"qmm {name}: {got.shape} {got.dtype}")
                    check(bool(torch.isfinite(got.float()).all()),
                          f"qmm {name}: non-finite kernel output")
                    err = rel_l2(got, want)
                    check(err <= QMM_REL_L2[odt], f"qmm {name} M {m} x {xdt} "
                          f"out {odt}: rel L2 {err} > {QMM_REL_L2[odt]}")
                    errs[f"M{m}-x{xdt}-out{odt}"] = err
                    worst_rel[odt] = max(worst_rel[odt], err)
                    if odt == "fp32":
                        worst = max(worst, (got - want).abs().max().item())
                    n_checks += 1
                    del got
                if xdt == "bf16" and m in (37, 2048):
                    full = qm.dequant_matmul(x, qt.q, qt.scale)
                    for r in (0, m // 2, m - 1):
                        one = qm.dequant_matmul(x[r:r + 1].contiguous(), qt.q,
                                                qt.scale)
                        check(torch.equal(one[0], full[r]), f"qmm {name}: "
                              f"row {r} of M {m} differs from its M = 1 "
                              f"product")
                    errs[f"M{m}-rows-bitwise-as-M1"] = True
                    del full, one
                del x, want
        log(phase="qmm", case=name, K=k, N=n, bs=bs,
            splits={b: qm.kernel_splits(k, n, b) for b in qm.BODY_LAUNCHES},
            metric="rel_l2", bound=QMM_REL_L2, **errs)
        del qt
        torch.cuda.empty_cache()
    check(bodies_seen == set(qm.BODY_LAUNCHES), f"qmm: the cases ran the "
          f"bodies {bodies_seen}, not each of {set(qm.BODY_LAUNCHES)}")
    qm.LAUNCHES = count               # checking launches are not main path
    log(phase="qmm", checks=n_checks, worst_fp32_max_abs=worst,
        worst_rel_l2=worst_rel)
    return worst


# ---------------------------------------------------------------------------
# phase 14: K7 timing
# ---------------------------------------------------------------------------

def qmm_bound(m, k, n, bs, x_b, out_b) -> dict:
    """q and its fp32 scales read once, x read once, out written once;
    2 M K N fp32 operations."""
    nb = -(-n // bs)
    return _bound(k * n + k * nb * 4 + m * k * x_b + m * n * out_b,
                  2 * m * k * n, "float32")


def phase_qmm_timing(torch) -> dict:
    """K7 at the main path's shapes: a gate/up projection of a decode step
    (M 8) and of a 256-token chunk, bf16 x and output; the untied head of
    a decode step (fp32 logits). Copies of the weight rotate so that the
    weight comes from device memory, as it does in a forward, where each
    layer has its own. Device time ("ms") by ``queued_ms``, CUDA events
    around back-to-back calls beside it ("call_ms"); the fp32 bound and
    the tensor-core body's two-pass bound ("bound_tc_ms"). The control is
    the bf16 ``torch.mm`` of the same x against the unquantized bf16
    weight, timed alike: a yardstick of the unquantized path, which the
    port does not call for int8 weights; no PyTorch call computes K7's
    function (``library_ms`` null)."""
    from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    count = qm.LAUNCHES
    out = {}
    for name, m, (k, n), out_dtype, copies in (
            ("gate-decode", 8, QMM_SHAPES["gate"], torch.bfloat16, 4),
            ("head-decode", 8, QMM_SHAPES["head"], torch.float32, 1),
            ("gate-chunk", 256, QMM_SHAPES["gate"], torch.bfloat16, 4)):
        ws = [(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
              .to(torch.bfloat16) for _ in range(copies)]
        qts = [qmm_weight(torch, gen, k, n, 32) for _ in range(copies)]
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        it = {"i": 0}

        def nxt(seq):
            it["i"] = (it["i"] + 1) % len(seq)
            return seq[it["i"]]

        def kern():
            qt = nxt(qts)
            return qm.dequant_matmul(x, qt.q, qt.scale, out_dtype)

        iters = 50 if m <= 8 else 10
        ms = queued_ms(torch, kern, iters)
        call_ms = cuda_ms(kern, iters=iters)
        plain_ms = cuda_ms(lambda: qm.quantized_matmul_reference(
            x, qts[0].q, qts[0].scale).to(out_dtype), iters=3, warmup=1)
        control = lambda: x @ nxt(ws)   # noqa: E731
        control_ms = queued_ms(torch, control, iters)
        control_call_ms = cuda_ms(control, iters=iters)
        body = qm._qmm_plan(x, qts[0].q, qts[0].scale)
        row = dict(kernel="quantized_matmul", shape=name, M=m, K=k, N=n,
                   bs=32, dtype="bf16 x, " + ("bf16" if out_dtype ==
                                              torch.bfloat16 else "fp32")
                   + " out", body=body, splits=qm.kernel_splits(k, n, body),
                   ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   library_ms=None,
                   library_note="no PyTorch call computes a block-dequant "
                   "matmul with per-(row, 32-column block) scales",
                   control_ms=control_ms, control_call_ms=control_call_ms,
                   control_note="bf16 torch.mm on the unquantized weight "
                   "(cuBLAS), a control the port never calls",
                   **qmm_bound(m, k, n, 32, 2, out_dtype.itemsize))
        row["bound_tc_ms"] = tc_bound(row["bytes"], row["flops"])
        row["share_of_tc_bound"] = row["bound_tc_ms"] / ms
        row["share_of_bound"] = row["bound_ms"] / ms
        out[name] = row
        log(phase="qmm_timing", **row)
        del ws, qts, x
        torch.cuda.empty_cache()
    qm.LAUNCHES = count
    return out


# ---------------------------------------------------------------------------
# phase 15: serving llama-3.1-8b with int8 weights
# ---------------------------------------------------------------------------

def snapped(torch, stored, dtype):
    """Each quantized leaf replaced by its dequantized copy in ``dtype``."""
    from distributed_training_guide_tpu_torch.train.precision import (
        Quantized, dequantize_blockwise)

    if isinstance(stored, dict):
        return {k: snapped(torch, v, dtype) for k, v in stored.items()}
    if not isinstance(stored, Quantized):
        return stored
    if stored.q.ndim < 3:
        return dequantize_blockwise(stored, dtype=dtype)
    out = torch.empty(stored.q.shape, dtype=dtype, device=stored.q.device)
    for i in range(out.shape[0]):             # one layer's fp32 transient
        out[i] = dequantize_blockwise(
            Quantized(q=stored.q[i], scale=stored.scale[i]), dtype=dtype)
    return out


def phase_int8_serve(torch, card: str) -> dict:
    import numpy as np

    from distributed_training_guide_tpu_torch.models import get_model, llama
    from distributed_training_guide_tpu_torch.ops import paged_decode as pd
    from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm
    from distributed_training_guide_tpu_torch.serve import (
        ModelPrograms, Request, ServeEngine, generate_many, throughput_stats)
    from distributed_training_guide_tpu_torch.serve.engine import (
        build_weight_report)
    from distributed_training_guide_tpu_torch.serve.weights import (
        params_nbytes)

    t0 = time.perf_counter()
    bundle = get_model("llama-3.1-8b", dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16)
    cfg = bundle.config
    layers = cfg.num_layers
    params = bundle.init(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    per_forward = 7 * layers + 1
    # the weights the engine keeps: the stored tree's own allocations
    # (norms are shared with the bf16 params), against the report
    base = torch.cuda.memory_allocated()
    programs = ModelPrograms(bundle, params, weight_dtype="int8")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    stored = programs.params
    leaves = []

    def collect(tree):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            if isinstance(v, (dict, tuple)):
                collect(v)
            else:
                leaves.append(v)

    collect(stored)
    storage = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
               for t in leaves}
    shared = sum(t.element_size() * t.numel() for t in leaves
                 if t.dtype != torch.int8 and t.dtype != torch.float32)
    report = build_weight_report(programs)
    wbytes = report["weight_bytes"]
    check(sum(storage.values()) == wbytes == params_nbytes(stored),
          f"int8: weight_report {wbytes} B, resident storages "
          f"{sum(storage.values())} B")
    # the caching allocator rounds each allocation up to 512 bytes
    check(abs(grown - (wbytes - shared)) <= 512 * len(leaves) + 2 ** 20,
          f"int8: the stored weights allocated {grown} B, the report says "
          f"{wbytes} B ({shared} B of norms shared)")
    log(phase="int8_serve", model="llama-3.1-8b", layers=layers,
        init_and_quantize_s=time.perf_counter() - t0, weight_report=report,
        allocated_by_store=grown, norm_bytes_shared=shared)
    del programs
    specs = serve_specs(np, cfg.vocab_size)
    common = dict(n_slots=8, page_size=16, max_len=4096, weight_dtype="int8")
    results, first = {}, {}
    qm.LAUNCHES = pd.LAUNCHES = 0             # the main path starts here
    qm.BODY_LAUNCHES.update({b: 0 for b in qm.BODY_LAUNCHES})
    for mode, chunk in (("bucketed", None), ("chunked", 256)):
        logits: dict = {}
        eng = recording_engine(logits)(bundle, params, prefill_chunk=chunk,
                                       **common)
        torch.cuda.reset_peak_memory_stats()
        k7, k4 = qm.LAUNCHES, pd.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = generate_many(eng, [Request(**r) for r in specs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k7, k4 = qm.LAUNCHES - k7, pd.LAUNCHES - k4
        for r in res:
            check(r.finish_reason == "length" and len(r.generated_ids) == 32,
                  f"int8 {mode}: request {r.request_id} ended "
                  f"{r.finish_reason} after {len(r.generated_ids)} tokens")
            check(all(0 <= x < cfg.vocab_size for x in r.generated_ids),
                  f"int8 {mode}: token id out of range")
        forwards = eng.decode_steps + eng.programs.prefill_calls
        check(k7 == per_forward * forwards and eng.decode_steps > 0,
              f"int8 {mode}: {k7} K7 launches for {forwards} forwards "
              f"(want {per_forward} each)")
        want_k4 = layers * (eng.decode_steps
                            + (eng.programs.prefill_calls if chunk else 0))
        check(k4 == want_k4, f"int8 {mode}: {k4} K4 launches, want {want_k4}")
        check(eng.weight_report() == report, f"int8 {mode}: weight report")
        stats = throughput_stats(res, wall, eng)
        results[mode] = dict(res=res, k7=k7, k4=k4)
        first[mode] = logits[res[1].request_id]
        log(phase="int8_serve", mode=mode, card=card, wall_s=wall,
            tokens_per_s=stats["tokens_per_s"],
            ttft_s_p50=stats["ttft_s_p50"],
            latency_s_p50=stats["latency_s_p50"],
            itl_s_avg=eng.stats()["itl_s_avg"],
            decode_steps=eng.decode_steps,
            prefill_forwards=eng.programs.prefill_calls,
            k7_launches=k7, k7_per_forward=k7 / forwards, k4_launches=k4,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del eng
        torch.cuda.empty_cache()
    main_path = (qm.LAUNCHES, pd.LAUNCHES)    # ... and ends here
    k7_bodies = dict(qm.BODY_LAUNCHES)
    # bf16 x at every product, every operand on 16 bytes: the tensor-core
    # body carried every K7 launch of the path
    check(k7_bodies == {"fma": 0, "wgmma": main_path[0]}, f"int8: K7 "
          f"launches by body {k7_bodies}, {main_path[0]} in all")
    log(phase="int8_serve", k7_launches_by_body=k7_bodies)

    alone = generate_many(ServeEngine(bundle, params, **common),
                          [Request(**specs[0])])[0]
    check(alone.token_ids == results["bucketed"]["res"][0].token_ids,
          "int8 greedy request 0: alone and co-batched tokens differ")
    agree = sum(a.token_ids == b.token_ids
                for a, b in zip(results["bucketed"]["res"],
                                results["chunked"]["res"]))
    log(phase="int8_serve", greedy_alone_equals_cobatched=True,
        requests_identical_bucketed_vs_chunked=agree, of=len(specs))
    del results
    torch.cuda.empty_cache()

    # the 2000-token prompt's first-token logits against the plain prefill
    # over the snapped params (no K7), and (ungated) against bf16 weights
    ids = torch.tensor([specs[1]["prompt_ids"]], device="cuda")

    def plain_prefill(p):
        cache = llama.init_cache(cfg, 1, ids.shape[1], device="cuda")
        return llama.prefill(cfg, p, ids, cache)[0][0].float()

    before = qm.LAUNCHES
    snap = snapped(torch, stored, cfg.dtype)
    ref = plain_prefill(snap)
    del snap
    check(qm.LAUNCHES == before, "the snapped plain prefill launched K7")
    bf16_ref = plain_prefill(params)
    for mode, got in first.items():
        check(bool(torch.isfinite(got).all()) and got.shape == (
            cfg.vocab_size,), f"int8 {mode} first-token logits")
        rel = rel_l2(got, ref)
        log(phase="int8_serve", check=f"first-token logits, {mode} vs plain "
            f"prefill over the snapped params, bf16 full depth",
            prompt_tokens=ids.shape[1], rel_l2=rel, bound=LOGIT_REL_L2_BF16,
            max_abs=(got - ref).abs().max().item(),
            argmax_equal=bool(got.argmax() == ref.argmax()),
            int8_vs_bf16_weights_rel_l2=rel_l2(got, bf16_ref),
            int8_vs_bf16_weights_argmax_equal=bool(
                got.argmax() == bf16_ref.argmax()))
        check(rel <= LOGIT_REL_L2_BF16, f"int8 {mode} first-token logits "
              f"rel L2 {rel} > {LOGIT_REL_L2_BF16}")
    del ref, bf16_ref, first, stored
    torch.cuda.empty_cache()
    profile = profile_decode(torch, bundle, params, specs,
                             weight_dtype="int8")
    log(phase="int8_serve", profile="decode step, bucketed engine, 8 slots, "
        "int8 weights", card=card, **profile)
    del params
    torch.cuda.empty_cache()
    prompt = specs[1]["prompt_ids"]
    check_int8_fp32_path(torch, "llama-3.1-8b", prompt)
    check_int8_fp32_path(torch, "llama-3.2-1b", prompt)
    return dict(launches=main_path[0], k4_launches=main_path[1],
                per_forward=per_forward, profile=profile,
                launches_by_body=k7_bodies)


def check_int8_fp32_path(torch, model: str, prompt) -> None:
    """A model at full width cut to 2 layers, fp32, int8 weights: the
    engine's first-token logits, bucketed (K7 in every projection) and
    chunked (K7 and K4), against the plain prefill over the snapped
    params. In fp32 only the summation order differs. llama-3.1-8b's head
    is a standard-form product through K7; llama-3.2-1b's tied head runs
    the plain transpose form on the card."""
    from distributed_training_guide_tpu_torch.models import get_model, llama
    from distributed_training_guide_tpu_torch.ops import quantized_matmul as qm
    from distributed_training_guide_tpu_torch.serve import (Request,
                                                            generate_many)

    bundle = get_model(model, dtype=torch.float32, param_dtype=torch.float32,
                       num_layers=2)
    cfg = bundle.config
    params = bundle.init(cfg, SEED + 1, device="cuda")
    per_forward = 7 * 2 + (0 if cfg.tie_word_embeddings else 1)
    logits: dict = {}
    errs = {}
    ref = None
    for mode, chunk in (("bucketed", None), ("chunked", 256)):
        eng = recording_engine(logits)(bundle, params, n_slots=1,
                                       page_size=16, max_len=4096,
                                       prefill_chunk=chunk,
                                       weight_dtype="int8")
        before = qm.LAUNCHES
        rid = generate_many(eng, [Request(prompt_ids=prompt,
                                          max_new_tokens=1)])[0].request_id
        forwards = eng.programs.prefill_calls + eng.decode_steps
        check(qm.LAUNCHES - before == per_forward * forwards,
              f"{model} fp32 int8 {mode}: K7 launches")
        if ref is None:
            ids = torch.tensor([prompt], device="cuda")
            cache = llama.init_cache(cfg, 1, ids.shape[1], device="cuda")
            before = qm.LAUNCHES
            ref = llama.prefill(cfg, snapped(torch, eng.params, torch.float32),
                                ids, cache)[0][0].float()
            check(qm.LAUNCHES == before, "the snapped prefill launched K7")
            del cache
        got = logits[rid]
        check(bool(torch.isfinite(got).all()), f"{model} fp32 int8 logits")
        errs[mode] = rel_l2(got, ref)
        del eng
        torch.cuda.empty_cache()
    log(phase="int8_serve", check=f"first-token logits vs plain prefill over "
        f"the snapped params, fp32, {model} full width, 2 layers, "
        f"{'tied head (plain transpose form)' if cfg.tie_word_embeddings else 'head through K7'}",
        prompt_tokens=len(prompt), rel_l2=errs, bound=LOGIT_REL_L2_FP32)
    for mode, rel in errs.items():
        check(rel <= LOGIT_REL_L2_FP32, f"{model} fp32 int8 {mode} logits "
              f"rel L2 {rel} > {LOGIT_REL_L2_FP32}")
    del params, ref
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 16: chapter 01 — checkpoints and resume, precision policies, remat
# policies, the other optimizers, the NaN drill
# ---------------------------------------------------------------------------

CH01_RESUME_LAYERS = 2      # llama-3.2-1b at full width cut to 2 layers
CH01_PRECISION_STEPS = 4
CH01_REMAT_STEPS = 3
CH01_POLICIES = ("fp32", "bf16-master", "adam8bit", "bf16-master+adam8bit")
# K1 launches per layer per step under each remat policy: the flash forward
# is one custom op, so "attn" / "attn_mlp" keep its (o, lse)
CH01_REMAT_K1 = {"all": 2, "dots": 2, "attn": 1, "attn_mlp": 1}
# the peak must fall by this share of the state bytes a policy saves
CH01_PEAK_SHARE = 0.8
CH01_MOE_LAYERS = 2
CH01_LAUNCHES: dict = {}    # each kernel's launches over phase 16's runs


def ch01_run(torch, extra: list, *, layers=None, env=None, base=None,
             log_freq: int = 1):
    """``run_training`` through the CLI parser on llama-3.2-1b (B 4, S
    2048; ``base`` replaces those arguments), with ``env`` set for the
    run; returns (its output, the K1-K3 launches of the run)."""
    import os

    from distributed_training_guide_tpu_torch.train import cli

    args = cli.get_parser().parse_args(
        (base or TRAIN_ARGS) + ["--log-freq", str(log_freq), *extra])
    reset_moe_counts()                        # each run's path starts here
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        out = cli.run_training(
            args, model_overrides={"num_layers": layers} if layers else None)
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        counts = moe_counts()                 # ... and ends here
        for k, v in counts.items():
            CH01_LAUNCHES[k] = CH01_LAUNCHES.get(k, 0) + v
    return out, counts


def ch01_losses(out) -> dict:
    return {i["global_step"]: i["running_loss"] for i in out["infos"]}


def ch01_rates(out) -> dict:
    """Tokens/s and step ms (host clock), each the mean over the steps
    after the first (which pays the warm-up), and the run's peak."""
    later = out["infos"][1:]
    return {"tokens_per_s": sum(i["tokens_per_s"] for i in later)
            / len(later),
            "time_step_ms": sum(i["time/step"] for i in later) / len(later),
            "peak_alloc_gb": out["last_info"]["peak_alloc_gb"]}


def ch01_free(torch, *outs) -> None:
    import gc

    for out in outs:
        if isinstance(out, dict):
            out.clear()
    gc.collect()
    torch.cuda.empty_cache()


def ch01_restored(torch, exp_dir, layers: int) -> tuple:
    """The newest verifiable checkpoint of ``exp_dir`` read into a fresh
    fp32 state of llama-3.2-1b at ``layers`` layers: (tensors by name,
    host_state)."""
    from distributed_training_guide_tpu_torch.checkpoint import CheckpointIO
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.train.optimizer import (
        adamw_cosine)
    from distributed_training_guide_tpu_torch.train.state import (
        state_tensors)
    from distributed_training_guide_tpu_torch.train.step import Trainer

    trainer = Trainer(bundle=get_model("llama-3.2-1b", num_layers=layers),
                      optimizer=adamw_cosine(3e-4), device="cuda")
    state, host = CheckpointIO(exp_dir).restore(trainer.init_state(SEED + 9))
    return state_tensors(state), host


def ch01_same(torch, a: dict, b: dict) -> list:
    """Names whose tensors differ (bitwise) between two restored states."""
    check(a.keys() == b.keys(), "restored states hold other names")
    return [k for k in a if not torch.equal(a[k], b[k])]


def ch01_resume(torch, root: Path, card: str) -> dict:
    """(a): a straight 6-step run saving every 2 steps (keep 2) against an
    async-saving run and a run killed at step 4 by the crash drill and
    resumed to step 6, at 2 layers."""
    import json
    import shutil

    from distributed_training_guide_tpu_torch.checkpoint import manifest
    from distributed_training_guide_tpu_torch.utils import faults

    layers = CH01_RESUME_LAYERS
    exp = ["--save-dir", str(root), "--ckpt-freq", "2", "--max-steps", "6"]
    straight, counts = ch01_run(torch, ["-e", "A", "--keep-checkpoints",
                                        "2", *exp], layers=layers)
    golden = ch01_losses(straight)
    check(set(golden) == set(range(1, 7)) and all(
        map(math.isfinite, golden.values())), f"resume: losses {golden}")
    check(counts["flash_fwd"] == layers * 6, f"resume: launches {counts}")
    chain = json.loads((root / "A" / "state.json").read_text())["retained"]
    kept = sorted(p.name for p in (root / "A").iterdir() if p.is_dir())
    check(chain == ["checkpoint-6", "checkpoint-4"]
          and kept == ["checkpoint-4", "checkpoint-6"],
          f"retention: chain {chain}, dirs {kept}")
    for name in chain:
        m = manifest.load_manifest(root / "A", name)
        problems = manifest.verify_manifest(root / "A" / name, m)
        check(m is not None and not problems,
              f"manifest of {name}: {problems}")
    sync_saves = straight["checkpoint_saves"]
    ch01_free(torch, straight)

    run, _ = ch01_run(torch, ["-e", "C", "--keep-checkpoints", "3",
                              "--async-checkpoint", *exp], layers=layers)
    check(ch01_losses(run) == golden,
          f"async saves moved the losses: {ch01_losses(run)} vs {golden}")
    async_saves = run["checkpoint_saves"]
    ch01_free(torch, run)
    sync6, host = ch01_restored(torch, root / "A", layers)
    async6, _ = ch01_restored(torch, root / "C", layers)
    diff = ch01_same(torch, sync6, async6)
    check(host["global_step"] == 6 and not diff,
          f"async checkpoint-6 differs from the sync one: {diff[:4]}")
    del sync6, async6
    # the fallback past a corrupted latest checkpoint, in both: A's
    # checkpoint-4 was written synchronously, C's while steps 5 and 6
    # updated the state in place
    victim = faults.corrupt_checkpoint_dir(root / "A" / "checkpoint-6")
    faults.corrupt_checkpoint_dir(root / "C" / "checkpoint-6")
    fallback, host = ch01_restored(torch, root / "A", layers)
    async4, host_c = ch01_restored(torch, root / "C", layers)
    diff = ch01_same(torch, fallback, async4)
    check(host["global_step"] == 4 and host_c["global_step"] == 4
          and not diff, f"fallback / async snapshot: step {host} / "
          f"{host_c}, differing {diff[:4]}")
    del fallback, async4
    ch01_free(torch)
    shutil.rmtree(root / "A")
    shutil.rmtree(root / "C")

    crash = {faults.ENV_CRASH_STEP: "4", faults.ENV_CRASH_MODE: "exc"}
    try:
        ch01_run(torch, ["-e", "B", *exp], layers=layers, env=crash)
        check(False, "the crash drill did not crash")
    except RuntimeError as exc:
        check("injected fault" in str(exc), f"crash drill: {exc}")
    ch01_free(torch)
    resumed, _ = ch01_run(torch, ["-e", "B", *exp], layers=layers)
    got = ch01_losses(resumed)
    check(resumed["resumed"] and got == {5: golden[5], 6: golden[6]},
          f"resume: steps 5-6 {got}, straight {golden}")
    ch01_free(torch, resumed)
    shutil.rmtree(root / "B")
    out = {"losses": golden, "resumed_losses": got,
           "saves_sync": sync_saves, "saves_async": async_saves,
           "corrupted": victim}
    log(phase="chapter01", part="resume", layers=layers, card=card, **out)
    return out


def ch01_state_bytes(out) -> int:
    """Bytes of params, their grads and the optimizer state as stored."""
    from distributed_training_guide_tpu_torch.train.state import (
        named_leaves, state_tensors)

    state = out["state"]
    flat = state_tensors(state)
    grads = sum(p.numel() * p.element_size()
                for _, p in named_leaves(state.params))
    return grads + sum(t.numel() * t.element_size() for k, t in flat.items()
                       if k.startswith(("params/", "opt_state/")))


def ch01_precision(torch, card: str) -> dict:
    """(b): 4 steps at full depth under each policy: finite falling loss,
    16 launches of K1-K3 per step, and the peak against the fp32 run."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    layers, steps = 16, CH01_PRECISION_STEPS
    res = {}
    for policy in CH01_POLICIES:
        copies = fa.ALIGN_COPIES
        out, counts = ch01_run(torch, ["--max-steps", str(steps),
                                       "--precision-policy", policy])
        check_hopper_path(f"precision {policy}", copies)
        want = layers * steps
        check(counts["flash_fwd"] == counts["flash_dq"] == counts[
            "flash_dkv"] == want, f"precision {policy}: launches {counts}")
        losses = ch01_losses(out)
        vals = [losses[s] for s in sorted(losses)]
        check(all(map(math.isfinite, vals)) and vals[-1] < vals[0],
              f"precision {policy}: losses {vals}")
        res[policy] = {"losses": vals, **ch01_rates(out),
                       "state_gb": ch01_state_bytes(out) / 1e9,
                       "launches": counts}
        log(phase="chapter01", part="precision", policy=policy, card=card,
            **res[policy])
        ch01_free(torch, out)
    base = res["fp32"]
    for policy in CH01_POLICIES[1:]:
        saved = base["state_gb"] - res[policy]["state_gb"]
        drop = base["peak_alloc_gb"] - res[policy]["peak_alloc_gb"]
        res[policy]["peak_drop_gb"] = drop
        res[policy]["state_saved_gb"] = saved
        check(drop >= CH01_PEAK_SHARE * saved,
              f"precision {policy}: peak fell {drop:.2f} GB, the state "
              f"saves {saved:.2f} GB")
    log(phase="chapter01", part="precision peaks", card=card,
        **{p: {k: res[p].get(k) for k in ("peak_alloc_gb", "state_gb",
                                          "peak_drop_gb", "state_saved_gb")}
           for p in CH01_POLICIES})
    return res


def ch01_remat(torch, card: str, no_remat_step1: float) -> dict:
    """(c): 3 steps at full depth under each remat policy: K1 per step, the
    step-1 loss bitwise the run's without remat, peaks in order."""
    from distributed_training_guide_tpu_torch.ops import flash_attention as fa

    layers, steps = 16, CH01_REMAT_STEPS
    res = {}
    for policy, k1 in CH01_REMAT_K1.items():
        copies = fa.ALIGN_COPIES
        out, counts = ch01_run(torch, ["--max-steps", str(steps),
                                       "--checkpoint-activations",
                                       "--remat-policy", policy])
        check_hopper_path(f"remat {policy}", copies)
        per_step = {k: counts[k] / steps for k in ("flash_fwd", "flash_dq",
                                                    "flash_dkv")}
        check(per_step == {"flash_fwd": k1 * layers, "flash_dq": layers,
                           "flash_dkv": layers},
              f"remat {policy}: launches per step {per_step}")
        losses = ch01_losses(out)
        check(losses[1] == no_remat_step1, f"remat {policy}: step-1 loss "
              f"{losses[1]!r}, without remat {no_remat_step1!r}")
        res[policy] = {"launches_per_step": per_step,
                       "losses": [losses[s] for s in sorted(losses)],
                       **ch01_rates(out)}
        log(phase="chapter01", part="remat", policy=policy, card=card,
            **res[policy])
        ch01_free(torch, out)
    peaks = [res[p]["peak_alloc_gb"] for p in ("all", "attn", "attn_mlp")]
    check(peaks[0] <= peaks[1] <= peaks[2],
          f"remat peaks all / attn / attn_mlp: {peaks}")
    return res


def ch01_optimizers(torch, card: str) -> dict:
    """(d): adafactor and lion, 4 steps at full depth."""
    res = {}
    for name in ("adafactor", "lion"):
        out, counts = ch01_run(torch, ["--max-steps", "4", "--optimizer",
                                       name])
        losses = ch01_losses(out)
        vals = [losses[s] for s in sorted(losses)]
        check(all(map(math.isfinite, vals)) and vals[-1] < vals[0],
              f"{name}: losses {vals}")
        res[name] = {"losses": vals,
                     "opt_state_gb": sum(
                         t.numel() * t.element_size() for slots in
                         out["state"].opt_state.optimizer.state.values()
                         for t in slots.values()) / 1e9,
                     **ch01_rates(out)}
        log(phase="chapter01", part="optimizer", optimizer=name, card=card,
            **res[name])
        ch01_free(torch, out)
    return res


def ch01_nan_drill(torch, card: str) -> dict:
    """(e): a NaN loss injected at the third step under ``--guard-policy
    skip``, at 2 layers: the run finishes and skips exactly that step."""
    from distributed_training_guide_tpu_torch.utils import faults

    out, _ = ch01_run(torch, ["--max-steps", "4", "--guard-policy", "skip"],
                      layers=CH01_RESUME_LAYERS,
                      env={faults.ENV_NAN_LOSS_STEP: "2"})
    flags = {i["global_step"]: i["notfinite"] for i in out["infos"]}
    skipped = out["last_info"]["guard_skipped"]
    check(skipped == 1 and flags == {1: 0.0, 2: 0.0, 3: 1.0, 4: 0.0},
          f"nan drill: skipped {skipped}, notfinite by step {flags}")
    log(phase="chapter01", part="nan drill", card=card, guard_skipped=skipped,
        notfinite=flags)
    ch01_free(torch, out)
    return {"guard_skipped": skipped}


def ch01_moe_remat(torch, card: str) -> dict:
    """qwen3-30b-a3b at full width cut to 2 layers (ragged dispatch), one
    step without remat and under "all" / "attn": K1 per layer once, twice,
    once; K5 6 per layer without remat and 9 with (the forward's three
    grouped products are recomputed under every policy: their outputs feed
    the backward), K6 3 per layer; the loss bitwise the same."""
    layers = CH01_MOE_LAYERS
    base = MOE_TRAIN_ARGS + ["--moe-dispatch", "ragged", "--max-steps", "1"]
    res, first = {}, None
    for policy, (k1, k5) in {None: (1, 6), "all": (2, 9),
                             "attn": (1, 9)}.items():
        extra = ([] if policy is None else ["--checkpoint-activations",
                                            "--remat-policy", policy])
        out, counts = ch01_run(torch, extra, layers=layers, base=base)
        want = {"flash_fwd": k1 * layers, "flash_dq": layers,
                "flash_dkv": layers, "grouped_matmul": k5 * layers,
                "tgmm": 3 * layers}
        check(counts == want, f"moe remat {policy}: launches {counts}, "
              f"want {want}")
        loss = out["infos"][0]["running_loss"]
        first = loss if first is None else first
        check(loss == first, f"moe remat {policy}: loss {loss!r}, without "
              f"remat {first!r}")
        res[str(policy)] = {"launches": counts,
                            "peak_alloc_gb": out["last_info"]["peak_alloc_gb"]}
        ch01_free(torch, out)
    log(phase="chapter01", part="moe remat", layers=layers, card=card, **res)
    return res


def phase_chapter01(torch, card: str) -> dict:
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="chapter01-"))
    try:
        resume = ch01_resume(torch, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    precision = ch01_precision(torch, card)
    remat = ch01_remat(torch, card, precision["fp32"]["losses"][0])
    optimizers = ch01_optimizers(torch, card)
    nan = ch01_nan_drill(torch, card)
    moe_remat = ch01_moe_remat(torch, card)
    check(all(CH01_LAUNCHES.get(k, 0) > 0 for k in (
        "flash_fwd", "flash_dq", "flash_dkv", "grouped_matmul", "tgmm")),
        f"chapter 01: a kernel of the path never launched: {CH01_LAUNCHES}")
    log(phase="chapter01", launches=CH01_LAUNCHES)
    return {"launches": dict(CH01_LAUNCHES), "resume": resume,
            "precision": precision, "remat": remat,
            "optimizers": optimizers, "nan": nan, "moe_remat": moe_remat}


# ---------------------------------------------------------------------------
# phase 17: the distributed plans of chapters 02, 04, 06 and 07, at world 1
# ---------------------------------------------------------------------------

PLAN_STEPS = 3
# (strategy, chapter module, its flags, the run's own arguments); zero2 takes
# two microbatches of 2 so that its sharded accumulation buffer exists, held
# to a single-plan run of the same microbatches
PLAN_RUNS = (("ddp", "c02_ddp", [], []),
             ("zero1", "c02_ddp", ["--zero1"], []),
             ("zero2", "c02_ddp", ["--zero2"], ["-b", "2", "--grad-accum", "2"]),
             ("fsdp", "c04_fsdp", [], []),
             ("tp", "c06_tp", [], []),
             ("tp_fsdp", "c07_tp_fsdp", [], []))
# one rank: every collective is a copy on a one-rank NCCL group, and the
# vocab-parallel loss of tp and tp_fsdp computes and differentiates the
# logsumexp as torch.logsumexp does, so every plan runs the single plan's
# arithmetic: bitwise is expected, and these bounds are what the check allows
PLAN_LOSS_REL = 1e-5
PLAN_NORM_REL = 1e-4
PLAN_RESUME_LAYERS = 2
PLAN_LAUNCHES: dict = {}    # each kernel's launches over the strategies' runs


def plan_env() -> dict:
    """The torchrun env contract for a world of one: rank 0 of 1 on a
    TCPStore at a free local port."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}


def with_env(env: dict, fn):
    import os

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def plan_run(torch, chapter, argv: list) -> tuple:
    """One run through a chapter's ``main`` (or chapter 01's CLI when
    ``chapter`` is None) with the K1-K3 launches of the run."""
    import importlib

    from distributed_training_guide_tpu_torch.train import cli

    reset_flash_counts()                      # the run's path starts here
    torch.cuda.reset_peak_memory_stats()
    if chapter is None:
        out = cli.run_training(cli.get_parser().parse_args(argv))
    else:
        mod = importlib.import_module(
            f"distributed_training_guide_tpu_torch.chapters.{chapter}")
        out = with_env(plan_env(), lambda: mod.main(argv))
    torch.cuda.synchronize()
    counts = flash_counts()                   # ... and ends here
    return out, counts


def plan_summary(out) -> dict:
    infos = out["infos"]
    later = infos[1:]
    return {"losses": [i["running_loss"] for i in infos],
            "grad_norms": [i["grad_norm"] for i in infos],
            "time_step_ms": sum(i["time/step"] for i in later) / len(later),
            "tokens_per_s": sum(i["tokens_per_s"] for i in later)
            / len(later),
            "peak_alloc_gb": out["last_info"]["peak_alloc_gb"]}


def plan_compare(name: str, got: dict, want: dict) -> dict:
    """A strategy's losses and grad norms against the single plan's."""
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], want["losses"]))
    norm_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(got["grad_norms"], want["grad_norms"]))
    check(len(got["losses"]) == PLAN_STEPS
          and all(map(math.isfinite, got["losses"])),
          f"plans {name}: losses {got['losses']}")
    check(loss_rel <= PLAN_LOSS_REL, f"plans {name}: losses {got['losses']} "
          f"against the single plan's {want['losses']}: rel {loss_rel}")
    check(norm_rel <= PLAN_NORM_REL, f"plans {name}: grad norms "
          f"{got['grad_norms']} against {want['grad_norms']}: rel "
          f"{norm_rel}")
    return {"loss_max_rel": loss_rel, "grad_norm_max_rel": norm_rel,
            "losses_bitwise": got["losses"] == want["losses"],
            "grad_norms_bitwise": got["grad_norms"] == want["grad_norms"]}


def plan_resume(torch, root: Path) -> dict:
    """Chapter 04's plan (fsdp) saves at step 2 of 3 at 2 layers; chapter
    07's plan (tp_fsdp) resumes from it and takes step 3, whose loss must
    equal the fsdp run's own step 3."""
    import torch.distributed as dist

    from distributed_training_guide_tpu_torch.launch import (
        maybe_initialize_distributed)
    from distributed_training_guide_tpu_torch.parallel import (make_mesh,
                                                               make_plan)
    from distributed_training_guide_tpu_torch.train import cli

    def run(strategy):
        args = cli.get_parser().parse_args(
            TRAIN_ARGS + ["--log-freq", "1", "--max-steps", str(PLAN_STEPS),
                          "-e", "plans", "--save-dir", str(root),
                          "--ckpt-freq", "2"])

        def go():
            maybe_initialize_distributed("cuda")
            try:
                return cli.run_training(
                    args, lambda: make_plan(strategy, make_mesh()),
                    model_overrides={"num_layers": PLAN_RESUME_LAYERS})
            finally:
                dist.destroy_process_group()
        return with_env(plan_env(), go)

    straight = run("fsdp")
    want = {i["global_step"]: i["running_loss"] for i in straight["infos"]}
    saves = straight["checkpoint_saves"]
    ch01_free(torch, straight)
    resumed = run("tp_fsdp")
    got = {i["global_step"]: i["running_loss"] for i in resumed["infos"]}
    check(resumed["resumed"] and list(got) == [PLAN_STEPS],
          f"plans resume: resumed={resumed['resumed']}, steps {list(got)}")
    rel = abs(got[PLAN_STEPS] - want[PLAN_STEPS]) / abs(want[PLAN_STEPS])
    check(rel <= PLAN_LOSS_REL, f"plans resume: step {PLAN_STEPS} loss "
          f"{got[PLAN_STEPS]} under tp_fsdp, {want[PLAN_STEPS]} under fsdp")
    ch01_free(torch, resumed)
    return {"fsdp_losses": want, "tp_fsdp_loss": got[PLAN_STEPS],
            "rel": rel, "bitwise": got[PLAN_STEPS] == want[PLAN_STEPS],
            "layers": PLAN_RESUME_LAYERS,
            "saves": [{k: v for k, v in s.items()
                       if k in ("step", "bytes", "write_s")} for s in saves]}


def phase_plans(torch, card: str) -> dict:
    import shutil
    import tempfile

    layers = 16
    base = TRAIN_ARGS + ["--max-steps", str(PLAN_STEPS), "--log-freq", "1"]
    refs, results, per_step = {}, {}, {}
    for extra in ([], ["-b", "2", "--grad-accum", "2"]):
        out, counts = plan_run(torch, None, base + extra)
        refs[tuple(extra)] = plan_summary(out)
        ch01_free(torch, out)
        log(phase="plans", strategy="single", extra=extra, card=card,
            launches=counts, **refs[tuple(extra)])
    for strategy, chapter, flags, extra in PLAN_RUNS:
        out, counts = plan_run(torch, chapter, base + extra + flags)
        summary = plan_summary(out)
        ch01_free(torch, out)
        accum = 2 if "--grad-accum" in extra else 1
        want = {k: layers * accum * PLAN_STEPS for k in counts}
        check(counts == want, f"plans {strategy}: launches {counts}, want "
              f"{want} ({layers * accum} of each per step: the einsum "
              f"attention ran)")
        for k, v in counts.items():
            PLAN_LAUNCHES[k] = PLAN_LAUNCHES.get(k, 0) + v
        per_step[strategy] = {k: v // PLAN_STEPS for k, v in counts.items()}
        ref = refs[tuple(extra)]
        results[strategy] = {**summary, **plan_compare(strategy, summary,
                                                       ref),
                             "single_time_step_ms": ref["time_step_ms"],
                             "single_tokens_per_s": ref["tokens_per_s"],
                             "single_peak_alloc_gb": ref["peak_alloc_gb"]}
        log(phase="plans", strategy=strategy, chapter=chapter, flags=flags,
            extra=extra, card=card, launches_per_step=per_step[strategy],
            **results[strategy])
    root = Path(tempfile.mkdtemp(prefix="plans-"))
    try:
        resume = plan_resume(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(phase="plans", resume=resume, card=card)
    return {"launches": dict(PLAN_LAUNCHES), "per_step": per_step,
            "results": results, "single": refs[()], "resume": resume}


def ptxas_serialized(build) -> list:
    """The kernels whose wgmma ptxas serialized (warning C7520: a wgmma
    under a branch it cannot prove warp-uniform), as the warning names
    them (mangled), from the ``-Xptxas -v`` logs."""
    import re

    return sorted({m.group(1) for log in build.build_logs.values()
                   for line in log.splitlines() if "C7520" in line
                   for m in [re.search(r"function '([^']+)'", line)] if m}
                  | {line.strip()[:160] for log in build.build_logs.values()
                     for line in log.splitlines() if "C7520" in line
                     and "function '" not in line})


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
        kernel = next((k for w, k in (
            ("paged_attend_split", "paged_attend_split"),
            ("paged_attend_mma", "paged_attend_mma"),
            ("paged_attend_combine", "paged_attend_combine"),
            ("flash_fwd", "flash_fwd"),
            ("flash_dq", "flash_dq"), ("flash_dkv", "flash_dkv"),
            ("tgmm", "tgmm"), ("gmm_", "grouped_matmul"),
            ("qmm_", "quantized_matmul")) if w in short),
            "other")
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
    import importlib.util

    log(phase="device", name=card, nvidia_smi=smi,
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, matmul_allow_tf32=False,
        cudnn_allow_tf32=False,
        # present or not: the port imports none of them at module level
        optional_modules={m: importlib.util.find_spec(m) is not None
                          for m in ("safetensors", "transformers", "wandb",
                                    "tqdm", "triton")})

    t0 = time.perf_counter()
    sources = _build.all_sources()
    _build.build(sources)
    ptxas = ptxas_summary(_build)
    serialized = ptxas_serialized(_build)
    log(phase="build", sources=sources, seconds=time.perf_counter() - t0,
        ptxas=ptxas, wgmma_serialized_c7520=serialized)
    check(not any("tgmm" in name for name in serialized),
          f"ptxas serialized K6's wgmma (C7520): {serialized}")

    worst = phase_kernels(torch)
    timing = phase_timing(torch)
    flash_worst = phase_flash(torch)
    flash_timing = phase_flash_timing(torch)
    serve = phase_serve(torch, smi)
    train = phase_train(torch, smi)
    gmm_worst = phase_grouped(torch)
    gmm_timing = phase_grouped_timing(torch)
    moe_serve = phase_moe_serve(torch, smi)
    moe_train = phase_moe_train(torch, smi)
    qmm_worst = phase_qmm(torch)
    qmm_timing = phase_qmm_timing(torch)
    int8_serve = phase_int8_serve(torch, smi)
    ch01 = phase_chapter01(torch, smi)
    plans = phase_plans(torch, smi)

    # K4 is three kernels: each body at the shape it serves (decode, the
    # prefill chunk) and the combine at decode; "k4_ms" is the whole call
    k4_shapes = {k: {kk: v[kk] for kk in (
        "S", "T", "heads", "context", "dtype", "ms", "call_ms", "plain_ms",
        "library_ms",
        "bound_ms", "bound_by", "share_of_bound", "body_ms", "body_bound_ms",
        "combine_ms", "combine_bound_ms")} for k, v in timing.items()}
    k4 = {"route": "cuda",
          "source": "distributed_training_guide_tpu_torch/ops/csrc/"
                    "paged_attend.cu",
          "replaces": "distributed_training_guide_tpu/ops/paged_decode.py:107"}
    dec, chunk = timing["decode"], timing["chunk"]
    kernels = [{
        "name": "paged_attend_split", **k4,
        "launches": serve["body_launches"]["split"],
        "max_abs_err": worst["split"], "shape": "decode", "ms": dec["body_ms"],
        "plain_ms": dec["body_plain_ms"], "bound_ms": dec["body_bound_ms"],
        "bound_by": dec["body_bound_by"], "library_ms": dec["library_ms"],
        "library_note": "SDPA computes the whole attention, body and combine",
        "k4_ms": dec["ms"], "k4_call_ms": dec["call_ms"],
        "k4_plain_ms": dec["plain_ms"], "k4_bound_ms": dec["bound_ms"],
        "launches_per_decode_step": serve["per_step"],
        "ptxas_registers_spills": ptxas.get("paged_attend_split", {}),
        "shapes": k4_shapes,
    }, {
        "name": "paged_attend_mma", **k4,
        "launches": serve["body_launches"]["mma"],
        "max_abs_err": worst["mma"], "shape": "chunk", "ms": chunk["body_ms"],
        "plain_ms": chunk["body_plain_ms"],
        "bound_ms": chunk["body_bound_ms"],
        "bound_by": chunk["body_bound_by"], "library_ms": chunk["library_ms"],
        "library_note": "SDPA computes the whole attention, body and combine",
        "k4_ms": chunk["ms"], "k4_call_ms": chunk["call_ms"],
        "k4_plain_ms": chunk["plain_ms"], "k4_bound_ms": chunk["bound_ms"],
        "ptxas_registers_spills": ptxas.get("paged_attend_mma", {}),
    }, {
        "name": "paged_attend_combine", **k4,
        "launches": serve["body_launches"]["combine"],
        "max_abs_err": worst["combine"], "shape": "decode",
        "ms": dec["combine_ms"], "plain_ms": dec["combine_plain_ms"],
        "bound_ms": dec["combine_bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no PyTorch call merges split softmax partials",
        "ptxas_registers_spills": ptxas.get("paged_attend_combine", {}),
    }]
    replaces = {"flash_fwd": 112, "flash_dq": 297, "flash_dkv": 341}
    shape_keys = ("body", "ms", "profiler_ms", "call_ms", "plain_ms",
                  "library_ms", "library_call_ms", "bound_ms", "bound_by",
                  "share_of_bound", "causal_tail")
    for name, line in replaces.items():
        t = flash_timing["1b-main"][name]
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
            "body": t["body"],
            "bf16_kernel_arith_rel_l2": flash_worst["kernel_arith"][name],
            "launches_chapter01": ch01["launches"][name],
            "launches_plans": plans["launches"][name],
            "launches_per_step_by_plan": {
                k: v[name] for k, v in plans["per_step"].items()},
            "launches_per_step_by_remat_policy": {
                p: r["launches_per_step"][name]
                for p, r in ch01["remat"].items()},
            "shapes": {shape: {"B_S_Hq_Hkv_D": FLASH_TIMING_SHAPES[shape],
                               **{kk: flash_timing[shape][name][kk]
                                  for kk in shape_keys
                                  if kk in flash_timing[shape][name]}}
                       for shape in FLASH_TIMING_SHAPES},
        })
    keys = ("M", "K", "N", "G", "dtype", "body", "ms", "profiler_ms",
            "call_ms", "plain_ms", "library_ms", "library_call_ms", "bound_ms",
            "bound_by", "bound_tc_ms")
    dec = gmm_timing["decode"]
    kernels.append({
        "name": "grouped_matmul", "route": "cuda",
        "source": "distributed_training_guide_tpu_torch/ops/csrc/"
                  "grouped_matmul.cu",
        "replaces": "distributed_training_guide_tpu/ops/grouped_matmul.py:150",
        "launches": moe_serve["launches"]
        + moe_train["launches"]["grouped_matmul"],
        "launches_serve": moe_serve["launches"],
        "launches_train": moe_train["launches"]["grouped_matmul"],
        "launches_per_serve_forward": moe_serve["per_forward"],
        "launches_per_train_step": moe_train["per_step"]["grouped_matmul"],
        "launches_by_body_train": moe_train["launches_by_body"],
        "launches_chapter01": ch01["launches"]["grouped_matmul"],
        "max_abs_err": gmm_worst["grouped_matmul"], "body": dec["body"],
        "tc_sum_drift_k8192": gmm_worst["tc_sum_drift"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "ptxas_registers_spills": ptxas.get("grouped_matmul", {}),
        "shapes": {k: {kk: gmm_timing[k].get(kk) for kk in keys}
                   for k in ("decode", "train", "train-dlhs")},
    })
    t = gmm_timing["tgmm-train"]
    tkeys = keys + ("fma_ms", "library_bf16_dy_ms", "share_of_tc_bound")
    kernels.append({
        "name": "tgmm", "route": "cuda",
        "source": "distributed_training_guide_tpu_torch/ops/csrc/"
                  "grouped_matmul.cu",
        "replaces": "distributed_training_guide_tpu/ops/grouped_matmul.py:176",
        "launches": moe_train["launches"]["tgmm"],
        "launches_per_train_step": moe_train["per_step"]["tgmm"],
        "launches_by_body_train": moe_train["tgmm_launches_by_body"],
        "launches_chapter01": ch01["launches"]["tgmm"],
        "max_abs_err": gmm_worst["tgmm"], "body": t["body"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "bound_tc_ms": t["bound_tc_ms"],
        "library_ms": t["library_ms"], "library_note": t["library_note"],
        "ptxas_registers_spills": ptxas.get("tgmm", {}),
        "shapes": {k: {kk: gmm_timing[k].get(kk) for kk in tkeys}
                   for k in ("tgmm-train", "tgmm-train-down")},
    })
    t = qmm_timing["gate-decode"]
    kernels.append({
        "name": "quantized_matmul", "route": "cuda",
        "source": "distributed_training_guide_tpu_torch/ops/csrc/"
                  "quantized_matmul.cu",
        "replaces": "distributed_training_guide_tpu/ops/"
                    "quantized_matmul.py:119",
        "launches": int8_serve["launches"],
        "launches_by_body": int8_serve["launches_by_body"],
        "launches_per_serve_forward": int8_serve["per_forward"],
        "max_abs_err": qmm_worst, "body": t["body"],
        "ms": t["ms"], "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "bound_tc_ms": t["bound_tc_ms"],
        "library_ms": None, "library_note": t["library_note"],
        "control_ms": t["control_ms"], "control_note": t["control_note"],
        "ptxas_registers_spills": ptxas.get("quantized_matmul", {}),
        "shapes": {k: {kk: v[kk] for kk in (
            "M", "K", "N", "bs", "dtype", "body", "splits", "ms", "call_ms",
            "plain_ms", "control_ms", "bound_ms", "bound_by", "bound_tc_ms")}
            for k, v in qmm_timing.items()},
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
