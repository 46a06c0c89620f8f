"""Continuous-batching decode engine over the paged KV cache, in PyTorch.

Counterpart of ``distributed_training_guide_tpu/serve/engine.py``. The
programs run eagerly where the JAX package jits them:

- ONE batched decode step over the fixed ``[n_slots]`` slot array. Block
  tables, lengths and sampling knobs are tensors; idle slots compute into
  the trash page and are masked at the sample. Every paged attend — the
  decode step and each prefill chunk — goes through
  ``ops/paged_decode.py``: the CUDA kernel on the card, its plain version
  for CPU tensors (``attend_impl="xla"``, the gather path, is accepted
  only with ``device="cpu"``).
- One prefill per LENGTH BUCKET (powers of two up to ``max_len``) through
  the model's plain causal prefill, committed into the slot's pages — or,
  with ``prefill_chunk=N``, the prompt streams through the paged path N
  tokens at a time, co-scheduled with resident decodes.

Between scheduler events the decode tensors stay on the device: the step
returns next-step tokens and lengths, so a steady iteration copies one
int32 per slot back to the host and nothing up.

Sampling. JAX draws with ``fold_in(key(seed), position)`` (threefry);
those bits cannot be reproduced here, so the port keeps the contract and
not the bits: the draw is a pure function of (request seed, absolute
position), a counter-based integer hash feeding a Gumbel-max over the
same sorted, top-k and top-p filtered set. A request's tokens therefore
do not depend on its slot, its co-residents, its admission order or a
preemption replay. Greedy decoding (temperature 0) is an argmax and is
token-identical to the JAX engine; an all-greedy batch skips the sort.

Weight storage (``weight_dtype=``, ``serve/weights.py``): None keeps the
params as given; "fp32" / "bf16" cast them; "int8" (llama family)
quantizes the projection, embedding and head leaves block-wise, and every
standard-form product of the forward then runs the block-dequant kernel
K7 on the card (``ops/quantized_matmul.py``).

Speculative decoding (``speculate=``, ``serve/spec.py``): a drafter
proposes up to k tokens per slot and ONE ``[S, k+1]`` verify forward
(``ModelPrograms.verify_for``: K4 at T = k + 1 on the card) draws the
target token at every position from the decode step's (seed, position)
stream; a draft is accepted when it equals that draw, so the emitted
tokens are always the target sampler's own.

Serving under a plan (``plan=``, ``shard_kv=``; ``serve/sharding.py``):
the JAX engine drives a tp (or fsdp) mesh from one process; here each
rank of the plan is a process. Rank 0 builds the engine and owns every
host decision; every other rank builds the same ``ModelPrograms`` and
runs ``follow()`` until rank 0's ``release()``. Each program call is
broadcast from rank 0 before it runs, so every rank runs it, in order, on
its own params (its shards under the plan) and its own pools (its kv
heads under ``shard_kv``). The device programs are the methods
registered by ``@_program`` (``PROGRAMS``), the one list both sides read.
A program that fails on any rank after its broadcast ends that rank
(``sharding.abort_gang``): its peers may be inside one of its
collectives, which no later message can match.

Decode horizons (``decode_horizon=K``): K decode steps per host dispatch
(``ModelPrograms.horizon_for``), with the live, budget and EOS masks kept
on the device and ONE ``[n_slots, K]`` read per horizon, double-buffered
in ``step()``: horizon h is launched before h - 1 is booked. Eager torch
still launches every kernel from the host, so a horizon saves the
per-step read-back and the host's booking between steps, not the
launches.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models.from_jax import _to_torch
from ..models.registry import ModelBundle, family_module
from ..ops.paged_decode import HEAD_DIMS, MAX_PAGE, paged_decode_eligible
from .adapters import (AdapterPool, DEFAULT_TARGETS, ZERO_ADAPTER,
                       adapter_nbytes, adapter_shapes, init_adapter_stacks,
                       validate_adapter_params)
from .kv_pages import (commit_prefill, copy_pages, init_pages, kv_dtype_name,
                       kv_page_bytes, make_attend, PagePool,
                       pages_for_tokens, pool_nbytes, TRASH_PAGE)
from .scheduler import Admission, Request, RequestResult, Scheduler
from .sharding import (Channel, ServeLayout, abort_gang,
                       encode as sharding_encode,
                       follow as sharding_follow, gather_sharded_payload,
                       head_slice, kv_heads_here, shard_params,
                       validate_kv_shard)
from .spec import Drafter, NgramDrafter, new_spec_counters
from .tiering import (HostTier, cache_prefix_keys, make_gather,
                      restore_prefixes, restore_queued)
from .transport import gather_payload, scatter_payload
from .weights import (params_nbytes, require_llama, store_weights,
                      weight_bytes_by_dtype, weight_dtype_name)

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 tensors holding uint32 values, split in
    16-bit halves so no intermediate leaves int64's range."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (lowbias32): a bijection on uint32 whose
    output bits each depend on every input bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor,
                  v: int) -> torch.Tensor:
    """[S, V] Gumbel noise, a pure function of (seed, position, rank):
    the counter-based stream that replaces jax's fold_in keys."""
    key = _mix32(_mix32(seeds.long() & _M32) ^ (positions.long() & _M32))
    ctr = torch.arange(v, device=seeds.device, dtype=torch.int64)
    bits = _mix32(_mix32(key[:, None] ^ ctr[None, :]) ^ 0x9E3779B9)
    u = (bits.to(torch.float64) + 0.5) / 2.0 ** 32            # (0, 1)
    return -torch.log(-torch.log(u))


def _sample_tokens(logits, seeds, positions, temps, top_ks, top_ps, *,
                   stochastic: bool) -> torch.Tensor:
    """Per-slot temperature / top-k / top-p sampling, greedy at temp 0.

    logits [S, V] fp32; the knobs are [S] tensors. The filters run in
    sorted space (one stable descending sort), the draw is a Gumbel-max
    over the surviving ranks, and the rank maps back to a vocab id through
    the sort order. ``stochastic`` (host-known: any slot at temperature
    > 0) gates the sort; without it the result is the argmax the temp-0
    lanes would take anyway."""
    s, v = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    if not stochastic:
        return greedy.to(torch.int32)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sorted_desc, order = torch.sort(scaled, dim=-1, descending=True,
                                    stable=True)
    neg_inf = torch.finfo(torch.float32).min
    k_eff = torch.where(top_ks > 0, top_ks, v).clamp(1, v)
    ranks = torch.arange(v, device=logits.device)[None, :]
    kept = torch.where(ranks < k_eff[:, None], sorted_desc, neg_inf)
    # top-p on the k-filtered distribution: the smallest prefix whose
    # cumulative probability reaches top_p (rank 0 always survives)
    probs = torch.softmax(kept, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    kept = torch.where(cum - probs < top_ps[:, None], kept, neg_inf)
    idx = torch.argmax(kept.to(torch.float64)
                       + _gumbel_noise(seeds, positions, v), dim=-1)
    sampled = torch.gather(order, 1, idx[:, None])[:, 0]
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


def resolve_context_bounds(config, max_len: Optional[int],
                           page_size: int) -> tuple:
    """(capacity max_len, request-validation max_model_len, max_pages):
    a bounded default (the full position table of a big preset would size
    the pool for 131k tokens per slot); ``max_len`` is page capacity and
    requests validate against min(capacity, position table)."""
    max_pos = getattr(config, "max_position_embeddings", None)
    if max_len is None:
        max_len = min(max_pos, 2048) if max_pos else 2048
    max_model_len = min(max_len, max_pos) if max_pos else max_len
    return max_len, max_model_len, pages_for_tokens(max_len, page_size)


def default_prefill_buckets(max_pages: int, page_size: int) -> tuple:
    """Power-of-two prompt buckets up to the per-slot page capacity."""
    cap = max_pages * page_size
    b, buckets = page_size, []
    while b < cap:
        buckets.append(b)
        b *= 2
    buckets.append(cap)
    return tuple(buckets)


def validate_prefill_buckets(buckets: tuple, *, max_pages: int,
                             page_size: int, max_model_len: int) -> tuple:
    """Buckets must cover every admissible prompt and stay inside the
    page capacity (``commit_prefill`` indexes the table row by page), so
    an unservable bucket set fails at construction, not after a request
    holds a slot and pages."""
    buckets = tuple(sorted(buckets))
    cap = max_pages * page_size
    if buckets[-1] < min(max_model_len - 1, cap):
        raise ValueError(
            f"prefill_buckets {buckets} cannot cover the largest "
            f"admissible prompt ({min(max_model_len - 1, cap)} tokens)")
    if buckets[-1] > cap:
        raise ValueError(
            f"prefill bucket {buckets[-1]} exceeds the per-slot page "
            f"capacity {cap}")
    return buckets


def derived_pool_metrics(*, pool: PagePool, cached_pages: int, n_slots: int,
                         decode_steps: int, decode_tokens: int,
                         admitted: int, prefix_hits: int,
                         lat: "LatencyMeter", bytes_per_page: int,
                         pool_dtype: str, host_dispatches: int,
                         horizon_ksum: int,
                         tier: Optional[HostTier] = None) -> dict:
    """The derived tail of stats(): pool gauges, the prefix hit rate,
    decode occupancy, the dispatch amortization of a decode horizon
    (``host_dispatches``, the raw ``horizon_ksum`` and their means) and
    latency. The host-tier gauges are always present (zeros without a
    tier), so the router's fleet aggregation sees one schema."""
    held = pool.capacity - pool.n_free
    tier_tail = tier.gauges() if tier is not None else {
        "host_tier_bytes": 0, "host_tier_budget_bytes": 0,
        "host_tier_records": 0, "spilled_pages": 0,
        "restore_hits": 0, "restore_misses": 0}
    return {
        **tier_tail,
        "n_slots": n_slots,
        "pool_dtype": pool_dtype,
        "bytes_per_page": bytes_per_page,
        "pages_capacity": pool.capacity,
        "pages_free": pool.n_free,
        "pages_held": held,
        "pages_cached": cached_pages,
        "pages_cached_bytes": cached_pages * bytes_per_page,
        "pool_occupancy": (round(held / pool.capacity, 3)
                           if pool.capacity else 0.0),
        "prefix_hit_rate": (round(prefix_hits / admitted, 3)
                            if admitted else 0.0),
        "decode_steps": decode_steps,
        "decode_tokens": decode_tokens,
        "decode_occupancy": (round(
            decode_tokens / (decode_steps * n_slots), 3)
            if decode_steps else 0.0),
        "host_dispatches": host_dispatches,
        "horizon_ksum": horizon_ksum,
        "tokens_per_dispatch": (round(decode_tokens / host_dispatches, 3)
                                if host_dispatches else 0.0),
        "horizon_effective": (round(horizon_ksum / host_dispatches, 3)
                              if host_dispatches else 0.0),
        "ttft_s_avg": lat.ttft_avg(),
        "itl_s_avg": lat.itl_avg(),
    }


def adapter_metrics(pool: Optional[AdapterPool], *,
                    publishes: int = 0) -> dict:
    """The multi-tenant tail of stats(): pool occupancy gauges and the
    insert / update / evict counters (LRU evictions apart). Empty without
    a pool, so an adapter-free engine's stats() keys are the pre-adapter
    set. The per-adapter request counts are the scheduler's
    ``adapter_requests``."""
    if pool is None:
        return {}
    return {
        "adapter_slots": pool.max_adapters,
        "adapter_capacity": pool.capacity,
        "adapters_live": pool.n_live,
        "adapters_free": pool.n_free,
        "adapter_occupancy": (round(pool.n_live / pool.capacity, 3)
                              if pool.capacity else 0.0),
        "adapter_inserts": pool.stats["inserts"],
        "adapter_updates": pool.stats["updates"],
        "adapter_evictions": pool.stats["evictions"],
        "adapter_lru_evictions": pool.stats["lru_evictions"],
        "adapter_publishes": publishes,
    }


def spec_metrics(spec: dict, *, decode_steps: int, decode_tokens: int,
                 drafter: Optional[Drafter]) -> dict:
    """The speculation tail of stats(): drafted / accepted / rejected
    counts, the acceptance rate and tokens per decode iteration.
    ``spec_acceptance_rate`` is left out until something was drafted: a
    0.0 would read as "0% acceptance" where nothing has run yet."""
    drafted = spec["tokens_drafted"]
    out = {
        "spec_steps": spec["spec_steps"],
        "spec_tokens_drafted": drafted,
        "spec_tokens_accepted": spec["tokens_accepted"],
        "spec_tokens_rejected": spec["tokens_rejected"],
        "decode_tokens_per_step": (round(decode_tokens / decode_steps, 3)
                                   if decode_steps else 0.0),
    }
    if drafted:
        out["spec_acceptance_rate"] = round(
            spec["tokens_accepted"] / drafted, 3)
    if drafter is not None:
        out.update(drafter.stats())
    return out


def resolve_drafter(speculate, *, spec_k: int,
                    n_slots: Optional[int] = None,
                    device: Optional[torch.device] = None
                    ) -> Optional[Drafter]:
    """The engine's ``speculate=``: None / "off" disables, "ngram" is the
    prompt-lookup drafter at depth ``spec_k``, and a
    :class:`~.spec.Drafter` instance rides as it is (its own ``k``
    wins). A drafter with per-slot state must cover the engine's slots,
    and one with a device must be on the engine's."""
    if speculate is None or speculate == "off":
        return None
    if speculate == "ngram":
        return NgramDrafter(k=spec_k)
    if isinstance(speculate, Drafter):
        drafter_slots = getattr(speculate, "n_slots", None)
        if (n_slots is not None and drafter_slots is not None
                and drafter_slots < n_slots):
            raise ValueError(
                f"drafter covers {drafter_slots} slots but the engine "
                f"decodes {n_slots}: build the drafter with n_slots >= "
                f"the engine's")
        drafter_dev = getattr(speculate, "device", None)
        if (device is not None and drafter_dev is not None
                and drafter_dev.type != device.type):
            raise ValueError(
                f"drafter runs on {drafter_dev} but the engine on "
                f"{device}: build the drafter with the engine's device")
        return speculate
    raise ValueError(f"speculate must be None, 'off', 'ngram', or a "
                     f"Drafter instance, got {speculate!r}")


def collect_partial_tokens(scheds, handoffs=()) -> dict:
    """request_id -> tokens generated so far, for every live sequence of
    ``scheds`` and every in-transit handoff: the streaming tap of the
    monolith and the disaggregated pair. Lists only grow (a replay
    rewrites k/v, not tokens)."""
    out = {}
    for sched in scheds:
        for slot in sched.slots:
            if slot is not None and slot.generated:
                out[slot.request.request_id] = list(slot.generated)
    for h in handoffs:
        if h.generated:
            out[h.request.request_id] = list(h.generated)
    return out


def drop_stale_pending(sched: Scheduler, pending: dict) -> None:
    """A preempted or expired mid-prefill slot takes its chunk state
    with it (it re-admits from the queue)."""
    for idx in list(pending):
        slot = sched.slots[idx]
        adm = pending[idx]
        if (slot is None
                or slot.request.request_id != adm.request.request_id):
            del pending[idx]


class LatencyMeter:
    """Running TTFT / inter-token-latency averages over finished
    requests (host-side counters feeding stats())."""

    def __init__(self):
        self.ttft_sum = self.itl_sum = 0.0
        self.ttft_n = self.itl_n = 0

    def note(self, finished: list) -> None:
        for res in finished:
            if res.first_token_at:
                self.ttft_sum += res.ttft_s
                self.ttft_n += 1
                if len(res.generated_ids) > 1:
                    self.itl_sum += res.itl_s
                    self.itl_n += 1

    def ttft_avg(self) -> float:
        return round(self.ttft_sum / self.ttft_n, 4) if self.ttft_n else 0.0

    def itl_avg(self) -> float:
        return round(self.itl_sum / self.itl_n, 6) if self.itl_n else 0.0


def run_fork(programs: "ModelPrograms", pages: dict, adm: Admission) -> None:
    """Copy-on-write: the partially shared page is copied into the slot's
    private replacement before the remainder prefill writes into it."""
    src, dst = adm.fork
    programs.fork(pages, int(src), int(dst))


def run_bucket_prefill(programs: "ModelPrograms", pages: dict,
                       sched: Scheduler, adm: Admission, buckets: tuple):
    """Whole-prompt prefill through the bucketed program, then the commit
    scatter (which skips the shared prefix and the pad tail). Returns the
    real last token's logits row."""
    tokens = adm.tokens
    n = len(tokens)
    bucket = next((b for b in buckets if b >= n), None)
    if bucket is None:
        raise ValueError(f"prompt length {n} exceeds the largest prefill "
                         f"bucket {buckets[-1]}")
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :n] = tokens
    programs.prefill_calls += 1
    logit = programs.bucket_prefill(bucket)(
        programs.params, pages, programs.to_device(ids), n - 1,
        programs.to_device(sched.table_row(adm.slot_idx)), n,
        adm.shared_len, *programs.lora_call_args([adm.request.adapter_id]))
    sched.commit_tokens(adm.slot_idx, n - adm.shared_len)
    return logit


def advance_prefill_chunks(programs: "ModelPrograms", pages: dict,
                           sched: Scheduler, pending: dict, chunk: int,
                           on_complete) -> list:
    """Run up to ``chunk`` prompt tokens through the chunk program, oldest
    prefilling slot first; the budget is charged at the padded program
    cost. ``on_complete(adm, logit)`` fires when a slot's final chunk
    lands; a non-None return is a finished RequestResult."""
    finished = []
    budget = chunk
    for slot_idx in sched.prefilling_indices():
        if budget <= 0:
            break
        adm = pending.get(slot_idx)
        if adm is None:
            continue
        slot = sched.slots[slot_idx]
        start = slot.cache_len
        real = min(chunk, slot.target_len - start)
        budget -= chunk
        ids = np.zeros((1, chunk), np.int32)
        ids[0, :real] = adm.tokens[start:start + real]
        programs.prefill_calls += 1
        logit = programs.chunk_for(chunk)(
            programs.params, pages, programs.to_device(ids),
            programs.to_device(np.array([start], np.int32)),
            programs.to_device(sched.table_row(slot_idx)[None]), real - 1,
            programs.to_device(np.array([real], np.int32)),
            *programs.lora_call_args([adm.request.adapter_id]))
        sched.commit_tokens(slot_idx, real)
        if not sched.slots[slot_idx].prefilling:   # final chunk landed
            pending.pop(slot_idx)
            res = on_complete(adm, logit)
            if res is not None:
                finished.append(res)
    return finished


_DEV_KEYS = ("tokens", "lengths", "tables", "seeds", "temps", "top_ks",
             "top_ps", "actives")


def decode_dev(programs: "ModelPrograms", sched: Scheduler,
               kind: str = "plain", keys=_DEV_KEYS) -> dict:
    """The device-resident decode tensors of one ``kind`` ("plain",
    "spec" or "horizon"), rebuilt after a scheduler event, plus the
    host-known ``stochastic`` flag that gates the sort. With an adapter
    pool the per-slot adapter vector rides along."""
    if programs.adapter_pool is not None:
        keys = keys + ("adapters",)
    arr = sched.decode_arrays()
    dev = {key: programs.to_device(arr[key]) for key in keys}
    dev["kind"] = kind
    dev["stochastic"] = bool((arr["temps"][arr["actives"]] > 0).any())
    return dev


def run_spec_decode(programs: "ModelPrograms", pages: dict,
                    sched: Scheduler, drafter: Drafter, spec: dict,
                    dev: Optional[dict]):
    """One SPECULATIVE decode iteration over the decoding slots:

    1. drafting on the host, each slot's candidates clipped to its
       remaining token budget and the position table;
    2. lookahead page growth (``ensure_lookahead``: a slot that cannot
       get its speculated positions' pages drafts less, it never
       preempts);
    3. ONE ``[S, k+1]`` verify forward (``verify_for``), which writes
       every candidate's k/v and draws the target token at every
       position from the decode step's (seed, position) stream;
    4. acceptance: a draft is accepted iff it equals the target's draw;
       the emitted run is the accepted prefix plus the first
       disagreeing draw. Lengths roll back on the device (the verify
       returns ``lengths + n_acc + 1``); the dead k/v past them is
       overwritten by the next write.

    ``dev`` is the engine's device cache (kind "spec"): a steady
    iteration uploads the candidate ids and their count and reads back
    (targets, n_acc). Returns (finished, tokens emitted, dev), or None
    when no slot drafted anything: the caller then runs the plain step,
    which costs a (k+1)-th of the padded verify."""
    active = sched.active_indices()
    k = int(drafter.k)
    t = k + 1
    contexts, budgets = {}, {}
    for i in active:
        slot = sched.slots[i]
        contexts[i] = list(slot.request.prompt_ids) + list(slot.generated)
        budgets[i] = max(0, min(
            k,
            # a draft past the request's own budget is never emitted
            slot.request.max_new_tokens - len(slot.generated) - 1,
            # the verify writes positions up to cache_len + drafts
            sched.max_len - 1 - slot.cache_len))
    proposals = drafter.propose_many(contexts, budgets)
    if not any(proposals.get(i) and budgets[i] > 0 for i in active):
        return None
    ids = np.zeros((sched.n_slots, t), np.int32)
    n_valid = np.ones(sched.n_slots, np.int32)
    grew = False
    for i in active:
        slot = sched.slots[i]
        ids[i, 0] = slot.generated[slot.replay_pos]
        props = [int(x) for x in (proposals.get(i) or [])][:budgets[i]]
        n_pages_before = len(slot.pages)
        granted = sched.ensure_lookahead(i, len(props))
        grew = grew or len(slot.pages) != n_pages_before
        props = props[:granted]
        ids[i, 1:1 + len(props)] = props
        n_valid[i] = 1 + len(props)
    if dev is None or dev.get("kind") != "spec":
        dev = decode_dev(programs, sched, "spec")
    elif grew:      # lookahead growth extended a block table mid-flight
        dev["tables"] = programs.to_device(sched.decode_arrays()["tables"])
    # every active slot at temperature 0: the target draw is the argmax
    # and the verify skips the t-position sorted-space sampler
    greedy = all(sched.slots[i].request.temperature == 0.0 for i in active)
    programs.verify_calls += 1
    targets, n_acc, dev["lengths"] = programs.verify_for(t, greedy=greedy)(
        programs.params, pages, programs.to_device(ids), dev["lengths"],
        dev["tables"], dev["seeds"], dev["temps"], dev["top_ks"],
        dev["top_ps"], dev["actives"], programs.to_device(n_valid),
        *programs.lora_call_args(dev.get("adapters")))
    targets = targets.cpu().numpy()
    n_acc = n_acc.cpu().numpy()
    finished, emitted_total = [], 0
    for i in active:
        n_d = int(n_valid[i]) - 1
        acc = int(n_acc[i])
        spec["tokens_drafted"] += n_d
        spec["tokens_accepted"] += acc
        spec["tokens_rejected"] += n_d - acc
        for j in range(acc + 1):
            emitted_total += 1
            res = sched.record_token(i, int(targets[i, j]),
                                     from_decode=True)
            if res is not None:     # eos / length mid-run: the rest of the
                finished.append(res)   # accepted run goes with the slot
                break
    spec["spec_steps"] += 1
    return finished, emitted_total, dev


def run_decode_iteration(programs: "ModelPrograms", pages: dict,
                         sched: Scheduler, drafter: Optional[Drafter],
                         spec: dict, dev: Optional[dict]) -> tuple:
    """ONE decode iteration over the active slots: speculative when a
    drafter is configured, no active slot is replaying (a replay rewrites
    k/v through the single-token step that wrote it) and some slot
    drafted; otherwise the plain step with its device-resident tensors.
    The two keep separate device caches keyed by ``kind``. Returns
    (finished, tokens emitted, dev); the caller drops ``dev`` when a
    finished slot leaves the batch."""
    active = sched.active_indices()
    if drafter is not None and not any(sched.slots[i].replaying
                                       for i in active):
        out = run_spec_decode(programs, pages, sched, drafter, spec, dev)
        if out is not None:
            return out
    if dev is None or dev.get("kind") != "plain":
        dev = decode_dev(programs, sched)
    nxt, new_len = programs._decode(
        programs.params, pages, dev["tokens"], dev["lengths"],
        dev["tables"], dev["seeds"], dev["temps"], dev["top_ks"],
        dev["top_ps"], dev["actives"],
        *programs.lora_call_args(dev.get("adapters")),
        stochastic=dev["stochastic"])
    dev["tokens"], dev["lengths"] = nxt, new_len
    nxt_host = nxt.cpu().numpy()
    finished = []
    for slot_idx in active:
        res = sched.record_token(slot_idx, int(nxt_host[slot_idx]),
                                 from_decode=True)
        if res is not None:
            finished.append(res)
    return finished, len(active), dev


def horizon_dev(programs: "ModelPrograms", sched: Scheduler) -> dict:
    """The device-resident tensors of a decode horizon (kind "horizon"):
    the plain set plus the per-slot budget and EOS lanes the in-device
    masks read. Built at a horizon boundary, where host and device agree;
    between boundaries each horizon's outputs feed the next one's inputs
    without a read-back."""
    return decode_dev(programs, sched, "horizon",
                      _DEV_KEYS + ("budgets", "eos_ids"))


def dispatch_horizon(programs: "ModelPrograms", pages: dict,
                     sched: Scheduler, dev: dict, k: int) -> dict:
    """Launch ONE K-step horizon without waiting for it. The block tables
    upload every dispatch (they are host-owned and may have grown through
    ``reserve_horizon``); tokens, lengths, live lanes and budgets stay on
    the device. A slot that finished inside a block not yet booked is
    dead on the device, so its stale table row is masked to the trash
    page there and its freed pages may go to a later admission.

    On the card the ``[n_slots, k]`` block is copied to pinned host
    memory behind an event right after its kernels, so booking it waits
    for this horizon alone and not for one launched after it. Returns
    the in-flight record :func:`process_horizon_block` books."""
    tables = np.zeros((sched.n_slots, sched.max_pages), np.int32)
    active = []
    for i in sched.active_indices():
        tables[i] = sched.table_row(i)
        active.append((i, sched.slots[i].request.request_id))
    dev["tables"] = programs.to_device(tables)
    (block, dev["tokens"], dev["lengths"], dev["actives"],
     dev["budgets"]) = programs.horizon_for(k)(
        programs.params, pages, dev["tokens"], dev["lengths"],
        dev["tables"], dev["seeds"], dev["temps"], dev["top_ks"],
        dev["top_ps"], dev["actives"], dev["budgets"], dev["eos_ids"],
        *programs.lora_call_args(dev.get("adapters")),
        stochastic=dev["stochastic"])
    done = None
    if block.is_cuda:
        host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
        host.copy_(block, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        block = host
    return {"block": block, "done": done, "k": k, "active": active}


def process_horizon_block(sched: Scheduler, inflight: dict) -> tuple:
    """Book one horizon's ``[n_slots, k]`` token block: the ONE blocking
    read of a horizon. Each slot's tokens record in order through the
    same ``record_token`` the K = 1 path uses and stop at the first
    finish (its eos-then-budget rule is the device's live-mask update, so
    the host stops where the lane died). A slot that finished in an
    earlier block, or was evicted at a boundary, is skipped by request
    id. Returns (finished, tokens emitted)."""
    if inflight["done"] is not None:
        inflight["done"].synchronize()
    block = inflight["block"].numpy()
    finished, emitted = [], 0
    for slot_idx, rid in inflight["active"]:
        slot = sched.slots[slot_idx]
        if slot is None or slot.request.request_id != rid:
            continue
        for j in range(inflight["k"]):
            res = sched.record_token(slot_idx, int(block[slot_idx, j]),
                                     from_decode=True)
            emitted += 1
            if res is not None:
                finished.append(res)
                break
    return finished, emitted


def build_kv_report(programs: "ModelPrograms", *, page_size: int,
                    pool: PagePool, cached_pages: int, n_slots: int,
                    max_pages: int, pool_bytes: int,
                    tier: Optional[HostTier] = None,
                    decode_horizon: int = 1) -> dict:
    """The byte table for one engine's pool, priced at its own kv_dtype
    (scales included under int8) beside the fp32 per-page cost, and the
    horizon's price: one host read of ``[n_slots, K]`` int32 per K
    steps. With a host tier: its budget, occupancy, spilled pages and the
    pages its budget buys at this pool's per-page cost."""
    kv_dtype = programs.kv_dtype
    per_page = kv_page_bytes(programs.config, page_size=page_size,
                             kv_dtype=kv_dtype)
    per_page_fp32 = kv_page_bytes(programs.config, page_size=page_size,
                                  kv_dtype="fp32")
    shards = programs.kv_shards
    tier_rows = {} if tier is None else {
        "host_tier_budget_bytes": tier.budget_bytes,
        "host_tier_bytes": tier.bytes_used,
        "host_tier_spilled_pages": tier.spilled_pages,
        "host_tier_page_capacity": (tier.budget_bytes // per_page
                                    if per_page else 0),
    }
    return {
        **tier_rows,
        "page_size": page_size,
        "pool_dtype": kv_dtype,
        "n_pages": pool.n_pages,
        "pages_free": pool.n_free,
        "pages_cached": cached_pages,
        "bytes_per_page": per_page,
        "bytes_per_page_fp32": per_page_fp32,
        "bytes_vs_fp32": round(per_page / per_page_fp32, 4),
        "kv_shards": shards,
        "bytes_per_page_per_chip": per_page // shards,
        "pool_bytes": pool_bytes,
        "dense_equivalent_bytes": kv_page_bytes(
            programs.config, page_size=page_size,
            n_pages=n_slots * max_pages, kv_dtype=kv_dtype),
        "decode_horizon": decode_horizon,
        "horizon_block_bytes": n_slots * decode_horizon * 4,
        "dispatches_per_step": round(1 / decode_horizon, 4),
    }


def build_weight_report(programs: "ModelPrograms") -> dict:
    """The byte table for one engine's weights, priced at their storage
    dtype (int8 scales included) beside the fp32 cost.
    ``publish_payload_bytes`` is what a stored-layout export moves,
    ``publish_payload_bytes_fp`` the fp-layout payload a trainer would
    hand over."""
    by_dtype = weight_bytes_by_dtype(programs._fp_layout,
                                     getattr(programs.bundle, "family", None))
    stored = params_nbytes(programs._stored_layout)
    return {
        "weight_dtype": programs.weight_dtype,
        "weight_bytes": stored,
        "weight_bytes_fp32": by_dtype["fp32"],
        "bytes_vs_fp32": round(stored / by_dtype["fp32"], 4),
        "weight_bytes_by_dtype": by_dtype,
        "publish_payload_bytes": stored,
        "publish_payload_bytes_fp": params_nbytes(programs._fp_layout),
    }


def build_adapter_report(programs: "ModelPrograms") -> dict:
    """The byte table for one engine's adapter pool (empty without one).
    ``bytes_per_adapter`` is also the payload of one adapter publish: it
    moves one slot's leaves, never the base weights."""
    pool = programs.adapter_pool
    if pool is None:
        return {}
    per = adapter_nbytes(programs.config, rank=pool.rank,
                         targets=pool.targets, bundle=programs.bundle)
    return {
        "max_adapters": pool.max_adapters,
        "rank": pool.rank,
        "targets": list(pool.targets),
        "bytes_per_adapter": per,
        "pool_bytes": pool.max_adapters * per,
        "publish_payload_bytes": per,
        "adapters_live": pool.n_live,
        "adapters_free": pool.n_free,
    }


def _leaf_items(tree, prefix: str = ""):
    """(path, tensor) of every leaf, a ``Quantized`` leaf as its payload
    and its scales (``<path>.q`` / ``<path>.scale``): the layout that a
    publish must match."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaf_items(tree[k], f"{prefix}/{k}" if prefix
                                   else str(k))
    elif hasattr(tree, "q") and hasattr(tree, "scale"):
        yield f"{prefix}.q", tree.q
        yield f"{prefix}.scale", tree.scale
    else:
        yield prefix, tree


def _torch_dtype(x) -> torch.dtype:
    """A torch tensor's dtype, or the torch dtype of a numpy array's
    (ml_dtypes' bfloat16 included)."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


def _check_layout(new_params, layout, what: str) -> None:
    """Every leaf of ``new_params`` against ``layout``'s, by path, shape
    and dtype, naming the first leaf that differs."""
    want = dict(_leaf_items(layout))
    got = dict(_leaf_items(new_params))
    if list(want) != list(got):
        missing = sorted(set(want) - set(got))[:3]
        extra = sorted(set(got) - set(want))[:3]
        raise ValueError(
            f"published params tree does not match the {what}: missing "
            f"{missing}, unexpected {extra} — a stale-layout publish would "
            f"produce garbage tokens, not an error, so it is refused here")
    for name, leaf in got.items():
        ref = want[name]
        if tuple(leaf.shape) != tuple(ref.shape):
            raise ValueError(
                f"published leaf {name} has shape {tuple(leaf.shape)} but "
                f"the {what} expects {tuple(ref.shape)}")
        dtype = _torch_dtype(leaf)
        if dtype != ref.dtype:
            raise ValueError(
                f"published leaf {name} has dtype {dtype} but the {what} "
                f"expects {ref.dtype}")


def _fits(new_params, layout) -> bool:
    try:
        _check_layout(new_params, layout, "layout")
    except ValueError:
        return False
    return True


def fp_layout(params):
    """The shapes and dtypes of a param tree as meta tensors (nothing
    allocated); a quantized leaf as its payload's and scales'."""
    if isinstance(params, dict):
        return {k: fp_layout(v) for k, v in params.items()}
    if hasattr(params, "q") and hasattr(params, "scale"):
        return type(params)(q=fp_layout(params.q),
                            scale=fp_layout(params.scale))
    return torch.empty(params.shape, dtype=params.dtype, device="meta")


def check_page_geometry(programs: "ModelPrograms", page_size: int) -> None:
    """On the card every paged attend is the kernel, never the gather path,
    so the model's head_dim and the page size must be ones K4 takes: every
    head_dim of an in-code preset (gpt-neox-20b's 96 too) and any page of
    1 to ``MAX_PAGE`` positions."""
    head = programs.config.head_size
    if (programs.device.type == "cuda"
            and not paged_decode_eligible(head, page_size)):
        raise ValueError(
            f"head_dim {head} / page_size {page_size}: the paged kernel "
            f"takes head_dim in {HEAD_DIMS} and pages of 1 to {MAX_PAGE} "
            f"positions")


def drop_stale_kv(scheds, tier: Optional[HostTier],
                  ns: Optional[int] = None) -> int:
    """Free the prefix-cache pages of ``scheds`` (a shared cache object
    once) and drop the host tier's spilled prefix records: every
    namespace after a params publish (``ns=None``), one adapter slot's
    when a new tenant takes it. All of it holds k/v computed under the
    weights just replaced (the JAX engine keeps the cache across a params
    publish, and the tier's records across both: a prompt that hits them
    decodes from stale k/v). Returns the pages and records dropped."""
    dropped, seen = 0, set()
    for sched in scheds:
        cache = sched.cache
        if cache is not None and id(cache) not in seen:
            seen.add(id(cache))
            dropped += (cache.drop_all() if ns is None
                        else cache.drop_namespace(ns))
    if tier is not None:
        for key in tier.keys():
            if key[0] == "prefix" and (ns is None or key[1] == ns):
                dropped += tier.drop(key)
    return dropped


# the device programs every rank of a plan runs: broadcast name -> the
# ``ModelPrograms`` method, registered by ``_program``
PROGRAMS: dict = {}


def _program(name: str, *, factory: bool = False):
    """Registers a ``ModelPrograms`` method as the device program
    ``name``. On rank 0 of a plan over several ranks each call is
    broadcast before it runs; a ``factory`` returns the program for its
    key arguments (a bucket, a horizon), and each call of what it returns
    is broadcast with that key. A follower's ``program(key)`` reads
    ``PROGRAMS``."""
    def register(method):
        PROGRAMS[name] = method

        @functools.wraps(method)
        def call(self, *args, **kwargs):
            if self._channel is None or not self._channel.leader:
                return method(self, *args, **kwargs)
            if factory:
                return self._broadcasting((name, args, kwargs),
                                          method(self, *args, **kwargs))
            return self._broadcasting((name,), functools.partial(
                method, self))(*args, **kwargs)
        return call
    return register


class ModelPrograms:
    """The engine's programs for one (model, params, device): the batched
    decode step, the bucketed prefill, the chunk program, the commit and
    copy scatters and the batch-1 sampler — eager calls where the JAX
    package compiles programs.

    Under a ``plan`` (``serve/sharding.py``) params are this rank's shards
    and the forwards run through a ``ServeLayout``; ``shard_kv=True``
    splits each pool on its kv heads over tp. Over more than one rank,
    rank 0 broadcasts every program call before it runs it
    (``@_program``), and the other ranks run ``follow()`` until rank 0's
    ``release()``."""

    def __init__(self, bundle: ModelBundle, params, *, device=None,
                 attend_impl: str = "auto", kv_dtype=None, weight_dtype=None,
                 plan=None, shard_kv: bool = False,
                 max_adapters: Optional[int] = None, adapter_rank: int = 8,
                 adapter_alpha: float = 16.0,
                 adapter_targets=DEFAULT_TARGETS):
        if shard_kv:
            validate_kv_shard(plan, bundle.config)
        self.plan = plan
        self.shard_kv = bool(shard_kv)
        self.mod = family_module(bundle.family)
        if max_adapters is not None and not hasattr(self.mod, "_lora_sort"):
            raise ValueError(
                f"family {bundle.family!r} has no batched multi-LoRA "
                f"decode path — max_adapters needs the grouped-GEMM lora "
                f"hooks in models/llama.py")
        self.device = resolve_device(device)
        if attend_impl not in ("auto", "flash", "xla"):
            raise ValueError(f"attend_impl must be 'auto', 'flash' or "
                             f"'xla', got {attend_impl!r}")
        if attend_impl == "xla" and self.device.type != "cpu":
            raise ValueError(
                "attend_impl='xla' (the gather path) is accepted only with "
                "device='cpu': on the card every paged attend runs the "
                "CUDA kernel")
        self.attend_impl = attend_impl
        self.bundle = bundle
        self.config = bundle.config
        self.kv_dtype = kv_dtype_name(self.config, kv_dtype)
        # the param storage ("fp32" | "bf16" | "int8"); None inherits the
        # param dtype and transforms nothing. int8 leaves are Quantized
        # containers, dequantized inside the products (serve/weights.py)
        self.weight_dtype = weight_dtype_name(self.config, weight_dtype)
        if weight_dtype is not None and self.weight_dtype == "int8":
            require_llama(bundle.family)    # before anything moves
        self._fp_layout = fp_layout(params)

        def place(tree):
            if isinstance(tree, dict):
                return {k: place(v) for k, v in tree.items()}
            return tree.to(self.device)

        params = place(params)
        self._transforms = weight_dtype is not None
        if self._transforms:                # quantize on the device
            params = store_weights(params, self.weight_dtype,
                                   family=bundle.family)
        # the whole stored layout, what a publish must match
        self._stored_layout = fp_layout(params)
        # under a plan: this rank's shards, the layout its forwards run
        # through, and the channel rank 0 leads the other ranks over
        self.layout = None
        self._channel = None
        self._specs = None
        self._pools: list = []          # pool id -> pools dict
        self._pool_ids: dict = {}       # id(pools dict) -> pool id
        if plan is not None:
            import torch.distributed as dist

            from ..train.state import named_leaves

            self._specs = dict(named_leaves(plan.param_specs(
                bundle.logical_axes(), bundle.shapes())))
            self.layout = ServeLayout(plan, self._specs, self.config,
                                      self.mod.LAYOUT_PATHS,
                                      shard_kv=self.shard_kv)
            params = shard_params(plan, self._specs, params)
            if dist.get_world_size() > 1:
                self._channel = Channel()
        self.params = params
        # publish bookkeeping (post-training, post/loop.py): a publish
        # rebinds self.params to copies of the published leaves; every
        # program takes params as an argument, so nothing else changes
        self.publish_count = 0
        self._swap_in_flight = False

        # pooled multi-LoRA adapters (serve/adapters.py): the stacks are
        # program arguments; an insert writes one slot's rows in place
        self.adapter_pool: Optional[AdapterPool] = None
        self.adapter_stacks = None
        self._adapter_shapes = None
        self.adapter_publish_count = 0
        # the host tier an LRU-evicted adapter spills into
        # (``attach_host_tier``); None drops a victim's rows
        self._host_tier: Optional[HostTier] = None
        # the engines serving through these programs (a fleet's replicas
        # share one): a weights change drops every one's stale k/v
        self.kv_holders = weakref.WeakSet()
        if max_adapters is not None:
            self.adapter_pool = AdapterPool(
                max_adapters, rank=adapter_rank, alpha=adapter_alpha,
                targets=adapter_targets)
            self._adapter_shapes = adapter_shapes(
                self.config, rank=adapter_rank, targets=adapter_targets,
                bundle=bundle)
            self.adapter_stacks = init_adapter_stacks(
                self.config, max_adapters=max_adapters, rank=adapter_rank,
                targets=adapter_targets, bundle=bundle, device=self.device)
        # prefill FORWARD count: bucketed prefills and chunk forwards
        self.prefill_calls = 0
        # speculative verify forwards
        self.verify_calls = 0

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # ---- ranks under a plan (serve/sharding.py) ----------------------------
    @property
    def kv_shards(self) -> int:
        """The ranks a pool's kv heads split over (1 without shard_kv)."""
        return int(self.plan.sizes["tp"]) if self.shard_kv else 1

    @property
    def leads(self) -> bool:
        """True on the rank that drives the engine (every rank but the
        followers of a plan over several ranks)."""
        return self._channel is None or self._channel.leader

    def _broadcasting(self, key: tuple, fn):
        """``fn`` broadcast to the followers under ``key`` before each
        call (rank 0). Once broadcast, a failure ends the gang
        (``abort_gang``) rather than leave the followers in the program's
        collectives."""
        def call(*args, **kwargs):
            self._channel.send((key, sharding_encode(self, args),
                                sharding_encode(self, kwargs)))
            try:
                return fn(*args, **kwargs)
            except BaseException:
                abort_gang(f"rank 0 failed in program {key[0]!r} after "
                           f"broadcasting it")
        return call

    def program(self, key: tuple):
        """The program a broadcast ``key`` names (a follower's side):
        ``(name,)`` for a method, ``(name, args, kwargs)`` for a
        factory's program."""
        method = PROGRAMS[key[0]]
        if len(key) == 1:
            return functools.partial(method, self)
        return method(self, *key[1], **key[2])

    def follow(self) -> int:
        """A follower rank's loop (``serve/sharding.py:follow``)."""
        return sharding_follow(self)

    def release(self) -> None:
        """Stop the followers (rank 0; a no-op elsewhere and without
        followers). Idempotent."""
        if self._channel is not None and self._channel.leader:
            self._channel.send((("stop",), (), {}))
            self._channel = None

    def drop_shared_kv(self, ns: Optional[int] = None) -> int:
        """``drop_cached_kv(ns)`` on every engine serving through these
        programs: a publish, an eviction or a restore through one replica
        changes the weights (or a slot's tenant) under its siblings too,
        whose prefix caches and tier records would otherwise serve k/v
        computed under the old ones. Returns the pages and records
        dropped."""
        return sum(e.drop_cached_kv(ns) for e in list(self.kv_holders))

    # ---- weight publishing (the post-training seam) ------------------------
    @contextlib.contextmanager
    def swap_guard(self):
        """Marks an engine-generation swap in flight on these programs.
        ``publish_params`` and ``publish_adapter`` refuse while it is held:
        a swap replays preempted sequences bitwise through these programs,
        and weights changed mid-swap would make the replayed tokens diverge
        from the recorded ones."""
        if self._swap_in_flight:
            raise RuntimeError("an engine generation swap is already in "
                               "flight on this ModelPrograms")
        self._swap_in_flight = True
        try:
            yield self
        finally:
            self._swap_in_flight = False

    def _refuse_mid_swap(self, what: str) -> None:
        if self._swap_in_flight:
            raise RuntimeError(
                f"cannot publish {what} while an engine generation swap is "
                f"in flight: the swap replays in-flight sequences bitwise "
                f"through these programs, and new weights mid-swap would "
                f"corrupt every replayed stream — publish before the swap "
                f"or after it completes")

    def _copy_tree(self, tree):
        """Copies of every leaf on the engine's device (never an alias:
        the trainer goes on updating its own tensors in place)."""
        if isinstance(tree, dict):
            return {k: self._copy_tree(v) for k, v in tree.items()}
        if hasattr(tree, "q") and hasattr(tree, "scale"):
            return type(tree)(q=self._copy_tree(tree.q),
                              scale=self._copy_tree(tree.scale))
        if not isinstance(tree, torch.Tensor):
            return _to_torch(tree, self.device, None)    # a fresh copy
        return tree.detach().to(self.device, copy=True)

    def publish_params(self, new_params) -> int:
        """Swap refreshed parameters into every program: the trainer ->
        engine seam of the post-training loop (``post/loop.py``). The
        programs take params as an argument, so a publish is a rebind of
        ``self.params`` to copies of the published leaves.

        The incoming tree must match the engine's layout leaf by leaf
        (path, shape, dtype); a mismatch fails naming the leaf. An engine
        that transforms its weights (``weight_dtype=``) also takes the fp
        layout a trainer produces and stores it again through
        ``serve/weights.py:store_weights`` (int8: re-quantized). Refused
        while a generation swap is in flight (``swap_guard``). Returns the
        new publish count."""
        self._refuse_mid_swap("params")
        try:
            _check_layout(new_params, self._stored_layout, "engine's layout")
            as_stored = True
        except ValueError:
            if not (self._transforms and _fits(new_params, self._fp_layout)):
                raise
            as_stored = False
        self._install_params(new_params, as_stored)
        self.publish_count += 1
        return self.publish_count

    @_program("publish_params")
    def _install_params(self, new_params, as_stored: bool) -> None:
        """Copies of a checked publish as ``self.params``: stored again
        through ``store_weights`` unless ``as_stored``, this rank's shards
        under a plan."""
        with torch.no_grad():
            if as_stored:
                stored = self._copy_tree(new_params)
            else:
                stored = store_weights(self._copy_tree(new_params),
                                       self.weight_dtype,
                                       family=self.bundle.family)
            if self.plan is not None:
                stored = shard_params(self.plan, self._specs, stored)
            self.params = stored

    # ---- adapter publishing (the multi-tenant seam) ------------------------
    @_program("adapter_insert")
    def _adapter_insert(self, payload: dict, slot: int) -> None:
        """One adapter's leaves into the stacked pool at ``slot``, in place
        (the stacks keep their storage), cast to the stacks' fp32. Copies:
        the caller keeps its tree. Every rank keeps the whole stacks."""
        with torch.no_grad():
            for t, pair in self.adapter_stacks.items():
                for leaf in ("a", "b"):
                    src = payload[t][leaf]
                    if not isinstance(src, torch.Tensor):
                        src = _to_torch(src, self.device, torch.float32)
                    pair[leaf][:, slot].copy_(src.detach())

    def publish_adapter(self, adapter_params, *, name: Optional[str] = None,
                        slot: Optional[int] = None) -> int:
        """Insert (or republish) ONE tenant adapter into the stacked pool:
        validated per leaf against the pool's (rank, targets) geometry and
        refused while a generation swap is in flight. ``slot=None`` claims
        a slot (LRU-evicting an idle adapter under pressure); a live
        ``slot`` republishes that tenant in place. The payload is
        ``models/lora.py``'s ``params['lora']`` layout. Returns the slot id
        requests carry as ``adapter_id``."""
        if self.adapter_pool is None:
            raise ValueError(
                "this engine serves no adapter pool (built with "
                "max_adapters=None) — adapters cannot be published into "
                "it; rebuild with max_adapters=")
        self._refuse_mid_swap("an adapter")
        validate_adapter_params(self._adapter_shapes, adapter_params)
        pool = self.adapter_pool
        if slot is None:
            slot = pool.alloc(name)
            if slot is None:
                raise RuntimeError(
                    f"adapter pool exhausted: all {pool.capacity} tenant "
                    f"slots are live with in-flight requests — drain a "
                    f"tenant or build the engine with a larger "
                    f"max_adapters")
        else:
            if slot == ZERO_ADAPTER:
                raise ValueError("adapter slot 0 is the zero adapter and "
                                 "is never published into")
            if not pool.is_live(int(slot)):
                raise ValueError(
                    f"adapter slot {slot} is not live — omit slot= to "
                    f"allocate one, or publish into a live slot "
                    f"({pool.live_slots()}) to refresh that tenant")
            slot = int(slot)
            pool.mark_update(slot)
        self._adapter_insert(adapter_params, slot)
        self.adapter_publish_count += 1
        return slot

    def attach_host_tier(self, tier) -> None:
        """Install the host tier on the adapter eviction path: an LRU
        eviction (an insert past ``max_adapters`` recycling an idle
        tenant's slot) copies the victim's A / B rows into the tier, and
        ``restore_adapter`` re-inserts them on the next reference."""
        self._host_tier = tier
        if self.adapter_pool is not None:
            self.adapter_pool.on_evict = self._spill_adapter

    def _spill_adapter(self, slot: int, name) -> None:
        """``AdapterPool.on_evict``: the victim slot's fp32 rows to the
        host, bitwise, before the incoming insert overwrites them."""
        if self._host_tier is None or self.adapter_stacks is None:
            return
        payload = {f"{t}.{leaf}": pair[leaf][:, slot].to("cpu", copy=True)
                   for t, pair in self.adapter_stacks.items()
                   for leaf in ("a", "b")}
        self._host_tier.put(("adapter", name), payload, pages=0,
                            meta={"slot": int(slot)})

    def restore_adapter(self, name) -> Optional[int]:
        """Re-insert a spilled tenant from the host tier into a (possibly
        LRU-recycled) slot through the publish's own insert: the stack
        rows land bitwise what the spill copied. Returns the new slot, or
        None when the tier holds no record for ``name`` or every slot is
        live with requests in flight."""
        if self.adapter_pool is None or self._host_tier is None:
            return None
        # hold the record BEFORE the alloc: the alloc may LRU-evict
        # another tenant, whose spill could push this record out of the
        # byte budget
        rec = self._host_tier.get(("adapter", name))
        if rec is None:
            return None
        slot = self.adapter_pool.alloc(name)
        if slot is None:
            return None
        self._host_tier.take(("adapter", name))
        self._adapter_insert(
            {t: {leaf: rec.payload[f"{t}.{leaf}"] for leaf in ("a", "b")}
             for t in self.adapter_stacks}, slot)
        return slot

    def _lora_kw(self, lora_args) -> dict:
        """The ``lora=`` keyword of the family forwards from the optional
        trailing ``(stacks, adapters)`` program arguments: none without a
        pool, so an adapter-free engine runs exactly the pre-adapter
        forward."""
        if not lora_args:
            return {}
        stacks, adapters = lora_args
        return {"lora": {"scale": self.adapter_pool.scale,
                         "adapters": adapters, "stacks": stacks,
                         "impl": "auto"}}

    def lora_call_args(self, adapters) -> tuple:
        """Trailing program arguments for one forward: ``()`` without a
        pool, else ``(stacks, adapters)`` with the adapter vector on the
        device (a tensor already there is passed as it is)."""
        if self.adapter_pool is None:
            return ()
        if isinstance(adapters, torch.Tensor):
            adapters = adapters.to(self.device)     # a no-op where it is
        else:
            adapters = self.to_device(np.asarray(adapters, np.int32))
        return (self.adapter_stacks, adapters)

    @_program("init_pages")
    def init_device_pages(self, n_pages: int, page_size: int) -> dict:
        """Zeroed pools on every rank: this rank's kv heads under
        ``shard_kv``, every head otherwise."""
        pages = init_pages(self.config, n_pages, page_size,
                           kv_dtype=self.kv_dtype, device=self.device,
                           kv_heads=kv_heads_here(self.config, self.plan,
                                                  self.shard_kv))
        if self._channel is not None:
            self._pool_ids[id(pages)] = len(self._pools)
            self._pools.append(pages)
        return pages

    def make_attend(self, tables, lengths, *, n_valid=None):
        attend = make_attend(tables, lengths, impl=self.attend_impl,
                             n_valid=n_valid)
        return attend if self.layout is None else self.layout.attend(attend)

    def _fwd_kw(self) -> dict:
        """The family forwards' ``layout=`` under a plan (none without)."""
        return {} if self.layout is None else {"layout": self.layout}

    def _kv_cache(self, bucket: int) -> dict:
        """The dense [L, 1, bucket, Hkv, D] prefill cache, of the kv heads
        this rank's projections give it under a plan."""
        cfg = self.config
        heads = (getattr(cfg, "num_kv_heads", cfg.num_heads)
                 if self.layout is None else self.layout.kv_heads_local())
        shape = (cfg.num_layers, 1, bucket, heads, cfg.head_size)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device)}

    @_program("fork")
    def fork(self, pages: dict, src: int, dst: int) -> None:
        """Copy-on-write: page ``src`` copied into ``dst`` (each rank its
        pool's heads)."""
        copy_pages(pages["k"], pages["v"], src, dst)

    def gather_pages(self, pages: dict, page_ids) -> dict:
        """Bitwise host copy of the given pages, every pool leaf and every
        kv head: under ``shard_kv`` each rank's head slice gathered over tp
        (every rank takes part)."""
        if not self.shard_kv:
            return gather_payload(pages, list(page_ids))
        return self._gather_heads(pages, list(page_ids))

    @_program("gather")
    def _gather_heads(self, pages: dict, page_ids: list) -> dict:
        return gather_sharded_payload(pages, page_ids, self.layout.tp_group)

    @_program("scatter")
    def scatter_pages(self, pages: dict, page_ids, payload: dict) -> None:
        """Seat a whole payload (every kv head) into the given pages of
        every rank's pool: its heads under ``shard_kv``."""
        if self.shard_kv:
            payload = head_slice(payload, self.layout.tp_rank,
                                 kv_heads_here(self.config, self.plan, True))
        scatter_payload(pages, list(page_ids), payload)

    @_program("decode")
    def _decode(self, params, pages, tokens, lengths, tables, seeds, temps,
                top_ks, top_ps, actives, *lora_args, stochastic: bool):
        """The batched decode step; the pools update in place. Returns the
        next step's (tokens, lengths)."""
        attend = self.make_attend(tables, lengths)
        logits, _ = self.mod.paged_decode_step(
            self.config, params, tokens[:, None], lengths, pages, attend,
            **self._lora_kw(lora_args), **self._fwd_kw())
        nxt = _sample_tokens(logits.float(), seeds, lengths + 1, temps,
                             top_ks, top_ps, stochastic=stochastic)
        nxt = torch.where(actives, nxt, 0)
        return nxt, torch.where(actives, lengths + 1, lengths)

    @_program("horizon", factory=True)
    def horizon_for(self, k: int):
        """The K-step decode horizon: ``fn(params, pages, tokens, lengths,
        tables, seeds, temps, top_ks, top_ps, live, budgets, eos_ids, *,
        stochastic)`` runs K decode steps with no host read between them.
        Each step is ``_decode`` with the live mask threaded through: a
        lane dies where the host's ``record_token`` would finish it (EOS
        first, ``eos_ids >= 0`` guarding the no-EOS case, then the
        budget), after which its table is the trash page (writes and
        reads), its tokens 0 and its length and budget frozen. The draw
        is position-keyed, so the K steps give the tokens K single steps
        give. The pools update in place.

        Returns ``(block [n_slots, K], tokens, lengths, live, budgets)``;
        all but the block are the next horizon's device-resident
        inputs."""
        if k < 1:
            raise ValueError(f"decode horizon must be >= 1, got {k}")

        def fn(params, pages, tokens, lengths, tables, seeds, temps, top_ks,
               top_ps, live, budgets, eos_ids, *lora_args, stochastic: bool):
            block = []
            lora = self._lora_kw(lora_args)
            for _ in range(k):
                eff_tables = torch.where(live[:, None], tables, TRASH_PAGE)
                attend = self.make_attend(eff_tables, lengths)
                logits, _ = self.mod.paged_decode_step(
                    self.config, params, tokens[:, None], lengths, pages,
                    attend, **lora, **self._fwd_kw())
                nxt = _sample_tokens(logits.float(), seeds, lengths + 1,
                                     temps, top_ks, top_ps,
                                     stochastic=stochastic)
                nxt = torch.where(live, nxt, 0)
                budgets = torch.where(live, budgets - 1, budgets)
                hit_eos = (eos_ids >= 0) & (nxt == eos_ids)
                lengths = torch.where(live, lengths + 1, lengths)
                live = live & ~hit_eos & (budgets > 0)
                tokens = nxt
                block.append(nxt)
            return torch.stack(block, dim=1), tokens, lengths, live, budgets

        return fn

    @_program("verify", factory=True)
    def verify_for(self, t: int, greedy: bool = False):
        """The speculative verify forward: ``fn(params, pages, ids [S, t],
        lengths, tables, seeds, temps, top_ks, top_ps, actives, n_valid)``.
        Row 0 of each slot is its newest sampled token, rows 1.. the
        drafter's candidates, zero-padded; ``n_valid`` [S] sends each pad
        tail's writes to the trash page, as ``chunk_for`` does. ONE
        forward through the paged path (K4 at T = t on the card) with the
        logits of every position, and the position-keyed target draw at
        every row: ``targets[s, j]`` is what the decode step would sample
        at position ``lengths[s] + 1 + j`` (the argmax under ``greedy``,
        which the engine picks when every active slot is at temperature
        0). ``n_acc`` counts the leading drafts equal to their target, and
        ``new_lengths`` is ``lengths + n_acc + 1`` on the active slots,
        computed on the device. Returns (targets [S, t], n_acc [S],
        new_lengths [S]); the pools update in place."""
        def fn(params, pages, ids, lengths, tables, seeds, temps, top_ks,
               top_ps, actives, n_valid, *lora_args):
            attend = self.make_attend(tables, lengths, n_valid=n_valid)
            logits, _ = self.mod.paged_decode_step(
                self.config, params, ids, lengths, pages, attend,
                all_logits=True, **self._lora_kw(lora_args),
                **self._fwd_kw())
            logits = logits.float()
            s = ids.shape[0]
            steps = torch.arange(t, device=ids.device)
            if greedy:
                targets = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                def rows(x):
                    return x[:, None].expand(s, t).reshape(s * t)

                pos = (lengths[:, None] + 1 + steps[None, :]).reshape(s * t)
                targets = _sample_tokens(
                    logits.reshape(s * t, -1), rows(seeds), pos, rows(temps),
                    rows(top_ks), rows(top_ps), stochastic=True).reshape(s, t)
            targets = torch.where(actives[:, None], targets, 0)
            matches = ((ids[:, 1:] == targets[:, :-1])
                       & (steps[None, :-1] < (n_valid - 1)[:, None]))
            n_acc = torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1)
            new_lengths = torch.where(actives, lengths + n_acc + 1, lengths)
            return targets, n_acc.to(torch.int32), new_lengths.to(
                lengths.dtype)

        return fn

    def _prefill(self, params, ids, last_pos, lora_args, bucket: int):
        cache = self._kv_cache(bucket)
        logit, cache = self.mod.prefill(self.config, params, ids, cache,
                                        last_pos=last_pos,
                                        **self._lora_kw(lora_args),
                                        **self._fwd_kw())
        kd, vd = cache["k"][:, 0], cache["v"][:, 0]
        if self.layout is not None and not self.shard_kv:
            # the whole pool on every rank: every kv head of the prompt
            hkv = self.layout.hkv
            kd = self.layout.whole_heads(kd, hkv, 2)
            vd = self.layout.whole_heads(vd, hkv, 2)
        return logit[0], kd, vd

    @_program("prefill", factory=True)
    def prefill_for(self, bucket: int):
        """The bucketed prefill: ``fn(params, ids [1, bucket], last_pos,
        *lora_args)`` -> (logits [V], k [L, bucket, Hkv, D], v [L, bucket,
        Hkv, D]) (this rank's kv heads under ``shard_kv``)."""
        def fn(params, ids, last_pos, *lora_args):
            return self._prefill(params, ids, last_pos, lora_args, bucket)

        return fn

    @_program("bucket_prefill", factory=True)
    def bucket_prefill(self, bucket: int):
        """The bucketed prefill and its commit scatter in one program:
        ``fn(params, pages, ids [1, bucket], last_pos, table_row [M], n,
        start, *lora_args)`` writes positions ``start .. n`` of the
        prompt's k/v into the slot's pages (each rank its pool's heads)
        and returns the real last token's logits."""
        def fn(params, pages, ids, last_pos, table_row, n, start,
               *lora_args):
            logit, kd, vd = self._prefill(params, ids, last_pos, lora_args,
                                          bucket)
            commit_prefill(pages["k"], pages["v"], kd, vd, table_row, n,
                           start)
            return logit

        return fn

    @_program("chunk", factory=True)
    def chunk_for(self, t: int):
        """The chunk program: ``fn(params, pages, ids [1, t], start [1],
        table [1, M], last_index, n_valid [1], *lora_args)`` runs the paged
        path, writing the chunk's k/v into the slot's pages while attending
        over the committed history; returns the real last token's
        logits."""
        def fn(params, pages, ids, start, table, last_index, n_valid,
               *lora_args):
            attend = self.make_attend(table, start, n_valid=n_valid)
            logits, _ = self.mod.paged_decode_step(
                self.config, params, ids, start, pages, attend,
                last_index=last_index, **self._lora_kw(lora_args),
                **self._fwd_kw())
            return logits[0]

        return fn

    def sample_one(self, logit, request: Request, position: int) -> int:
        """Batch-1 sample off prefill logits (the request's first token)."""
        def one(x, dtype):
            return torch.tensor([x], dtype=dtype, device=self.device)

        tok = _sample_tokens(
            logit.float()[None], one(request.seed, torch.int32),
            one(position, torch.int32), one(request.temperature,
                                            torch.float32),
            one(request.top_k, torch.int32), one(request.top_p,
                                                 torch.float32),
            stochastic=request.temperature > 0)
        return int(tok[0])

    def check_prompt(self, request: Request) -> None:
        """Range-check prompt ids: the embedding lookup would raise on an
        out-of-range id mid-flight (jax would clamp it)."""
        v = self.config.vocab_size
        bad = [t for t in request.prompt_ids if not 0 <= int(t) < v]
        if bad:
            raise ValueError(
                f"prompt ids {bad[:5]} out of range for vocab_size {v}")


class ServeEngine:
    """Multi-request generation over a model family's paged decode (every
    family: gpt2, llama, moe, neox).

    Drive it through ``serve/api.py`` (``generate_many`` / ``serve_http``)
    or directly: ``submit(Request(...))`` then ``step()`` in a loop — each
    step is one scheduler iteration (deadline expiry, admission, prefill
    work, growth with preemption, one batched decode or one decode
    horizon) and returns what finished. ``device`` defaults to ``cuda``;
    ``device="cpu"`` runs the plain PyTorch path. The other knobs mean
    what they mean in the JAX engine: ``prefix_cache`` (copy-on-write
    prefix sharing), ``prefill_chunk``, ``prefill_buckets``,
    ``attend_impl``, ``kv_dtype`` ("fp32" | "bf16" | "int8"),
    ``weight_dtype`` ("fp32" | "bf16" | "int8"), ``max_queue`` (submits
    past it are refused with a 429-class ``RefusalError``), ``programs``
    (a shared :class:`ModelPrograms`, whose device and dtypes then win),
    ``speculate`` ("ngram" at depth ``spec_k``, or a ``serve/spec.py``
    Drafter), ``decode_horizon`` (K fused decode steps per host read;
    not together with speculation) and ``max_adapters`` (a pool of LoRA
    tenants of rank ``adapter_rank`` on ``adapter_targets``, scale
    ``adapter_alpha / adapter_rank``, llama family: ``publish_adapter``,
    then ``Request(adapter_id=...)``), ``host_tier_bytes`` (a host-RAM
    tier of that budget, ``serve/tiering.py``: evicted prefix pages,
    preempted sequences and LRU-evicted adapters spill there and are
    restored bitwise ahead of admission). ``publish_params`` swaps the
    weights between rollout batches (``post/loop.py``); ``resubmit``,
    ``gather_pages`` and ``scatter_pages`` are the fleet's seams
    (``serve/router.py``, ``serve/disagg.py``, ``serve/elastic.py``)."""

    def __init__(self, bundle: ModelBundle, params, *, n_slots: int = 8,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 max_len: Optional[int] = None,
                 prefill_buckets: Optional[tuple] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True, attend_impl: str = "auto",
                 kv_dtype=None, weight_dtype=None, device=None, plan=None,
                 shard_kv: bool = False, max_queue: Optional[int] = None,
                 programs: Optional[ModelPrograms] = None, speculate=None,
                 spec_k: int = 4, max_adapters: Optional[int] = None,
                 adapter_rank: int = 8, adapter_alpha: float = 16.0,
                 adapter_targets=DEFAULT_TARGETS,
                 host_tier_bytes: Optional[int] = None,
                 decode_horizon: int = 1):
        if decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, got "
                             f"{decode_horizon}")
        if decode_horizon > 1 and speculate is not None:
            raise ValueError(
                f"speculate={speculate!r} with decode_horizon="
                f"{decode_horizon}: speculative decoding requires K=1 — "
                f"the verify forward is already multi-token. Drop one of "
                f"the two knobs.")
        self.programs = programs if programs is not None else ModelPrograms(
            bundle, params, device=device, attend_impl=attend_impl,
            kv_dtype=kv_dtype, weight_dtype=weight_dtype, plan=plan,
            shard_kv=shard_kv, max_adapters=max_adapters,
            adapter_rank=adapter_rank, adapter_alpha=adapter_alpha,
            adapter_targets=adapter_targets)
        self.device = self.programs.device
        self.programs.kv_holders.add(self)
        # shared programs carry their pool, as they carry their dtypes
        self.adapter_pool = self.programs.adapter_pool
        self.decode_horizon = decode_horizon
        self.drafter = resolve_drafter(speculate, spec_k=spec_k,
                                       n_slots=n_slots, device=self.device)
        self.spec = new_spec_counters()
        self.bundle = self.programs.bundle
        self.kv_dtype = self.programs.kv_dtype
        self.weight_dtype = self.programs.weight_dtype
        self.config = self.programs.config
        self.attend_impl = self.programs.attend_impl
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        _, self.max_model_len, self.max_pages = resolve_context_bounds(
            self.config, max_len, page_size)
        check_page_geometry(self.programs, page_size)
        self.page_size = page_size
        self.n_slots = n_slots
        if n_pages is None:
            # full residency + the trash page
            n_pages = 1 + n_slots * self.max_pages
        pool = PagePool(n_pages, page_size)
        self.scheduler = Scheduler(
            n_slots=n_slots, pool=pool, max_len=self.max_model_len,
            max_pages_per_slot=self.max_pages, prefix_cache=prefix_cache,
            max_queue=max_queue,
            # mid-page prefix reuse needs the chunked path
            allow_partial_share=prefill_chunk is not None,
            # admission headroom for the k speculated tokens a verify
            # writes per running decode
            spec_lookahead=self.drafter.k if self.drafter else 0,
            adapter_pool=self.adapter_pool,
            decode_horizon=decode_horizon)
        if prefill_buckets is None:
            prefill_buckets = default_prefill_buckets(self.max_pages,
                                                      page_size)
        self.prefill_buckets = validate_prefill_buckets(
            prefill_buckets, max_pages=self.max_pages, page_size=page_size,
            max_model_len=self.max_model_len)
        self.pages = self.programs.init_device_pages(n_pages, page_size)
        # host-RAM KV tier (serve/tiering.py): spilled prefix pages and
        # preempted sequences park here instead of being recomputed. A
        # spilled page frees its slot, so the pool identity holds as it
        # is; the tier audits its own byte ledger
        self.host_tier: Optional[HostTier] = None
        if host_tier_bytes is not None:
            self.host_tier = HostTier(host_tier_bytes)
            gather = make_gather(self)
            self.scheduler.attach_tier(self.host_tier, gather)
            if self.scheduler.cache is not None:
                self.scheduler.cache.attach_tier(self.host_tier, gather)
            self.programs.attach_host_tier(self.host_tier)
        self._pending: dict = {}
        self._dev: Optional[dict] = None
        # the launched-but-unbooked horizon: the double buffer's slot
        self._inflight: Optional[dict] = None
        self.draining = False
        self.decode_steps = 0
        self.decode_tokens = 0
        self.host_dispatches = 0
        self.horizon_ksum = 0
        self.stats_seq = 0
        self._lat = LatencyMeter()
        # set_speculation(False) parks the drafter here, so that
        # set_speculation(True) restores the same one
        self._parked_drafter = None

    @property
    def params(self):
        return self.programs.params

    # ---- serving loop ------------------------------------------------------
    def submit(self, request: Request) -> int:
        if self.draining:
            self.scheduler.refuse(
                "draining",
                "engine is draining: finishing in-flight work, not "
                "accepting new requests", http_status=503,
                retry_after_s=self.scheduler.retry_after_hint())
        try:
            self.programs.check_prompt(request)
        except ValueError as exc:
            self.scheduler.refuse("bad_prompt", str(exc))
        return self.scheduler.submit(request)

    def resubmit(self, request: Request, generated=(), *,
                 first_token_at: float = 0.0,
                 submitted_at: Optional[float] = None) -> int:
        """Fence recovery (``serve/router.py``): re-admit a request that
        already ran on a dead or wedged replica. The prompt re-prefills
        and the recorded ``generated`` tokens replay through the decode
        step; replicas share params, so the continuation is
        token-identical to the uninterrupted run. ``submitted_at`` is the
        first client submit time, so TTFT and deadlines do not restart at
        each hop."""
        if self.draining:
            self.scheduler.refuse(
                "draining", "engine is draining: not accepting resubmits",
                http_status=503)
        return self.scheduler.requeue(request, generated,
                                      first_token_at=first_token_at,
                                      submitted_at=submitted_at)

    def drain(self) -> None:
        """Stop admitting; in-flight work runs to completion."""
        self.draining = True

    def set_speculation(self, on: bool) -> bool:
        """Turn speculation on or off at an iteration boundary. Legal
        mid-stream because spec-on emits the target sampler's own draws:
        in-flight sequences go on as they would have. No-op (False) on an
        engine built without a drafter; the admission margin stays at the
        drafter's k while it is parked. Returns whether speculation is on
        after the call."""
        if on and self.decode_horizon > 1:
            raise ValueError(
                f"set_speculation(True) with decode_horizon="
                f"{self.decode_horizon}: speculative decoding requires "
                f"K=1 — set_decode_horizon(1) first")
        if on and self.drafter is None and self._parked_drafter is not None:
            self.drafter = self._parked_drafter
            self._parked_drafter = None
            self._dev = None
        elif not on and self.drafter is not None:
            self._parked_drafter = self.drafter
            self.drafter = None
            self._dev = None
        return self.drafter is not None

    def set_decode_horizon(self, k: int) -> int:
        """Set the decode horizon at an iteration boundary. Legal
        mid-stream because the horizon changes when the host sees tokens,
        not which tokens exist. A launched block books under its own K;
        admission margins follow the new K at once. Returns the horizon
        now in force."""
        if k < 1:
            raise ValueError(f"decode_horizon must be >= 1, got {k}")
        if k > 1 and (self.drafter is not None
                      or self._parked_drafter is not None):
            raise ValueError(
                f"set_decode_horizon({k}) on an engine built with a "
                f"drafter: speculative decoding requires K=1 — the verify "
                f"forward is already multi-token")
        self.decode_horizon = k
        self.scheduler.decode_horizon = k
        return self.decode_horizon

    def _refuse_busy(self, what: str, force: bool) -> None:
        if not force and self.has_work:
            sched = self.scheduler
            resident = (len(sched.active_indices())
                        + len(sched.prefilling_indices()))
            raise RuntimeError(
                f"{what} with {len(sched.queue)} queued + {resident} "
                f"resident sequences in flight: a mid-stream weight swap "
                f"breaks bitwise replay for them (preemption / resubmit "
                f"would rewrite history under new weights) — finish or "
                f"drain first, or pass force=True to accept that")

    def publish_params(self, new_params, *, force: bool = False) -> int:
        """Publish refreshed weights (``ModelPrograms.publish_params``:
        layout-validated, copied). Refused while the engine holds work in
        flight unless ``force``: preemption replay and resubmission assume
        one set of weights per token stream. The on-policy loop publishes
        between rollout batches, when the engine is drained. The prefix
        cache is emptied: its pages hold k/v of the old weights (so are
        those of every engine sharing the programs)."""
        self._refuse_busy("publish_params", force)
        count = self.programs.publish_params(new_params)
        self.programs.drop_shared_kv()
        return count

    def publish_adapter(self, adapter_params, *,
                        name: Optional[str] = None,
                        slot: Optional[int] = None,
                        force: bool = False) -> int:
        """Publish ONE tenant adapter into the pool
        (``ModelPrograms.publish_adapter``). Returns the slot id requests
        carry as ``adapter_id``. Refused while work is in flight unless
        ``force``, as ``publish_params``. The slot's prefix-cache namespace
        is dropped, on every engine sharing the programs: k/v cached under
        its previous tenant must never serve the new one."""
        self._refuse_busy("publish_adapter", force)
        slot_id = self.programs.publish_adapter(adapter_params, name=name,
                                                slot=slot)
        self.programs.drop_shared_kv(slot_id)
        return slot_id

    def drop_cached_kv(self, ns: Optional[int] = None) -> int:
        """Drop the cached k/v that weights just replaced made stale: the
        prefix cache and the host tier's prefix records, of every
        namespace (``ns=None``, a params publish) or of one adapter slot
        (``drop_stale_kv``). Returns the pages and records dropped."""
        return drop_stale_kv([self.scheduler], self.host_tier, ns=ns)

    def evict_adapter(self, slot: int) -> None:
        """Retire a tenant adapter (refused while its requests are in
        flight: ``AdapterPool.evict``) and drop its prefix-cache
        namespace."""
        if self.adapter_pool is None:
            raise ValueError("this engine serves no adapter pool (built "
                             "with max_adapters=None)")
        self.adapter_pool.evict(slot)
        self.programs.drop_shared_kv(slot)

    def restore_adapter(self, name: str):
        """Re-seat a host-spilled adapter's rows into the stacks
        (``ModelPrograms.restore_adapter``). Legal while serving: the
        alloc recycles only idle slots, and the recycled slot's prefix
        namespace is dropped as a publish drops it, on every engine
        sharing the programs."""
        slot_id = self.programs.restore_adapter(name)
        if slot_id is not None:
            self.programs.drop_shared_kv(slot_id)
        return slot_id

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def kv_cache_bytes(self) -> int:
        """Resident KV bytes (scales included): scales with the pool, not
        with n_slots x max_len. Global bytes: under shard_kv each rank
        holds 1/tp of this."""
        return pool_nbytes(self.pages) * self.programs.kv_shards

    def _on_prefill_complete(self, adm: Admission,
                             logit) -> Optional[RequestResult]:
        """The slot joins the decode batch with its first token sampled —
        unless it is a resumed sequence, whose tokens already exist."""
        self._dev = None
        if adm.resumed:
            return None
        t0 = self.programs.sample_one(logit, adm.request, len(adm.tokens))
        return self.scheduler.record_token(adm.slot_idx, t0,
                                           from_decode=False)

    def _horizon_ready(self) -> bool:
        """The active batch may run a K-step horizon: the knob is up, no
        drafter, and no slot is replaying (a replay rewrites k/v through
        the single-token step that wrote it)."""
        sched = self.scheduler
        return (self.decode_horizon > 1 and self.drafter is None
                and not any(sched.slots[i].replaying
                            for i in sched.active_indices()))

    def _pipeline_steady(self) -> bool:
        """The next horizon may launch before the pending one is booked:
        nothing queued, no prefill in flight, no deadline due. Finishes in
        the pending block are fine: their lanes are already dead on the
        device."""
        sched = self.scheduler
        return (not sched.queue and not self._pending
                and not sched.prefilling_indices()
                and not sched.deadline_due())

    def _note_dispatch(self, k: int) -> None:
        self.host_dispatches += 1
        self.horizon_ksum += k
        self.decode_steps += k

    def step(self) -> list:
        """One scheduler iteration: expire deadlines, admit (sharing cached
        prefixes), advance prefill work, grow running decodes (preempting
        on exhaustion), then ONE batched decode step, or one K-step
        horizon. Returns the requests that finished.

        With a horizon the dispatch is double-buffered: in the steady
        state this launches horizon h and only then books h - 1, so the
        device computes h while the host books h - 1. Any scheduler event
        drains the pipeline first (the block books at once and the
        boundary runs on the host's state), so a finished result surfaces
        at most one step after its tokens were computed."""
        if getattr(self, "_publish_pending_swap", False):
            raise RuntimeError(
                "new_generation(params=...) already published the next "
                "policy into this engine's shared programs: stepping it "
                "before swap_generation would decode old-policy k/v under "
                "the new weights; run the swap (or build the new "
                "generation without params=)")
        self.stats_seq += 1
        finished = []
        sched = self.scheduler
        if self._inflight is not None:
            if (self._horizon_ready() and self._pipeline_steady()
                    and self._dev is not None and sched.active_indices()):
                pending_k = self._inflight["k"]
                cov = sched.reserve_horizon(pending_k + self.decode_horizon)
                # less than one step left once the pending block's steps
                # are counted: drain instead of launching a dead horizon
                k_new = min(cov - pending_k, self.decode_horizon,
                            sched.max_remaining_budget() - pending_k)
                if k_new >= 1:
                    nxt = dispatch_horizon(self.programs, self.pages, sched,
                                           self._dev, k_new)
                    self._note_dispatch(k_new)
                    fin, emitted = process_horizon_block(sched,
                                                         self._inflight)
                    self._inflight = nxt
                    self.decode_tokens += emitted
                    self._lat.note(fin)
                    return fin
            # drain: book the pending block now, rebuild the device
            # tensors after the boundary
            fin, emitted = process_horizon_block(sched, self._inflight)
            self._inflight = None
            self._dev = None
            self.decode_tokens += emitted
            finished.extend(fin)
        expired = sched.expire_deadlines()
        if expired:
            self._dev = None
            drop_stale_pending(sched, self._pending)
            finished.extend(expired)
        if self.host_tier is not None:
            # restore ahead of admission: a queued request whose pages
            # sit in the tier seats by scatter (bitwise, replay_pos
            # intact), and the queue head's spilled prefix chain is
            # re-seated in the cache for the admission below to share
            if restore_queued(sched, self.host_tier, self.scatter_pages,
                              self._tier_alloc):
                self._dev = None
            if sched.queue and sched.cache is not None:
                head = sched.queue[0].request
                restore_prefixes(
                    sched.cache, self.host_tier, list(head.prompt_ids),
                    ns=int(getattr(head, "adapter_id", 0) or 0),
                    alloc=self._tier_alloc, scatter=self.scatter_pages,
                    free=sched.pool.free)
        for adm in sched.try_admit():
            self._dev = None
            if adm.fork is not None:
                run_fork(self.programs, self.pages, adm)
            if self.prefill_chunk is None:
                logit = run_bucket_prefill(self.programs, self.pages, sched,
                                           adm, self.prefill_buckets)
                res = self._on_prefill_complete(adm, logit)
                if res is not None:
                    finished.append(res)
            else:
                self._pending[adm.slot_idx] = adm
        if self._pending:
            finished.extend(advance_prefill_chunks(
                self.programs, self.pages, sched, self._pending,
                self.prefill_chunk, self._on_prefill_complete))
        # growth runs last, so every slot in the batch owns the page its
        # next write lands in
        grown, preempted = sched.grow_for_decode()
        if grown or preempted:
            self._dev = None
            if preempted:
                drop_stale_pending(sched, self._pending)
        if sched.active_indices():
            if self._horizon_ready():
                # growth guaranteed every slot's next write, so the
                # reservation only decides how much of K the pool grants;
                # the budget clamp keeps the last horizon from running
                # past every slot's max_new_tokens
                k0 = max(1, min(sched.reserve_horizon(self.decode_horizon),
                                self.decode_horizon,
                                sched.max_remaining_budget()))
                if self._dev is None or self._dev.get("kind") != "horizon":
                    self._dev = horizon_dev(self.programs, sched)
                self._inflight = dispatch_horizon(self.programs, self.pages,
                                                  sched, self._dev, k0)
                self._note_dispatch(k0)
            else:
                fin, emitted, self._dev = run_decode_iteration(
                    self.programs, self.pages, sched, self.drafter,
                    self.spec, self._dev)
                self._note_dispatch(1)
                self.decode_tokens += emitted
                finished.extend(fin)
                if fin:
                    self._dev = None          # a slot left the batch
        self._lat.note(finished)
        return finished

    # ---- host tier plumbing ------------------------------------------------
    def gather_pages(self, page_ids) -> dict:
        """Bitwise host copy of the given pages, every pool leaf (int8
        payload AND scale rows) and every kv head: the tier's and the
        wire's unit."""
        return self.programs.gather_pages(self.pages, page_ids)

    def scatter_pages(self, page_ids, payload) -> None:
        """Seat a gathered payload into this engine's pool at the given
        (freshly allocated) page ids, in place on the pool's stream: it
        lands after any horizon block already queued there. Called on the
        engine's own thread only (a receiver thread never touches a
        pool). The device decode tensors rebuild."""
        self.programs.scatter_pages(self.pages, page_ids, payload)
        self._dev = None

    def _tier_alloc(self, n: int):
        """Allocate ``n`` pages for a restore, refusing unless the free
        list keeps one page of growth headroom per active decode slot: a
        restore never forces a preemption of the running batch."""
        sched = self.scheduler
        headroom = len(sched.active_indices())
        if sched.pool.n_free < n + headroom:
            return None
        return sched.pool.alloc(n)

    # ---- metrics (host-side only) -------------------------------------------
    def partial_tokens(self) -> dict:
        """request_id -> tokens generated so far, for every live sequence
        (lists only grow: a replay rewrites k/v, not tokens)."""
        return collect_partial_tokens([self.scheduler])

    def stats(self) -> dict:
        """Host-side metrics snapshot (no device access, so it answers
        while the worker thread is mid-iteration). The keys are the JAX
        engine's; ``prefix_keys`` feeds the fleet router's directory and
        the adapter pool's keys appear with a pool."""
        sched = self.scheduler
        s = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in sched.stats.items()}
        return {
            **s,
            "stats_seq": self.stats_seq,
            "preemptions": s.get("preempted", 0),
            "decode_horizon": self.decode_horizon,
            "draining": self.draining,
            "max_queue": sched.max_queue,
            "queued": len(sched.queue),
            "queue_depth_by_priority": sched.queue_depth_by_priority(),
            "active_slots": len(sched.active_indices()),
            "prefilling_slots": len(sched.prefilling_indices()),
            "prefill_calls": self.programs.prefill_calls,
            # committed prefix keys for the router's fleet directory
            "prefix_keys": (cache_prefix_keys(sched.cache)
                            if sched.cache is not None else []),
            **derived_pool_metrics(
                tier=self.host_tier,
                pool=sched.pool, cached_pages=sched.cache_pages_held(),
                n_slots=self.n_slots, decode_steps=self.decode_steps,
                decode_tokens=self.decode_tokens,
                host_dispatches=self.host_dispatches,
                horizon_ksum=self.horizon_ksum,
                admitted=s.get("admitted", 0),
                prefix_hits=s.get("prefix_hits", 0), lat=self._lat,
                bytes_per_page=kv_page_bytes(self.config,
                                             page_size=self.page_size,
                                             kv_dtype=self.kv_dtype),
                pool_dtype=self.kv_dtype),
            **spec_metrics(self.spec, decode_steps=self.decode_steps,
                           decode_tokens=self.decode_tokens,
                           drafter=self.drafter),
            **adapter_metrics(
                self.adapter_pool,
                publishes=self.programs.adapter_publish_count),
        }

    def kv_report(self) -> dict:
        """The byte table for this engine's pool."""
        return build_kv_report(
            self.programs, page_size=self.page_size,
            pool=self.scheduler.pool,
            cached_pages=self.scheduler.cache_pages_held(),
            n_slots=self.n_slots, max_pages=self.max_pages,
            pool_bytes=self.kv_cache_bytes(), tier=self.host_tier,
            decode_horizon=self.decode_horizon)

    def weight_report(self) -> dict:
        """The byte table for this engine's weights."""
        return build_weight_report(self.programs)

    def adapter_report(self) -> dict:
        """The byte table for this engine's adapter pool (empty without
        one)."""
        return build_adapter_report(self.programs)

    def weight_bytes(self) -> int:
        """Resident param bytes (int8 payload and scales under
        weight_dtype='int8')."""
        return params_nbytes(self.programs._stored_layout)
