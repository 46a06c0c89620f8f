"""Live engine-generation swaps: grow or shrink a serving engine's
``n_slots`` / page-pool capacity without dropping in-flight requests.

Counterpart of ``distributed_training_guide_tpu/serve/elastic.py``. The
decode step is shaped ``[n_slots]`` and the pools are allocated once, so
a resize is a COORDINATED MASS PREEMPTION:

1. **Drain admissions** on the old generation (new submits refuse, 503).
2. **Export every in-flight sequence.** Resident decodes release their
   slots without freeing pages and their committed k/v is gathered to
   pinned host memory (``transport.gather_payload``, int8 scale rows
   included); mid-prefill slots are preempted and the queue is drained
   in order with its submit times and request ids.
3. **Seat on the new generation.** A moved payload is scattered bitwise
   into the new pool and the sequence is adopted mid-stream (its next
   decode consumes its newest token at the same absolute position).
   Anything that cannot seat (no free slot after a shrink, pool
   pressure, a dropped payload ``DTG_FAULT_SWAP_DROP_SEQ``, another pool
   geometry) requeues with its generated suffix and replays bitwise. A
   request whose worst case no longer fits the new generation at all
   finishes at once with ``finish_reason="shrink_evicted"`` and the
   strict prefix of its tokens.
4. **Request ids survive** (``ensure_ids_above``), so every caller-held
   handle, the fleet router's ledger included, stays valid.

Both generations run the SAME ``ModelPrograms`` (one params layout),
which is what makes the replayed and seated continuations token-identical
under greedy decoding. A swap that changes ``n_slots`` changes the decode
products' M, so on the card the seated logits may differ in their last
bits from the old generation's (a GEMM's reduction order may follow M).

``Router.swap_replica`` / ``add_replica`` / ``remove_replica``
(``serve/router.py``) are the fleet-level form.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from ..utils import faults
from .disagg import DisaggEngine
from .engine import ServeEngine
from .kv_pages import pages_for_tokens
from .scheduler import RequestResult, Scheduler
from .transport import payload_nbytes


@dataclasses.dataclass
class _Exported:
    """One in-flight sequence leaving the old generation: the request,
    its generation state, and (when the k/v payload moved) the gathered
    pool bytes for the live pages."""
    request: object
    generated: list
    cache_len: int
    submitted_at: float
    admitted_at: float
    first_token_at: float
    payload: Optional[dict] = None     # None -> requeue-and-replay


def _payload_compatible(old, new) -> bool:
    """Whether the gathered-bytes seat path is usable between the two
    generations: identical pool geometry per page (page_size, storage
    dtype)."""
    return (old.page_size == new.page_size
            and old.kv_dtype == new.kv_dtype)


def _export_residents(sched: Scheduler, pages: dict, programs, *,
                      with_payload: bool,
                      start_index: int, stats: dict) -> list[_Exported]:
    """Release every ACTIVE (decoding) slot oldest-first, gathering its
    live pages' payload unless the sequence is mid-replay (its cache is
    only partially rebuilt — queue-shaped state already) or the
    swap-drop fault hits. All page references are freed here: ownership
    of the k/v moves as host bytes or not at all."""
    out = []
    order = sorted(sched.active_indices(), key=lambda i: sched.slots[i].seq)
    for slot_idx in order:
        slot = sched.slots[slot_idx]
        replaying = slot.replaying
        slot_pages = list(slot.pages)
        slot, submitted_at = sched.release_slot(slot_idx)
        payload = None
        if with_payload and not replaying and slot.generated:
            # only the pages the cache actually lives in: speculative
            # lookahead growth may have granted pages past cache_len that
            # hold nothing but dead k/v — dropped, not moved
            live = slot_pages[:pages_for_tokens(slot.cache_len,
                                                sched.pool.page_size)]
            if faults.swap_fault(start_index + len(out)):
                stats["payload_dropped"] += 1
            else:
                payload = programs.gather_pages(pages, live)
                stats["pages_moved"] += len(live)
                stats["bytes_moved"] += payload_nbytes(payload)
        sched.pool.free(slot_pages)
        out.append(_Exported(
            request=slot.request, generated=list(slot.generated),
            cache_len=slot.cache_len, submitted_at=submitted_at,
            admitted_at=slot.admitted_at,
            first_token_at=slot.first_token_at, payload=payload))
    return out


def _preempt_prefilling(sched: Scheduler) -> int:
    """Preempt mid-prefill slots into the queue head (youngest first, so
    the oldest ends nearest the head — admission order is preserved)."""
    idxs = sorted(sched.prefilling_indices(),
                  key=lambda i: sched.slots[i].seq, reverse=True)
    for i in idxs:
        sched.preempt(i)
    return len(idxs)


def _drain_cache(sched: Scheduler) -> int:
    """Evict every prefix-cache reference: the old generation's pages die
    with it, and holding them would break its end-state pool audit
    (free == capacity once everything in flight has left)."""
    n = 0
    while sched.cache is not None and sched.cache.evict_one():
        n += 1
    return n


def _shrink_evicted(exp: _Exported, now: float) -> RequestResult:
    """The structured give-up for a request the NEW generation could
    never run to completion: the tokens produced so far are a strict
    prefix of the uninterrupted stream (bitwise replay guarantees
    truncation, never divergence), and the finish_reason tells the
    client this was a capacity decision, not an answer."""
    return RequestResult(
        request_id=exp.request.request_id,
        prompt_ids=list(exp.request.prompt_ids),
        generated_ids=list(exp.generated),
        finish_reason="shrink_evicted",
        submitted_at=exp.submitted_at,
        admitted_at=exp.admitted_at or now,
        finished_at=now, first_token_at=exp.first_token_at)


def _fits_generation(request, *, max_model_len: int, page_size: int,
                     pool_capacities: list[int]) -> bool:
    """The new generation's submit-time worst-case validation, applied to
    carried-over sequences (requeue skips submit on purpose — the
    original submit validated against the OLD generation)."""
    total = len(request.prompt_ids) + request.max_new_tokens
    if total > max_model_len:
        return False
    need = pages_for_tokens(total, page_size)
    return all(need <= cap for cap in pool_capacities)


def _seat_one(sched: Scheduler, pages: dict, programs, exp: _Exported,
              stats: dict) -> bool:
    """Try the payload seat: free slot + pages in the target pool +
    inside the per-slot table width. True when seated mid-stream."""
    if exp.payload is None or not exp.generated:
        return False
    page = sched.pool.page_size
    need = pages_for_tokens(exp.cache_len, page)
    if exp.cache_len > sched.max_pages * page:
        return False
    if None not in sched.slots:
        return False
    got = sched.pool.alloc(need)
    if got is None:
        return False
    programs.scatter_pages(pages, got, exp.payload)
    idx = sched.adopt(
        request=exp.request, pages=got, cache_len=exp.cache_len,
        generated=exp.generated, submitted_at=exp.submitted_at,
        admitted_at=exp.admitted_at, first_token_at=exp.first_token_at,
        resumed=False)
    if idx is None:                    # raced None-slot check (can't, but
        sched.pool.free(got)           # never corrupt on a logic slip)
        return False
    stats["seated"] += 1
    return True


def _requeue(sched: Scheduler, exp: _Exported, stats: dict) -> None:
    sched.requeue(exp.request, exp.generated,
                  first_token_at=exp.first_token_at,
                  submitted_at=exp.submitted_at, front=False, new_id=False)
    stats["requeued"] += 1


def new_generation(old, *, params=None, **overrides):
    """Build the next engine generation around the OLD generation's
    compiled programs (one params layout, one jit cache — the bitwise
    precondition) with its serving knobs carried over; ``overrides`` are
    the knobs being turned (``n_slots``, ``n_pages``, ``max_len``,
    ``prefill_chunk``, ``max_queue``, ...). Program-level knobs
    (``kv_dtype`` / ``attend_impl`` / ``plan`` / ``shard_kv``) are baked
    into the shared programs and cannot be overridden here — changing
    those is a new deployment, not a generation swap. ``weight_dtype``
    is baked the same way: the shared programs ARE the quantized params
    layout, so a precision change cannot ride a capacity swap. The
    adapter pool (``max_adapters`` and the device-resident stacks) also
    lives on the shared programs, so every live tenant and its refcounts
    ride the swap untouched — a resubmitted multi-LoRA request replays
    under the SAME adapter slot on the new generation.

    ``params=`` is the published-params path (post-training fleets):
    SAME-layout refreshed weights are published into the shared programs
    (``ModelPrograms.publish_params`` — validated, retrace-free), so
    callers mix a weight-publish with a capacity swap in one call
    instead of special-casing "did the layout change". The publish
    happens LAST — after override validation and after the new engine
    builds — so a rejected override or a failed construction leaves the
    old generation still serving the OLD weights (publishing first
    would hand its in-flight sequences new weights over old-policy k/v
    with no replay to fix them). The returned engine is stamped as
    requiring the replay seat: ``swap_generation`` refuses to
    payload-seat k/v computed under the pre-publish policy, even in the
    two-call form. A publish mid-swap is rejected by the swap guard (a
    changed layout fails publish validation loudly; that case IS a new
    deployment)."""
    baked = {"kv_dtype", "weight_dtype", "attend_impl", "plan", "shard_kv"}
    bad = baked & set(overrides)
    if bad:
        raise ValueError(
            f"{sorted(bad)} are baked into the shared ModelPrograms; a "
            f"generation swap can only change serving-capacity knobs "
            f"(n_slots, n_pages, max_len, prefill_chunk, max_queue, ...)")
    # pool sizes carry over only when the old engine was EXPLICITLY
    # sized below (or above) its full-residency default: a deliberately
    # small pool is a backpressure/preemption configuration the swap
    # must preserve, while a default-sized pool should re-derive for the
    # NEW slot count (carrying the old default under an n_slots grow
    # would silently under-provision the bigger batch)
    def _carry_pool(n_pages_actual: int, default: int) -> Optional[int]:
        return None if n_pages_actual == default else n_pages_actual
    if isinstance(old, DisaggEngine):
        if old.transport == "cross_host":
            default_decode = 1 + old.n_slots * old.max_pages
            default_prefill = 1 + old.n_prefill_slots * old.max_pages
            pool_kw = dict(
                n_pages=_carry_pool(old.decode_pool.n_pages,
                                    default_decode),
                n_prefill_pages=_carry_pool(old.pool.n_pages,
                                            default_prefill))
        else:
            default = 1 + (old.n_slots + old.n_prefill_slots) \
                * old.max_pages
            pool_kw = dict(n_pages=_carry_pool(old.pool.n_pages, default))
        kw = dict(n_slots=old.n_slots,
                  n_prefill_slots=old.n_prefill_slots,
                  page_size=old.page_size,
                  # max_model_len, not max_pages*page_size: the capacity
                  # is page-rounded, and rebuilding from it would inflate
                  # the request-validation bound to the next page
                  # boundary on every swap
                  max_len=old.max_model_len,
                  prefill_chunk=old.prefill_chunk,
                  prefix_cache=old.prefill.sched.cache is not None,
                  max_queue=old.prefill.sched.max_queue,
                  speculate=old.decode.drafter,
                  transport=old.transport,
                  host_tier_bytes=(old.host_tier.budget_bytes
                                   if old.host_tier is not None else None),
                  programs=old.programs, **pool_kw)
        kw.update(overrides)
        new = DisaggEngine(old.bundle, old.programs.params, **kw)
    else:
        kw = dict(n_slots=old.n_slots, page_size=old.page_size,
                  max_len=old.max_model_len,
                  n_pages=_carry_pool(old.scheduler.pool.n_pages,
                                      1 + old.n_slots * old.max_pages),
                  prefill_chunk=old.prefill_chunk,
                  prefix_cache=old.scheduler.cache is not None,
                  max_queue=old.scheduler.max_queue,
                  speculate=old.drafter,
                  host_tier_bytes=(old.host_tier.budget_bytes
                                   if old.host_tier is not None else None),
                  programs=old.programs)
        kw.update(overrides)
        new = ServeEngine(old.bundle, old.programs.params, **kw)
    if params is not None:
        # publish LAST (both engine shapes): everything that can refuse
        # already has. From here the old generation's resident k/v is
        # old-policy — the stamp makes every seat path replay instead of
        # payload-move, and the OLD engine must not step again before
        # the swap (its decodes would attend old-policy k/v with the new
        # weights and the forced replay would then preserve those
        # mixed-policy tokens verbatim): step() refuses until the swap.
        old.programs.publish_params(params)
        old.programs.drop_shared_kv()
        new._seat_requires_replay = True
        old._publish_pending_swap = True
    return new


def swap_generation(old, new, *,
                    force_replay: bool = False) \
        -> tuple[list[RequestResult], dict]:
    """Move EVERY in-flight request from ``old`` to ``new`` (the
    coordinated mass preemption — module docstring has the full
    protocol). Returns ``(shrink_evicted_results, stats)``; everything
    not in the results list continues on the new generation, token-
    identical to an uninterrupted run. The old generation is left
    drained and EMPTY: no queue, no residents, no cache references — its
    pool audits ``free == capacity``.

    ``force_replay=True`` disables the gathered-payload seat path and
    requeues every carried sequence through recompute instead. A
    generation built by ``new_generation(params=...)`` forces it
    REGARDLESS of the caller's flag (the ``_seat_requires_replay``
    stamp — the two-call form must not seat k/v computed under the
    pre-publish policy either): seated k/v was computed under the old
    policy, and attending over it with the new weights would mix
    policies mid-sequence. Replay rebuilds each sequence's cache under
    the published weights while preserving the already-emitted tokens
    verbatim (replay forces the recorded tokens; samples along the way
    are discarded)."""
    force_replay = force_replay or getattr(new, "_seat_requires_replay",
                                           False)
    if old.programs is not new.programs:
        raise ValueError(
            "generation swap requires the new engine to share the old "
            "engine's ModelPrograms (new_generation(old, ...) builds one "
            "correctly) — separate programs would break bitwise replay")
    if getattr(new, "draining", False):
        raise ValueError("the new generation is draining; swap into a "
                         "live engine")
    # the guard rejects any publish_params landing while the export/seat
    # window is open — new weights mid-swap would corrupt every replay
    with old.programs.swap_guard():
        return _swap_generation_locked(old, new, force_replay)


def _swap_generation_locked(old, new, force_replay: bool):
    t0 = time.perf_counter()
    stats = {"seated": 0, "requeued": 0, "evicted": 0, "pages_moved": 0,
             "bytes_moved": 0, "payload_dropped": 0, "cache_dropped": 0,
             "queued_moved": 0, "tier_records_carried": 0,
             "tier_records_dropped": 0}
    old.drain()
    with_payload = _payload_compatible(old, new) and not force_replay
    disagg = isinstance(old, DisaggEngine)

    # ---- export from the old generation ------------------------------------
    if disagg:
        residents = _export_residents(old.decode.sched, old.decode_pages,
                                      old.programs,
                                      with_payload=with_payload,
                                      start_index=0, stats=stats)
        # in-transit handoffs: neither scheduler owns them — requeue (the
        # same-host records still hold old-pool page refs to release; a
        # cross-host record's payload targets the old decode pool's
        # geometry, and recompute is always correct)
        for h in list(old.handoff.pending):
            old.handoff.pending.remove(h)
            if h.pages:
                old.pool.free(h.pages)
            residents.append(_Exported(
                request=h.request, generated=list(h.generated),
                cache_len=h.cache_len, submitted_at=h.submitted_at,
                admitted_at=h.admitted_at,
                first_token_at=h.first_token_at, payload=None))
        _preempt_prefilling(old.prefill.sched)
        # decode-side queue entries (fresh preemptions this iteration)
        # are older than anything queued on the prefill side — they seat
        # first in the combined order
        queued = (old.decode.sched.drain_queue()
                  + old.prefill.sched.drain_queue())
        old.prefill._pending.clear()
        old.decode._dev = None
        stats["cache_dropped"] = _drain_cache(old.prefill.sched)
    else:
        residents = _export_residents(old.scheduler, old.pages,
                                      old.programs,
                                      with_payload=with_payload,
                                      start_index=0, stats=stats)
        _preempt_prefilling(old.scheduler)
        queued = old.scheduler.drain_queue()
        old._pending.clear()
        old._dev = None
        stats["cache_dropped"] = _drain_cache(old.scheduler)

    # ---- seat on the new generation ----------------------------------------
    if isinstance(new, DisaggEngine):
        seat_sched, seat_pages = new.decode.sched, new.decode_pages
        queue_sched = new.prefill.sched
        capacities = [new.pool.capacity, new.decode_pool.capacity]
        now = queue_sched._clock()
        new.decode._dev = None
    else:
        seat_sched = queue_sched = new.scheduler
        seat_pages = new.pages
        capacities = [new.scheduler.pool.capacity]
        now = new.scheduler._clock()
        new._dev = None
    results = []
    max_id = -1
    for exp in residents:
        max_id = max(max_id, exp.request.request_id)
        if not _fits_generation(exp.request,
                                max_model_len=new.max_model_len,
                                page_size=new.page_size,
                                pool_capacities=capacities):
            results.append(_shrink_evicted(exp, now))
            stats["evicted"] += 1
            continue
        if not _seat_one(seat_sched, seat_pages, new.programs, exp, stats):
            _requeue(queue_sched, exp, stats)
    for entry, t in queued:
        max_id = max(max_id, entry.request.request_id)
        exp = _Exported(request=entry.request,
                        generated=list(entry.generated), cache_len=0,
                        submitted_at=t, admitted_at=0.0,
                        first_token_at=entry.first_token_at)
        if not _fits_generation(entry.request,
                                max_model_len=new.max_model_len,
                                page_size=new.page_size,
                                pool_capacities=capacities):
            results.append(_shrink_evicted(exp, now))
            stats["evicted"] += 1
            continue
        _requeue(queue_sched, exp, stats)
        stats["queued_moved"] += 1
    seat_sched.ensure_ids_above(max_id + 1)
    if queue_sched is not seat_sched:
        queue_sched.ensure_ids_above(max_id + 1)

    # ---- carry or drop the host tier explicitly ----------------------------
    # Spilled payloads are raw pool bytes: they carry to the new
    # generation exactly when a gathered payload could seat there (same
    # page geometry, unsharded, no weight publish in between — carried
    # old-policy k/v under new weights would mix policies like a seated
    # payload would). The _drain_cache spills above ride along, so a
    # compatible swap starts with its warm prefixes parked host-side.
    old_tier = getattr(old, "host_tier", None)
    new_tier = getattr(new, "host_tier", None)
    if old_tier is not None and len(old_tier):
        if new_tier is not None and with_payload:
            carried, dropped = new_tier.carry_from(old_tier)
            stats["tier_records_carried"] = carried
            stats["tier_records_dropped"] += dropped
        else:
            stats["tier_records_dropped"] += len(old_tier)
            for key in old_tier.keys():
                old_tier.drop(key)
    stats["swap_s"] = round(time.perf_counter() - t0, 4)
    return results, stats


def spawn_like(router, *, name: Optional[str] = None,
               source: Optional[str] = None,
               heartbeat_path: Optional[str] = None, **overrides):
    """Build a NEW replica cloned from a live replica's serving config —
    the scale-UP half of fleet elasticity, and the control plane's
    default spawn factory. The clone shares the source's compiled
    ``ModelPrograms`` (one params layout, one jit cache — the same
    precondition generation swaps and fence-recovery replay stand on),
    carries its serving knobs through ``new_generation``, and gets a
    fresh pool/scheduler; ``overrides`` turn individual knobs.

    Returns the Replica WITHOUT adding it to the router: the caller
    times cold-start (construction here -> ``readiness()`` true) and
    then calls ``router.add_replica`` — serve/controller.py records
    exactly that window per scale-up. ``name`` defaults to the first
    free ``rN``; ``source`` picks which live replica to clone (the
    first live one otherwise)."""
    from .router import Replica

    if source is not None:
        src = router.replicas.get(source)
        if src is None or src.state != "live":
            raise ValueError(f"source replica {source!r} is not live")
    else:
        src = next((r for r in router.replicas.values()
                    if r.state == "live"), None)
        if src is None:
            raise ValueError("no live replica to clone a spawn from")
    if name is None:
        i = 0
        while f"r{i}" in router.replicas:
            i += 1
        name = f"r{i}"
    engine = new_generation(src.engine, **overrides)
    return Replica(name, engine, heartbeat_path=heartbeat_path,
                   clock=router.clock)


def swap_engine(old, *, params=None, **overrides):
    """The one-call form: build the next generation with ``overrides``
    (``new_generation``), run the swap, and return ``(new_engine,
    shrink_evicted_results, stats)``. The old engine is left drained and
    empty; drop it (or keep it for its counters).

    ``params=`` publishes refreshed same-layout weights into the shared
    programs first (the post-training weight-publish path) and forces
    the requeue-and-replay seat for every carried sequence — their
    caches are rebuilt under the published weights while every
    already-emitted token is preserved verbatim (payload-seated k/v was
    computed under the OLD policy and must not be attended over with
    the new one)."""
    new = new_generation(old, params=params, **overrides)
    results, stats = swap_generation(old, new,
                                     force_replay=params is not None)
    close = getattr(old, "close", None)
    if close is not None:              # tear down the old handoff transport
        close()
    return new, results, stats
