"""Disaggregated serving: a prefill engine and a decode engine connected
by a KV-page handoff (DistServe, Zhong et al. arXiv:2401.09670).

Counterpart of ``distributed_training_guide_tpu/serve/disagg.py`` for one
device. The monolithic :class:`~.engine.ServeEngine` co-schedules prefill
work inside its decode iteration; here the two halves are separate
engines with their own schedulers, sharing one :class:`ModelPrograms`:

- :class:`PrefillEngine`: admission, the prefix cache, copy-on-write and
  the bucketed prefill or the chunk program. It never decodes. When a
  prompt's pages are committed it samples the first token and emits a
  :class:`Handoff`.
- :class:`PageHandoff` (``transport="same_host"``): both engines address
  ONE pool, so a handoff moves page ownership and refcounts: zero page
  copies, zero bytes. :class:`CrossHostPageHandoff`
  (``transport="cross_host"``): the engines own separate pools and the
  sequence's k/v payload moves, int8 scale rows included, through
  ``serve/transport.py``'s CRC-framed ack/commit wire (gathered to pinned
  host memory, a socketpair, scattered into freshly allocated receiver
  pages on the engine's thread). A crash or timeout mid-flight resolves
  only to "payload dropped, sender pages freed, request requeued at the
  prefill queue's head". On one card the two pools are two tensors on the
  same device and the wire is a loopback socket on one host.
- :class:`DecodeEngine`: the fixed ``[n_slots]`` batch, fed only from the
  handoff queue, running the monolith's decode step (K4 on the card),
  speculation or fused horizons. A preempted sequence routes back to the
  prefill queue (its prompt must be recomputed) and replays its generated
  tokens bitwise.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue as queue_mod
from typing import Optional

from ..models.registry import ModelBundle
from .adapters import DEFAULT_TARGETS
from .engine import (LatencyMeter, ModelPrograms, adapter_metrics,
                     advance_prefill_chunks, build_adapter_report,
                     build_kv_report, check_page_geometry,
                     collect_partial_tokens, default_prefill_buckets,
                     derived_pool_metrics, dispatch_horizon, drop_stale_kv,
                     drop_stale_pending, horizon_dev, process_horizon_block,
                     resolve_context_bounds, resolve_drafter,
                     run_bucket_prefill, run_decode_iteration, run_fork,
                     spec_metrics, validate_prefill_buckets)
from .kv_pages import (kv_page_bytes, PagePool, pages_for_tokens,
                       pool_nbytes)
from .scheduler import Admission, Request, RequestResult, Scheduler
from .spec import new_spec_counters
from .tiering import HostTier, cache_prefix_keys, restore_prefixes
from .transport import encode_frame, gather_payload, scatter_payload

TRANSPORTS = ("same_host", "cross_host")


@dataclasses.dataclass
class Handoff:
    """One sequence crossing the prefill->decode boundary: the request,
    the committed pages (ownership moves WITH the record — the prefill
    scheduler released them without freeing), and the generation state
    ([first token], or the full recorded suffix of a preempted sequence
    about to replay)."""
    request: Request
    pages: list
    cache_len: int                  # committed tokens (= len(prompt))
    generated: list
    submitted_at: float
    admitted_at: float
    first_token_at: float = 0.0
    resumed: bool = False
    # cross-host only: the received-but-not-yet-seated k/v payload (host
    # arrays, no pool pages until the decode side takes the record) and
    # the wire transfer id it arrived under
    payload: Optional[dict] = None
    xfer_id: Optional[int] = None


class PageHandoff:
    """Same-host page handoff: a queue of :class:`Handoff` records whose
    page references are IN TRANSIT — released by the prefill scheduler,
    not yet adopted by the decode scheduler, still holding their pool
    refcounts (the property tests count in-transit records as holders).

    ``stats``: ``transfers`` / ``pages_transferred`` / ``tokens_transferred``
    count the traffic; ``bytes_copied`` is the page payload MOVED, which
    same-host is identically 0 — the refcount transfer never touches page
    contents. A multi-host implementation would override ``transfer``/
    ``take`` to move ``bytes_per_sequence(config, ...)`` of k/v payload
    and re-allocate at the receiver; the engines are written against this
    interface only.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.pending: list[Handoff] = []
        self.stats = {"transfers": 0, "delivered": 0, "pages_transferred": 0,
                      "tokens_transferred": 0, "bytes_copied": 0,
                      "dropped": 0, "requeued": 0}

    def transfer(self, handoff: Handoff) -> bool:
        """Accept a sequence from the prefill side. Same-host: ownership
        of the (already-held) page references moves to the pending queue
        — no copy, no refcount churn, no device work; delivery cannot
        fail (returns True — the cross-host implementation returns False
        when its wire protocol resolves to the drop outcome, and the
        prefill engine requeues)."""
        self.pending.append(handoff)
        self.stats["transfers"] += 1
        self.stats["delivered"] += 1
        self.stats["pages_transferred"] += len(handoff.pages)
        self.stats["tokens_transferred"] += handoff.cache_len
        return True

    def take(self) -> Optional[Handoff]:
        """Next sequence for the decode side, priority order (FIFO within
        a class — mirrors admission)."""
        if not self.pending:
            return None
        best = max(range(len(self.pending)),
                   key=lambda i: (self.pending[i].request.priority, -i))
        return self.pending.pop(best)

    def close(self) -> None:
        """Same-host: nothing to tear down (interface symmetry with the
        cross-host transport's sockets + receiver thread)."""

    def __len__(self) -> int:
        return len(self.pending)


class CrossHostPageHandoff:
    """The documented cross-host branch of :class:`PageHandoff`: the two
    engines own SEPARATE pools (on a real deployment, separate hosts'
    HBM), so transferring a sequence moves its actual k/v payload —
    device-to-host gather out of the sender pool, the
    ``serve/transport.py`` wire (frame + CRC + ack/commit protocol), and
    a host-to-device scatter into freshly-allocated receiver pages. The
    int8 pool's scale rows ride the same frame, so the payload a
    quantized engine ships is ~the int8 byte ratio of fp32's — the
    quantization lever halves the wire for free (priced by preflight's
    ``handoff_wire_bytes_by_kv_dtype``).

    Crash safety is the transport's delivery protocol: every transfer
    resolves to exactly one of

    - **delivered once** — the record (request + generation state +
      payload) is in the receiver inbox before ``transfer`` returns, and
      the sender's pages are freed (ownership moved as bytes);
    - **dropped** — torn frame / ack timeout / NAK: the receiver
      committed nothing, the sender's pages are freed, and ``transfer``
      returns False so the prefill engine requeues the request at its
      queue's head (recompute + bitwise replay).

    Never a torn page, never a leaked one: sender pages are freed in
    BOTH outcomes (the in-transit holder is host/wire bytes, not pool
    refcounts — each pool's ``free + held + cached == capacity`` audit
    holds independently throughout, chaos-pinned). A ``xfer_id`` dedup
    at the inbox discards the two-generals residue (a frame committed by
    the receiver after the sender already gave up and requeued).
    """

    def __init__(self, send_pool: PagePool, recv_pool: PagePool,
                 send_pages: dict, recv_pages: dict, *,
                 kv_dtype: str, ack_timeout_s: float = 2.0, scatter=None):
        from .transport import loopback_channel

        self.send_pool, self.recv_pool = send_pool, recv_pool
        self.send_pages, self.recv_pages = send_pages, recv_pages
        # seats a received payload (the engine's programs: every rank's
        # pool under a plan)
        self.scatter = scatter or (lambda ids, payload: scatter_payload(
            self.recv_pages, ids, payload))
        self.kv_dtype = kv_dtype
        # a card's receiver lands each leaf in pinned host memory, so the
        # scatter into the decode pool is a fast host-to-device copy
        first = recv_pages["k"]
        first = getattr(first, "q", first)
        self._sender, self._receiver = loopback_channel(
            ack_timeout_s=ack_timeout_s, pin=first.is_cuda)
        self._xfer = itertools.count()
        self._delivered_ids: set[int] = set()
        self._received: list[Handoff] = []
        self.stats = {"transfers": 0, "delivered": 0, "pages_transferred": 0,
                      "tokens_transferred": 0, "bytes_copied": 0,
                      "dropped": 0, "dropped_nak": 0, "dropped_timeout": 0,
                      "dropped_link": 0, "requeued": 0}

    def transfer(self, handoff: Handoff) -> bool:
        """Serialize + ship one sequence; free the sender's pages in
        every outcome; True iff delivered (False -> caller requeues)."""
        xfer_id = next(self._xfer)
        payload = gather_payload(self.send_pages, handoff.pages)
        req = handoff.request
        frame = encode_frame(xfer_id, {
            "request": dataclasses.asdict(req),
            "cache_len": handoff.cache_len,
            "generated": list(handoff.generated),
            "submitted_at": handoff.submitted_at,
            "admitted_at": handoff.admitted_at,
            "first_token_at": handoff.first_token_at,
            "resumed": handoff.resumed,
            "kv_dtype": self.kv_dtype,
            "n_pages": len(handoff.pages),
        }, payload)
        self.stats["transfers"] += 1
        # mark BEFORE the send: by the time FIN lands the receiver thread
        # has already inboxed the record under this id
        self._delivered_ids.add(xfer_id)
        outcome = self._sender.send(frame, xfer_id)
        # both outcomes free the sender-side pages: on delivery the
        # ownership moved as bytes, on a drop the sequence will be
        # recomputed from its prompt — holding dead pages would leak
        self.send_pool.free(handoff.pages)
        if outcome == "delivered":
            self.stats["delivered"] += 1
            self.stats["pages_transferred"] += len(handoff.pages)
            self.stats["tokens_transferred"] += handoff.cache_len
            self.stats["bytes_copied"] += len(frame)
            return True
        self._delivered_ids.discard(xfer_id)
        self.stats["dropped"] += 1
        self.stats[outcome] += 1
        return False

    def _drain_inbox(self) -> None:
        while True:
            try:
                xfer_id, header, payload = self._receiver.inbox.get_nowait()
            except queue_mod.Empty:
                return
            if xfer_id not in self._delivered_ids:
                continue        # sender already resolved this id to a drop
            self._delivered_ids.discard(xfer_id)
            self._received.append(Handoff(
                request=Request(**header["request"]), pages=[],
                cache_len=int(header["cache_len"]),
                generated=list(header["generated"]),
                submitted_at=header["submitted_at"],
                admitted_at=header["admitted_at"],
                first_token_at=header["first_token_at"],
                resumed=bool(header["resumed"]), payload=payload,
                xfer_id=xfer_id))

    @property
    def pending(self) -> list[Handoff]:
        """Received-but-not-seated records (payload held as host bytes,
        NO pool pages yet) — the facade's in-transit view for deadline
        expiry, streaming taps, and has_work."""
        self._drain_inbox()
        return self._received

    def take(self) -> Optional[Handoff]:
        """Seat the highest-priority received record: allocate its pages
        from the RECEIVER pool and scatter the payload in. Returns None
        when nothing is pending or the head record's pages don't fit yet
        (strict priority — it retries next iteration; decode-side
        eviction/preemption frees the pool it is waiting on)."""
        self._drain_inbox()
        if not self._received:
            return None
        best = max(range(len(self._received)),
                   key=lambda i: (self._received[i].request.priority, -i))
        h = self._received[best]
        pages = self.recv_pool.alloc(
            pages_for_tokens(h.cache_len, self.recv_pool.page_size))
        if pages is None:
            return None
        self._received.pop(best)
        self.scatter(pages, h.payload)
        h.pages, h.payload = pages, None
        return h

    def close(self) -> None:
        for sock in (self._sender.sock, self._receiver.sock):
            try:
                sock.close()
            except OSError:
                pass

    def __len__(self) -> int:
        return len(self.pending)


class PrefillEngine:
    """The prefill half: admission + prefix sharing + (bucketed |
    chunked) prompt computation, emitting Handoffs. Owns its scheduler;
    shares the ModelPrograms jit cache and the device page pool with the
    decode half."""

    def __init__(self, programs: ModelPrograms, pages: dict,
                 sched: Scheduler, handoff: PageHandoff, *,
                 prefill_chunk: Optional[int], prefill_buckets: tuple):
        self.programs = programs
        self.pages = pages              # SHARED dict (key assignment only)
        self.sched = sched
        self.handoff = handoff
        self.prefill_chunk = prefill_chunk
        self.prefill_buckets = prefill_buckets
        self._pending: dict[int, Admission] = {}

    def _finish_prefill(self, adm: Admission, logit) \
            -> Optional[RequestResult]:
        """The slot's pages are fully committed: sample the first token
        (unless this is a preempted sequence replaying — its tokens
        already exist), then either finish outright (eos / max_new==1) or
        release the slot into a Handoff. Page references move with the
        handoff — the scheduler's release_slot explicitly does NOT free
        them."""
        sched = self.sched
        if not adm.resumed:
            t0 = self.programs.sample_one(logit, adm.request,
                                          len(adm.tokens))
            res = sched.record_token(adm.slot_idx, int(t0),
                                     from_decode=False)
            if res is not None:            # finished on the first token
                return res
        slot, submitted_at = sched.release_slot(adm.slot_idx)
        delivered = self.handoff.transfer(Handoff(
            request=slot.request, pages=list(slot.pages),
            cache_len=slot.cache_len, generated=list(slot.generated),
            submitted_at=submitted_at, admitted_at=slot.admitted_at,
            first_token_at=slot.first_token_at, resumed=adm.resumed))
        if not delivered:
            # the crash/timeout protocol's only failure outcome: payload
            # dropped, sender pages freed (the transport did both) — the
            # request re-enters THIS queue's head under its own id,
            # re-prefills, and replays its generated tokens bitwise
            self.handoff.stats["requeued"] += 1
            sched.requeue(slot.request, slot.generated,
                          first_token_at=slot.first_token_at,
                          submitted_at=submitted_at, new_id=False)
        return None

    def step(self) -> list[RequestResult]:
        finished = []
        expired = self.sched.expire_deadlines()
        if expired:
            drop_stale_pending(self.sched, self._pending)
            finished.extend(expired)
        for adm in self.sched.try_admit():
            if adm.fork is not None:
                run_fork(self.programs, self.pages, adm)
            if self.prefill_chunk is None:
                logit = run_bucket_prefill(self.programs, self.pages,
                                           self.sched, adm,
                                           self.prefill_buckets)
                res = self._finish_prefill(adm, logit)
                if res is not None:
                    finished.append(res)
            else:
                self._pending[adm.slot_idx] = adm
        if self._pending:
            # the shared chunk-budget loop (engine.py): here the only
            # thing one chunk can delay is OTHER PREFILLS — resident
            # decodes live in the other engine's scheduler
            finished.extend(advance_prefill_chunks(
                self.programs, self.pages, self.sched, self._pending,
                self.prefill_chunk, self._finish_prefill))
        return finished


class DecodeEngine:
    """The decode half: a fixed ``[n_slots]`` batch fed exclusively from
    the handoff queue, running the ONE compiled decode program. Keeps the
    monolith's device-resident steady state (tokens/lengths live on
    device between scheduler events). Preempted sequences are returned to
    the caller for re-prefill — this engine cannot recompute a prompt."""

    def __init__(self, programs: ModelPrograms, pages: dict,
                 sched: Scheduler, handoff: PageHandoff, drafter=None,
                 decode_horizon: int = 1):
        self.programs = programs
        self.pages = pages
        self.sched = sched
        self.handoff = handoff
        # decode-side speculation (the disaggregation makes this natural:
        # the drafter and verify program live entirely on the
        # bandwidth-bound half; prefill never sees a draft)
        self.drafter = drafter
        self.spec = new_spec_counters()
        self._dev: Optional[dict] = None
        # fused-horizon state: the knob and the dispatched-but-unbooked
        # block (the double buffer — see ServeEngine.step)
        self.decode_horizon = decode_horizon
        self._inflight: Optional[dict] = None
        self.decode_steps = 0
        self.decode_tokens = 0
        self.host_dispatches = 0
        self.horizon_ksum = 0

    def _seat_handoffs(self) -> None:
        while self.handoff.pending and None in self.sched.slots:
            h = self.handoff.take()
            if h is None:
                # cross-host: the head record's receiver-side pages don't
                # fit yet — it stays in transit and retries next iteration
                break
            self.sched.adopt(
                request=h.request, pages=h.pages, cache_len=h.cache_len,
                generated=h.generated, submitted_at=h.submitted_at,
                admitted_at=h.admitted_at, first_token_at=h.first_token_at,
                resumed=h.resumed)
            self._dev = None

    def _horizon_ready(self) -> bool:
        """Mirror of ``ServeEngine._horizon_ready`` for the decode half:
        horizon up, no drafter, nothing mid-replay."""
        return (self.decode_horizon > 1 and self.drafter is None
                and not any(self.sched.slots[i].replaying
                            for i in self.sched.active_indices()))

    def _note_dispatch(self, k: int) -> None:
        self.host_dispatches += 1
        self.horizon_ksum += k
        self.decode_steps += k

    def step(self) -> tuple[list[RequestResult], list]:
        """One decode iteration — a fused, double-buffered K-step horizon
        when ``decode_horizon > 1`` (the ServeEngine.step discipline:
        steady state dispatches h before booking h−1; any boundary event
        — a pending handoff to seat, a preemption requeue, a deadline
        due — drains the pipeline first). Returns (finished,
        preempted_entries) — preempted entries (request + generated
        suffix) must be requeued on the prefill side by the caller."""
        finished = []
        sched = self.sched
        if self._inflight is not None:
            if (self._horizon_ready() and self._dev is not None
                    and not self.handoff.pending and not sched.queue
                    and not sched.deadline_due()
                    and sched.active_indices()):
                pending_k = self._inflight["k"]
                cov = sched.reserve_horizon(
                    pending_k + self.decode_horizon)
                # budget clamp (see ServeEngine.step): a pending block
                # that provably finishes every slot drains instead of
                # burning an all-dead trailing horizon
                k_new = min(cov - pending_k, self.decode_horizon,
                            sched.max_remaining_budget() - pending_k)
                if k_new >= 1:
                    nxt = dispatch_horizon(self.programs, self.pages,
                                           sched, self._dev, k_new)
                    self._note_dispatch(k_new)
                    fin, emitted = process_horizon_block(sched,
                                                         self._inflight)
                    self._inflight = nxt
                    self.decode_tokens += emitted
                    return fin, []
            fin, emitted = process_horizon_block(sched, self._inflight)
            self._inflight = None
            self._dev = None
            self.decode_tokens += emitted
            finished.extend(fin)
        expired = sched.expire_deadlines()
        if expired:
            self._dev = None
            finished.extend(expired)
        self._seat_handoffs()
        grown, preempted = sched.grow_for_decode()
        if grown or preempted:
            self._dev = None
        # a preempted sequence lands in THIS scheduler's queue, but only
        # the prefill engine can recompute its prompt — hand the entries
        # back for requeue-at-head over there (with their submit times)
        entries = sched.drain_queue()

        if sched.active_indices():
            if self._horizon_ready():
                k0 = max(1, min(sched.reserve_horizon(self.decode_horizon),
                                self.decode_horizon,
                                sched.max_remaining_budget()))
                if self._dev is None or self._dev.get("kind") != "horizon":
                    self._dev = horizon_dev(self.programs, sched)
                self._inflight = dispatch_horizon(
                    self.programs, self.pages, sched, self._dev, k0)
                self._note_dispatch(k0)
            else:
                # the spec/plain dispatch is the monolith's, verbatim
                # (engine.run_decode_iteration — replay pauses
                # speculation, empty-draft iterations fall back to the
                # plain program)
                fin, emitted, self._dev = run_decode_iteration(
                    self.programs, self.pages, sched, self.drafter,
                    self.spec, self._dev)
                self._note_dispatch(1)
                self.decode_tokens += emitted
                finished.extend(fin)
                if fin:
                    self._dev = None       # a slot left the batch
        return finished, entries


class DisaggEngine:
    """The disaggregated pair behind the monolith's driving surface
    (``submit`` / ``step`` / ``has_work`` / ``stats`` /
    ``partial_tokens``), so ``serve/api.py`` — offline batch, HTTP,
    streaming — runs over it unchanged.

    ``n_slots`` is the DECODE batch (the latency-critical side);
    ``n_prefill_slots`` bounds concurrently-prefilling prompts. The
    default pool holds full residency for decode slots plus prefill
    slots; size ``n_pages`` below that to engage backpressure/preemption
    exactly as in the monolith.

    ``transport="cross_host"`` runs the documented multi-host branch:
    the two engines own SEPARATE pools (``n_pages`` sizes the decode
    side, ``n_prefill_pages`` the prefill side) and every handoff moves
    the sequence's real serialized k/v payload through
    ``serve/transport.py`` (device-to-host -> socket -> host-to-device)
    with the crash-safe delivery protocol — ``handoff_ack_timeout_s``
    bounds how long a transfer waits before resolving to the
    drop-and-requeue outcome. ``device`` defaults to ``cuda``; ``plan=``
    / ``shard_kv=`` serve under a plan as the monolith does (rank 0 builds
    the pair, the other ranks follow its programs; same-host only with
    ``shard_kv``: the handoff moves page ids, whatever heads a rank
    holds).
    """

    def __init__(self, bundle: ModelBundle, params, *, n_slots: int = 8,
                 n_prefill_slots: int = 1, page_size: int = 16,
                 n_pages: Optional[int] = None,
                 max_len: Optional[int] = None,
                 prefill_buckets: Optional[tuple] = None, plan=None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True, attend_impl: str = "auto",
                 shard_kv: bool = False, max_queue: Optional[int] = None,
                 speculate=None, spec_k: int = 4, kv_dtype=None,
                 weight_dtype=None, transport: str = "same_host",
                 n_prefill_pages: Optional[int] = None,
                 handoff_ack_timeout_s: float = 2.0,
                 programs: Optional[ModelPrograms] = None,
                 max_adapters: Optional[int] = None, adapter_rank: int = 8,
                 adapter_alpha: float = 16.0,
                 adapter_targets=DEFAULT_TARGETS,
                 host_tier_bytes: Optional[int] = None,
                 decode_horizon: int = 1, device=None):
        if decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, got "
                             f"{decode_horizon}")
        if decode_horizon > 1 and speculate is not None:
            raise ValueError(
                "speculative decoding requires decode_horizon=1: the "
                "verify forward is already multi-token — pick one of "
                "speculate= or decode_horizon>1")
        if n_prefill_slots < 1:
            raise ValueError(f"n_prefill_slots must be >= 1, got "
                             f"{n_prefill_slots}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                             f"{transport!r}")
        if transport == "cross_host" and shard_kv:
            raise ValueError(
                "transport='cross_host' does not compose with shard_kv "
                "yet: the wire gathers/scatters whole pool leaves, not "
                "per-chip slices (the ICI/DCN path is the TPU rung of "
                "this seam)")
        # a pre-built programs= shares one params layout (the monolith's
        # contract: engine-generation swaps run the old generation's own
        # programs, so replayed tokens are bitwise)
        self.programs = programs if programs is not None else ModelPrograms(
            bundle, params, device=device, plan=plan, shard_kv=shard_kv,
            attend_impl=attend_impl, kv_dtype=kv_dtype,
            weight_dtype=weight_dtype, max_adapters=max_adapters,
            adapter_rank=adapter_rank, adapter_alpha=adapter_alpha,
            adapter_targets=adapter_targets)
        self.device = self.programs.device
        drafter = resolve_drafter(speculate, spec_k=spec_k,
                                  n_slots=n_slots, device=self.device)
        # ONE adapter pool for both halves (shared programs): the handoff
        # releases the prefill side's reference and the decode adopt
        # retains — net-neutral on the shared pool, so a tenant's
        # refcount tracks its true in-flight total across the pair
        self.adapter_pool = self.programs.adapter_pool
        self.bundle, self.config = bundle, bundle.config
        # both halves write/read ONE pool at one storage dtype; the
        # handoff moves page ids, so a quantized page's payload AND its
        # scale rows transfer by refcount exactly like float pages
        self.kv_dtype = self.programs.kv_dtype
        # both halves likewise run ONE params layout (shared programs) —
        # a quantized base serves prefill and decode from the same bytes
        self.weight_dtype = self.programs.weight_dtype
        max_len, self.max_model_len, self.max_pages = \
            resolve_context_bounds(self.config, max_len, page_size)
        check_page_geometry(self.programs, page_size)
        self.page_size = page_size
        self.n_slots = n_slots
        self.n_prefill_slots = n_prefill_slots
        self.transport = transport
        self.draining = False
        self.prefill_chunk = prefill_chunk
        if prefill_buckets is None:
            prefill_buckets = default_prefill_buckets(self.max_pages,
                                                      page_size)
        prefill_buckets = validate_prefill_buckets(
            prefill_buckets, max_pages=self.max_pages, page_size=page_size,
            max_model_len=self.max_model_len)

        if transport == "cross_host":
            # two pools, one per "host": the prefill pool holds prompts
            # mid-computation plus the prefix cache, the decode pool the
            # resident generation state — each audits independently
            if n_pages is None:
                n_pages = 1 + n_slots * self.max_pages
            if n_prefill_pages is None:
                n_prefill_pages = 1 + n_prefill_slots * self.max_pages
            self.pool = PagePool(n_prefill_pages, page_size)
            self.decode_pool = PagePool(n_pages, page_size)
            self.pages = self.programs.init_device_pages(n_prefill_pages,
                                                         page_size)
            self.decode_pages = self.programs.init_device_pages(n_pages,
                                                                page_size)
            self.handoff = CrossHostPageHandoff(
                self.pool, self.decode_pool, self.pages, self.decode_pages,
                kv_dtype=self.kv_dtype,
                ack_timeout_s=handoff_ack_timeout_s,
                scatter=lambda ids, payload: self.programs.scatter_pages(
                    self.decode_pages, ids, payload))
        else:
            if n_pages is None:
                n_pages = 1 + (n_slots + n_prefill_slots) * self.max_pages
            self.pool = PagePool(n_pages, page_size)
            self.decode_pool = self.pool
            self.pages = self.programs.init_device_pages(n_pages, page_size)
            self.decode_pages = self.pages
            self.handoff = PageHandoff(self.pool)

        prefill_sched = Scheduler(
            n_slots=n_prefill_slots, pool=self.pool,
            max_len=self.max_model_len, max_pages_per_slot=self.max_pages,
            prefix_cache=prefix_cache, max_queue=max_queue,
            allow_partial_share=prefill_chunk is not None,
            # admission headroom must count the DECODE side's running
            # slots (this scheduler never decodes): without it, admission
            # would eat the last free pages out from under growing
            # decodes and trade every admission for preemption churn
            # (late-bound closure — decode_sched is created just below).
            # Under decode-side speculation the margin widens to the k
            # in-flight speculated tokens each decode can scatter.
            # Cross-host the pools are SEPARATE: prefill admission cannot
            # starve decode growth, so no cross-engine headroom applies.
            admission_headroom=(
                None if transport == "cross_host"
                else lambda: len(decode_sched.active_indices())),
            spec_lookahead=drafter.k if drafter else 0,
            decode_horizon=decode_horizon,
            adapter_pool=self.adapter_pool)
        # the decode scheduler shares the prefill side's PrefixCache
        # object (or runs cache-less): growth under pressure must be able
        # to evict idle cached pages before preempting a live sequence.
        # Cross-host the cache's pages live in the OTHER pool — evicting
        # them frees nothing decode growth can use, so no cache is shared.
        decode_sched = Scheduler(
            n_slots=n_slots, pool=self.decode_pool,
            max_len=self.max_model_len,
            max_pages_per_slot=self.max_pages,
            prefix_cache=(prefill_sched.cache
                          if transport == "same_host"
                          and prefill_sched.cache is not None else False),
            spec_lookahead=drafter.k if drafter else 0,
            decode_horizon=decode_horizon,
            adapter_pool=self.adapter_pool)
        # ONE host tier serves both halves (it is host RAM — there is no
        # per-pool ownership to respect, only per-pool GATHER sources):
        # a decode-side preemption spills from the decode pool, a prefix
        # eviction spills from whichever pool backs the cache, and the
        # facade's restore seats a preempted sequence back into the
        # DECODE pool without a re-prefill. Cross-host the two gathers
        # read different page dicts; same-host they are the same one.
        self.host_tier: Optional[HostTier] = None
        if host_tier_bytes is not None:
            self.host_tier = HostTier(host_tier_bytes)
            gather_prefill = (
                lambda ids: self.programs.gather_pages(self.pages, ids))
            gather_decode = (
                lambda ids: self.programs.gather_pages(self.decode_pages,
                                                       ids))
            prefill_sched.attach_tier(self.host_tier, gather_prefill)
            decode_sched.attach_tier(self.host_tier, gather_decode)
            if prefill_sched.cache is not None:
                # same-host the decode scheduler shares this cache object
                prefill_sched.cache.attach_tier(self.host_tier,
                                                gather_prefill)
            self.programs.attach_host_tier(self.host_tier)

        self.prefill = PrefillEngine(
            self.programs, self.pages, prefill_sched, self.handoff,
            prefill_chunk=prefill_chunk, prefill_buckets=prefill_buckets)
        self.decode = DecodeEngine(self.programs, self.decode_pages,
                                   decode_sched, self.handoff,
                                   drafter=drafter,
                                   decode_horizon=decode_horizon)
        self._lat = LatencyMeter()
        # see ServeEngine: per-iteration staleness sequence + the parked
        # drafter for the controller's spec on/off toggle
        self.stats_seq = 0
        self._parked_drafter = None
        self.programs.kv_holders.add(self)

    # ---- the ServeEngine driving surface -----------------------------------
    def submit(self, request: Request) -> int:
        sched = self.prefill.sched
        if self.draining:
            sched.refuse("draining",
                         "engine is draining: finishing in-flight work, "
                         "not accepting new requests", http_status=503,
                         retry_after_s=sched.retry_after_hint())
        try:
            self.programs.check_prompt(request)
        except ValueError as exc:
            sched.refuse("bad_prompt", str(exc))
        if self.transport == "cross_host":
            # submit() validates worst-case pages against the PREFILL
            # pool; the decode pool must also fit one worst-case request
            # or the grow/preempt/requeue loop could never terminate
            need = pages_for_tokens(
                len(request.prompt_ids) + request.max_new_tokens,
                self.page_size)
            if need > self.decode_pool.capacity:
                sched.refuse(
                    "exceeds_pool",
                    f"request needs {need} pages, more than the decode "
                    f"pool ({self.decode_pool.capacity}) — it could never "
                    f"run to completion even alone")
        return sched.submit(request)

    def resubmit(self, request: Request, generated=(), *,
                 first_token_at: float = 0.0,
                 submitted_at: Optional[float] = None) -> int:
        """Router fence recovery: re-admit a request that already ran on
        a dead/wedged replica, with its recorded tokens replaying through
        the decode program (see Scheduler.requeue). ``submitted_at`` is
        the FIRST client submit time — deadline/TTFT accounting must not
        restart at each hop (see ServeEngine.resubmit)."""
        if self.draining:
            self.prefill.sched.refuse(
                "draining", "engine is draining: not accepting resubmits",
                http_status=503)
        return self.prefill.sched.requeue(request, generated,
                                          first_token_at=first_token_at,
                                          submitted_at=submitted_at)

    def drain(self) -> None:
        """Stop admitting; in-flight work (queued, prefilling, in
        transit, decoding) runs to completion through step() as usual —
        the graceful half of shutdown. The router reads ``draining``
        from stats() and stops routing here."""
        self.draining = True

    def set_speculation(self, on: bool) -> bool:
        """Toggle the DECODE side's drafter at an iteration boundary —
        identical contract to ``ServeEngine.set_speculation`` (spec-on ==
        spec-off identity makes the mid-stream toggle legal; no-op when
        built without ``speculate``). Returns whether spec is on."""
        dec = self.decode
        if on and dec.decode_horizon > 1 and (
                dec.drafter is not None or self._parked_drafter is not None):
            raise ValueError(
                "set_speculation(True) with decode_horizon="
                f"{dec.decode_horizon}: speculative decoding requires "
                "K=1 — shrink the horizon first (set_decode_horizon(1))")
        if on and dec.drafter is None and self._parked_drafter is not None:
            dec.drafter = self._parked_drafter
            self._parked_drafter = None
            dec._dev = None
        elif not on and dec.drafter is not None:
            self._parked_drafter = dec.drafter
            dec.drafter = None
            dec._dev = None
        return dec.drafter is not None

    def set_decode_horizon(self, k: int) -> int:
        """Resize the decode-side fused horizon at an iteration boundary —
        identical contract to ``ServeEngine.set_decode_horizon`` (the
        horizon changes host observation granularity, never token values,
        so the mid-stream toggle is legal; the in-flight block, if any,
        books at its dispatched K). Returns the new horizon."""
        if k < 1:
            raise ValueError(f"decode_horizon must be >= 1, got {k}")
        dec = self.decode
        if k > 1 and (dec.drafter is not None
                      or self._parked_drafter is not None):
            raise ValueError(
                f"set_decode_horizon({k}) with a drafter attached "
                f"(on={dec.drafter is not None}): speculative decoding "
                f"requires K=1 — set_speculation(False) does not drop the "
                f"parked drafter, so this engine stays K=1")
        dec.decode_horizon = k
        dec.sched.decode_horizon = k
        self.prefill.sched.decode_horizon = k
        return k

    @property
    def decode_horizon(self) -> int:
        return self.decode.decode_horizon

    def publish_params(self, new_params, *, force: bool = False) -> int:
        """Publish refreshed weights into the SHARED programs (both
        engines run the same ``ModelPrograms``: one publish updates the
        prefill and decode sides at once). Same in-flight-work refusal as
        ``ServeEngine.publish_params``. Both halves' prefix caches and the
        host tier's spilled prefix records are dropped: they hold k/v of
        the old weights."""
        if not force and self.has_work:
            raise RuntimeError(
                f"publish_params with in-flight work "
                f"(prefill={self.prefill.sched.has_work}, "
                f"decode={self.decode.sched.has_work}, "
                f"in_transit={len(self.handoff.pending)}): a mid-stream "
                f"weight swap breaks bitwise replay — finish or drain "
                f"first, or pass force=True to accept that")
        count = self.programs.publish_params(new_params)
        self.programs.drop_shared_kv()
        return count

    def publish_adapter(self, adapter_params, *, name: Optional[str] = None,
                        slot: Optional[int] = None,
                        force: bool = False) -> int:
        """Insert (or republish) a LoRA adapter into the shared pool.

        Same busy refusal as ``publish_params``: an insert into a slot
        the LRU just recycled would splice a different tenant's weights
        into sequences mid-decode (including anything in the handoff
        queue). The recycled slot's prefix-cache namespace is dropped so
        a new tenant can never hit the old tenant's cached prefixes."""
        if not force and self.has_work:
            raise RuntimeError(
                f"publish_adapter with in-flight work "
                f"(prefill={self.prefill.sched.has_work}, "
                f"decode={self.decode.sched.has_work}, "
                f"in_transit={len(self.handoff.pending)}): a mid-stream "
                f"adapter insert can splice weights into live sequences — "
                f"finish or drain first, or pass force=True to accept "
                f"that")
        slot_id = self.programs.publish_adapter(adapter_params, name=name,
                                                slot=slot)
        # the cache object is shared same-host; cross-host each side has
        # its own, and only the prefill side registers prefixes
        self.programs.drop_shared_kv(slot_id)
        return slot_id

    def drop_cached_kv(self, ns: Optional[int] = None) -> int:
        """Both halves' prefix caches (one object same-host) and the host
        tier's prefix records, as ``ServeEngine.drop_cached_kv``."""
        return drop_stale_kv([self.prefill.sched, self.decode.sched],
                             self.host_tier, ns=ns)

    def evict_adapter(self, slot: int) -> None:
        """Free an idle adapter slot and drop its cached prefixes."""
        if self.adapter_pool is None:
            raise ValueError("engine has no adapter pool "
                             "(max_adapters not set)")
        self.adapter_pool.evict(slot)
        self.programs.drop_shared_kv(slot)

    def adapter_report(self) -> dict:
        return build_adapter_report(self.programs)

    def close(self) -> None:
        """Tear down the handoff transport (sockets + receiver thread
        under cross_host; a no-op same-host)."""
        self.handoff.close()

    @property
    def has_work(self) -> bool:
        return (self.prefill.sched.has_work or self.decode.sched.has_work
                or bool(self.handoff.pending))

    @property
    def decode_steps(self) -> int:
        return self.decode.decode_steps

    @property
    def decode_tokens(self) -> int:
        return self.decode.decode_tokens

    @property
    def scheduler(self):
        """The admission-side scheduler (queue depth, refusal stats) —
        what generic front-end code means by "the" scheduler."""
        return self.prefill.sched

    def _tier_alloc_prefill(self, n: int):
        """Prefill-pool allocation for a prefix restore. Same-host the
        pool is shared with decode growth, so keep one page of headroom
        per active decode slot (the monolith's restore discipline);
        cross-host the pools are separate and no headroom applies."""
        headroom = (0 if self.transport == "cross_host"
                    else len(self.decode.sched.active_indices()))
        if self.pool.n_free < n + headroom:
            return None
        return self.pool.alloc(n)

    def _expire_in_transit(self) -> list[RequestResult]:
        """Deadline expiry for sequences sitting IN the handoff queue —
        neither scheduler owns them, so the facade evicts (frees pages,
        returns partial tokens) at the same iteration boundary."""
        now = self.prefill.sched._clock()
        results = []
        for h in [h for h in self.handoff.pending
                  if h.request.deadline_s is not None
                  and now - h.submitted_at > h.request.deadline_s]:
            self.handoff.pending.remove(h)
            self.pool.free(h.pages)
            self.prefill.sched.stats["deadline_expired"] += 1
            # in-transit counts as a running eviction: the sequence had
            # already been admitted and prefilled — this is decode-rate /
            # handoff latency, not an admission bottleneck
            self.prefill.sched.stats["deadline_missed_running"] += 1
            results.append(RequestResult(
                request_id=h.request.request_id,
                prompt_ids=list(h.request.prompt_ids),
                generated_ids=list(h.generated), finish_reason="deadline",
                submitted_at=h.submitted_at, admitted_at=h.admitted_at,
                finished_at=now, first_token_at=h.first_token_at))
        return results

    def _restore_decode_queued(self) -> int:
        """Seat host-spilled preempted sequences straight back into the
        DECODE scheduler: a decode preemption spilled its live pages and
        routed the entry to the prefill queue (the recompute path); when
        its tier record survives, the facade takes the entry off the
        prefill queue and adopts it decode-side with its pages scattered
        back — no re-prefill, replay_pos intact. Strict FIFO: stops at
        the first queue head without a record (or without decode room),
        so a restore never jumps an earlier admission."""
        tier, p, d = self.host_tier, self.prefill.sched, self.decode.sched
        restored = 0
        while p.queue:
            rid = p.queue[0].request.request_id
            rec = tier.get(("seq", rid))
            if rec is None or None not in d.slots:
                break
            headroom = len(d.active_indices())
            if d.pool.n_free < rec.pages + headroom:
                break
            page_ids = d.pool.alloc(rec.pages)
            if page_ids is None:
                break
            taken = p.take_queued(rid)
            if taken is None:
                d.pool.free(page_ids)
                break
            entry, submitted_at = taken
            self.programs.scatter_pages(self.decode_pages, page_ids,
                                        rec.payload)
            m = rec.meta
            d.adopt(request=entry.request, pages=page_ids,
                    cache_len=m["cache_len"],
                    generated=list(m["generated"]),
                    submitted_at=submitted_at,
                    admitted_at=m["admitted_at"],
                    first_token_at=entry.first_token_at, resumed=True,
                    replay_pos=m["replay_pos"])
            tier.take(("seq", rid))
            self.decode._dev = None
            restored += 1
        return restored

    def step(self) -> list[RequestResult]:
        """One iteration of the PAIR: prefill engine advances prompts
        (admissions + chunks, emitting handoffs), the facade expires
        in-transit deadlines, the decode engine seats handoffs and runs
        one batched decode. Preempted sequences route back to the prefill
        queue head with their generated suffix (recompute + replay)."""
        if getattr(self, "_publish_pending_swap", False):
            raise RuntimeError(
                "new_generation(params=...) already published the next "
                "policy into this pair's shared programs — stepping it "
                "before swap_generation would decode old-policy k/v "
                "under the new weights; run the swap first")
        self.stats_seq += 1
        if self.host_tier is not None:
            self._restore_decode_queued()
            p = self.prefill.sched
            if p.queue and p.cache is not None:
                head = p.queue[0].request
                restore_prefixes(
                    p.cache, self.host_tier, list(head.prompt_ids),
                    ns=int(getattr(head, "adapter_id", 0) or 0),
                    alloc=self._tier_alloc_prefill,
                    scatter=lambda ids, payload: self.programs.scatter_pages(
                        self.pages, ids, payload),
                    free=self.pool.free)
        finished = self.prefill.step()
        finished.extend(self._expire_in_transit())
        decoded, preempted = self.decode.step()
        finished.extend(decoded)
        # requeue preempted entries at the head of their priority class on
        # the prefill side, oldest-preempted last so relative order holds
        for entry, t_submit in reversed(preempted):
            self.prefill.sched.requeue_entry(entry, t_submit)
        self._lat.note(finished)
        return finished

    # ---- metrics -----------------------------------------------------------
    def partial_tokens(self) -> dict:
        """The streaming tap across the whole plane: prefill slots (the
        first token exists before handoff), in-transit handoffs, and
        decode slots — via the same single-sourced producer the monolith
        uses (``engine.collect_partial_tokens``: grow-only lists, so the
        SSE consumer's dedup-by-count stays exact under speculation)."""
        return collect_partial_tokens((self.prefill.sched,
                                       self.decode.sched),
                                      self.handoff.pending)

    def stats(self) -> dict:
        """Host-side snapshot (no device, no lock — see
        ServeEngine.stats). Admission/prefix/refusal counters come from
        the prefill scheduler, decode occupancy from the decode engine,
        and the handoff adds its transfer counters."""
        p, d = self.prefill.sched, self.decode.sched
        s = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in p.stats.items()}
        # counters that genuinely occur on BOTH sides are summed;
        # admission counters stay prefill-side (the decode scheduler's
        # adopt() is a handoff, not a new admission)
        for k in ("preempted", "deadline_expired", "cache_evicted_pages",
                  "finished", "spec_lookahead_clamped",
                  "deadline_missed_queued", "deadline_missed_running"):
            s[k] = p.stats[k] + d.stats[k]
        # per-adapter request counts are charged at submit (prefill side
        # only — adopt is a handoff, not a new request); merge the decode
        # side's dict anyway so a directly-submitted decode request is
        # never silently dropped from the tally
        areq = dict(p.stats.get("adapter_requests", {}))
        for aid, n in d.stats.get("adapter_requests", {}).items():
            areq[aid] = areq.get(aid, 0) + n
        s["adapter_requests"] = areq
        depths = p.queue_depth_by_priority()
        for prio, n in d.queue_depth_by_priority().items():
            depths[prio] = depths.get(prio, 0) + n
        cross = self.transport == "cross_host"
        out = {
            **s,
            "stats_seq": self.stats_seq,
            "preemptions": s.get("preempted", 0),
            "draining": self.draining,
            "transport": self.transport,
            "max_queue": p.max_queue,
            "queued": len(p.queue),
            "queue_depth_by_priority": depths,
            "handoff_pending": len(self.handoff),
            "prefilling_slots": len(p.prefilling_indices()),
            "active_slots": len(d.active_indices()),
            "n_prefill_slots": self.n_prefill_slots,
            "decode_horizon": self.decode.decode_horizon,
            "prefill_calls": self.programs.prefill_calls,
            "prefix_keys": (cache_prefix_keys(p.cache)
                            if p.cache is not None else []),
            # pool metrics read the DECODE pool (the serving-capacity
            # currency); same-host that IS the one shared pool, and the
            # cache pages live in whichever pool backs the prefill side
            **derived_pool_metrics(
                tier=self.host_tier,
                pool=self.decode_pool,
                cached_pages=0 if cross else p.cache_pages_held(),
                n_slots=self.n_slots,
                decode_steps=self.decode.decode_steps,
                decode_tokens=self.decode.decode_tokens,
                host_dispatches=self.decode.host_dispatches,
                horizon_ksum=self.decode.horizon_ksum,
                admitted=p.stats.get("admitted", 0),
                prefix_hits=s.get("prefix_hits", 0), lat=self._lat,
                bytes_per_page=kv_page_bytes(self.config,
                                             page_size=self.page_size,
                                             kv_dtype=self.kv_dtype),
                pool_dtype=self.kv_dtype),
            **spec_metrics(self.decode.spec,
                           decode_steps=self.decode.decode_steps,
                           decode_tokens=self.decode.decode_tokens,
                           drafter=self.decode.drafter),
            **{f"handoff_{k}": v for k, v in self.handoff.stats.items()},
            **adapter_metrics(self.adapter_pool,
                              publishes=self.programs.adapter_publish_count),
        }
        if cross:
            out.update({
                "prefill_pages_capacity": self.pool.capacity,
                "prefill_pages_free": self.pool.n_free,
                "prefill_pages_cached": p.cache_pages_held(),
            })
        return out

    def kv_report(self) -> dict:
        pool_bytes = pool_nbytes(self.pages)
        if self.transport == "cross_host":
            pool_bytes += pool_nbytes(self.decode_pages)
        return {
            **build_kv_report(
                self.programs, page_size=self.page_size,
                pool=self.decode_pool,
                cached_pages=self.prefill.sched.cache_pages_held(),
                n_slots=self.n_slots, max_pages=self.max_pages,
                pool_bytes=pool_bytes, tier=self.host_tier,
                decode_horizon=self.decode.decode_horizon),
            "transport": self.transport,
        }
