"""Orca-style iteration-level (continuous-batching) scheduler — host side.

The port keeps its own copy of the JAX package's
``serve/scheduler.py`` (which imports the JAX ``serve/kv_pages.py``):
the same code, reading this package's ``kv_pages``, plus
``PrefixCache.drop_all`` for a params publish. The engine hands it
its adapter pool (``serve/adapters.py``) and, with ``host_tier_bytes=``,
its host tier (``serve/tiering.py``) through ``attach_tier``.

The unit of scheduling is one ITERATION, not one request (Yu et al., OSDI
2022): after every batched decode step the engine asks the scheduler again
— finished sequences leave their slot immediately and queued requests take
it at the very next step, instead of the whole batch draining before any
admission (static batching wastes every early-finisher's slot for the
duration of the longest request).

Policy (the PagedAttention second half, Kwon et al. arXiv:2309.06180):

- PRIORITY-then-FIFO admission, OPTIMISTIC: the queue is ordered by
  request priority (higher admits first), FIFO within a class; the head
  admits when a slot is free AND the pool grants the pages its *current
  context* needs (prompt, or prompt + recompute suffix) — not the old
  worst-case ``pages_for_tokens(prompt + max_new)`` reservation that
  idled pages a short answer never touched. Strict order within the
  priority ordering, no lookahead.
- DEADLINES: a request may carry ``deadline_s`` (seconds from submit).
  ``expire_deadlines`` runs at every iteration boundary: an expired
  queued entry is removed, an expired RUNNING sequence is evicted
  CLEANLY (pages freed, partial tokens returned, finish_reason
  "deadline") — expiry is an orderly eviction through the same
  bookkeeping as EOS, never a mid-iteration abort.
- REFUSALS are structured: everything submit rejects raises
  :class:`RefusalError` carrying a machine-readable ``reason`` +
  suggested HTTP status + the current queue depth, and
  ``stats["refused"]`` counts refusals by reason (the HTTP layer
  returns the body verbatim instead of an opaque status).
- Growth on demand: a decoding sequence takes one page whenever its next
  token crosses a page boundary. On true exhaustion the scheduler first
  evicts idle prefix-cache pages, then PREEMPTS the youngest sequence —
  its pages are freed, its (request, tokens-so-far) re-enters the queue
  head, and on re-admission the context is RECOMPUTED: the prompt
  re-prefills (or re-shares), then the generated suffix REPLAYS through
  the decode program itself, one discarded step per token. The replay is
  deliberately not a prefill: the decode program writing each token's
  k/v is the program that wrote it originally, so the rebuilt cache is
  BITWISE the original and the continuation token-identical (a prefill
  recompute of the suffix agrees only to ~1e-7 — enough to flip an
  argmax). The old invariant "exhaustion can only refuse, never corrupt"
  becomes "exhaustion can only refuse or cleanly preempt, never corrupt"
  — the oldest sequence always wins growth, so progress is guaranteed
  whenever one worst-case request fits the pool (validated at submit).
- PREFIX SHARING: committed full prompt pages register in a content-keyed
  prefix tree; a new prompt walks the tree and takes refcounted
  references to every matching physical page instead of recomputing it
  (system prompts amortize across every request that carries them). A
  match may end mid-page; the partially-matched page is forked
  COPY-ON-WRITE at admission — the first write into shared territory is
  what triggers the copy (``kv_pages.copy_pages`` is the device copy the
  engine runs; the fork bookkeeping is decided here).
- Eviction on EOS or length cap, at the iteration boundary; page
  references drop and the slot re-enters admission the same iteration.

This module is pure host Python (numpy only): deterministic, unit-testable,
and the only owner of slot/page bookkeeping. The engine consumes its state
as flat numpy arrays shaped ``[n_slots]``/``[n_slots, max_pages]`` — the
ONE compiled decode step is a function of those arrays, so scheduling
decisions never trigger a recompile.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional

import numpy as np

from .kv_pages import TRASH_PAGE, PagePool, pages_for_tokens


class RefusalError(ValueError):
    """A structured scheduler refusal: ``reason`` is a stable
    machine-readable slug (counted in ``stats['refused']``),
    ``http_status`` the suggested mapping (429 for backpressure, 400 for
    a request that could never run), ``detail`` whatever load context the
    client should see (always includes ``queue_depth``)."""

    def __init__(self, reason: str, message: str, *, http_status: int = 400,
                 detail: Optional[dict] = None):
        super().__init__(message)
        self.reason = reason
        self.http_status = http_status
        self.detail = dict(detail or {})
        # backpressure refusals carry a retry hint (seconds) derived from
        # the refusing scheduler's load; the HTTP layer maps it to a
        # Retry-After header and the fleet router to a routing penalty
        self.retry_after_s: Optional[float] = self.detail.get("retry_after_s")


@dataclasses.dataclass
class Request:
    """One generation request. ``temperature == 0`` is greedy; ``top_k <= 0``
    and ``top_p >= 1`` disable those filters. ``seed`` drives the slot's
    private RNG stream (sampling keys are fold_in(seed, absolute token
    position) — deterministic per request, independent of admission order,
    co-residents, AND preemption/recompute). ``priority`` orders admission
    (higher first, FIFO within a class); ``deadline_s`` (seconds from
    submit) evicts the request cleanly at the first iteration boundary
    past the deadline, queued or running."""

    prompt_ids: list
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    eos_id: Optional[int] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    # which pooled LoRA adapter decodes this request: 0 is the zero
    # adapter (base model, always servable); any other id must be LIVE
    # in the engine's AdapterPool at submit or the request is refused
    # ("unknown_adapter") — admission never blocks on adapter loads
    adapter_id: int = 0
    request_id: Optional[int] = None  # assigned at submit


@dataclasses.dataclass
class RequestResult:
    request_id: int
    prompt_ids: list
    generated_ids: list
    finish_reason: str              # "eos" | "length" | "deadline"
    submitted_at: float
    admitted_at: float
    finished_at: float
    first_token_at: float = 0.0     # 0.0 = no token ever produced

    @property
    def token_ids(self) -> list:
        return list(self.prompt_ids) + list(self.generated_ids)

    @property
    def latency_s(self) -> float:
        return self.finished_at - self.submitted_at

    @property
    def queue_s(self) -> float:
        return self.admitted_at - self.submitted_at

    @property
    def ttft_s(self) -> float:
        """Time to first token (the streaming layer's headline metric)."""
        return (self.first_token_at - self.submitted_at
                if self.first_token_at else 0.0)

    @property
    def itl_s(self) -> float:
        """Mean inter-token latency over tokens after the first."""
        n = len(self.generated_ids)
        if n < 2 or not self.first_token_at:
            return 0.0
        return (self.finished_at - self.first_token_at) / (n - 1)


@dataclasses.dataclass
class _Slot:
    request: Request
    pages: list                     # physical pages, logical order
    generated: list
    cache_len: int                  # tokens currently IN the kv pages
    admitted_at: float
    seq: int                        # admission order; max = youngest
    target_len: int                 # tokens the prefill must commit
    prefilling: bool                # True until cache_len == target_len
    shared_len: int = 0             # tokens taken from the prefix cache
    resumed: bool = False           # re-admission after preemption
    first_token_at: float = 0.0     # survives preemption via _QueueEntry
    # index of the token the next decode step consumes. Normal slots sit
    # at len(generated) - 1 (the newest sample); a resumed slot starts at
    # 0 and REPLAYS its recorded tokens through the decode program —
    # samples along the way are discarded (they equal the recording
    # bitwise: same program, same cache state)
    replay_pos: int = 0

    @property
    def replaying(self) -> bool:
        return self.replay_pos < len(self.generated) - 1


@dataclasses.dataclass
class _QueueEntry:
    """Queue item: a fresh request, or a preempted sequence carrying the
    tokens it had already generated (the recompute state)."""
    request: Request
    generated: list = dataclasses.field(default_factory=list)
    first_token_at: float = 0.0


@dataclasses.dataclass
class Admission:
    """One try_admit grant, with everything the engine needs to run the
    prefill: the prompt to (re)compute, how much of it is already
    resident via shared pages, and the CoW fork to copy first. A resumed
    sequence prefills its PROMPT only — the generated suffix replays
    through the decode loop afterwards (see module docstring)."""
    slot_idx: int
    request: Request
    tokens: list                    # the prompt (the prefill target)
    shared_len: int                 # prefix tokens already in shared pages
    fork: Optional[tuple]           # (src_page, dst_page) device copy
    resumed: bool


class _PrefixNode:
    """One registered page in the prefix tree: children are keyed by the
    NEXT page's full token content, so a chain of dict hits walks shared
    physical pages in O(prefix) with zero hashing of the whole prompt."""

    __slots__ = ("page", "tokens", "children", "parent", "last_used")

    def __init__(self, page, tokens, parent):
        self.page = page
        self.tokens = tokens
        self.children: dict = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Content-keyed tree of committed full prompt pages. The cache holds
    ONE pool reference per registered page, so a page survives its
    sequence and is reused by the next prompt that carries the same
    prefix; eviction (leaves only, LRU) drops that reference — the page
    returns to the free list once no slot reads it either."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root = _PrefixNode(None, (), None)
        # cached k/v depends on the ADAPTER that produced it: any target
        # projection shifts every layer's hidden states, so a page
        # computed under adapter 3 must never serve a prompt decoding
        # under adapter 5. Namespacing the tree roots by adapter_id is
        # the whole fix — ``root`` stays the base-model (adapter-0)
        # namespace so adapter-free deployments see the old tree shape.
        self._roots: dict[int, _PrefixNode] = {0: self.root}
        self._tick = itertools.count(1)
        self.n_pages = 0
        # host-tier spill hooks (serve/tiering.py, duck-typed so this
        # module stays import-free of it): with a tier attached,
        # eviction GATHERS the page's bytes before freeing it instead
        # of discarding them
        self._tier = None
        self._gather = None

    def attach_tier(self, tier, gather) -> None:
        """Install a host tier: ``gather(page_ids) -> payload`` reads
        the engine's live pool (the engine owns the device handle)."""
        self._tier = tier
        self._gather = gather

    def _root_for(self, ns: int) -> _PrefixNode:
        root = self._roots.get(ns)
        if root is None:
            root = self._roots[ns] = _PrefixNode(None, (), None)
        return root

    def drop_namespace(self, ns: int) -> int:
        """Free every page registered under adapter namespace ``ns`` —
        called when an adapter slot is recycled by a NEW insert: the
        slot id survives but the weights changed, so cached k/v computed
        under the old tenant would silently corrupt the new one's
        prompts. Returns the number of pages dropped."""
        root = self._roots.get(ns)
        if root is None:
            return 0
        dropped = 0
        stack = list(root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.pool.free([node.page])
            self.n_pages -= 1
            dropped += 1
        root.children = {}
        if ns != 0:
            del self._roots[ns]
        return dropped

    def drop_all(self) -> int:
        """Free every registered page of every namespace: called when the
        weights that computed them are replaced (a params publish).
        Returns the number of pages dropped."""
        return sum(self.drop_namespace(ns) for ns in list(self._roots))

    def match(self, tokens: list, allow_partial: bool, ns: int = 0):
        """Longest chain of registered pages covering a PROPER prefix of
        ``tokens`` (at least one token is always left to recompute — the
        last position's logits must come from a live forward). Returns
        (full_nodes, partial): ``partial`` is (node, n_tokens) when
        ``allow_partial`` and a child page's content matches ≥ 1 of the
        remaining tokens — the CoW candidate."""
        page = self.page_size
        tick = next(self._tick)
        node, full, pos = self._root_for(ns), [], 0
        while pos + page <= len(tokens) - 1:
            child = node.children.get(tuple(tokens[pos:pos + page]))
            if child is None:
                break
            child.last_used = tick
            full.append(child)
            node, pos = child, pos + page
        partial = None
        if allow_partial and pos < len(tokens) - 1:
            remaining = tokens[pos:]
            best = 0
            for child in node.children.values():
                n = 0
                for a, b in zip(child.tokens, remaining):
                    if a != b:
                        break
                    n += 1
                n = min(n, len(tokens) - 1 - pos)
                if n > best:
                    best, partial = n, (child, n)
            if partial is not None:
                partial[0].last_used = tick
        return full, partial

    def chain_depth(self, tokens: list, ns: int = 0) -> int:
        """Full-page chain length resident in HBM for ``tokens`` —
        ``match`` without the side effects (no LRU touch, no partial
        scan); the restore/pull paths use it to find where the HBM
        chain ends and the tier/sibling chain must take over."""
        page = self.page_size
        node = self._roots.get(ns)
        if node is None:
            return 0
        depth = pos = 0
        while pos + page <= len(tokens) - 1:
            child = node.children.get(tuple(tokens[pos:pos + page]))
            if child is None:
                break
            depth += 1
            node, pos = child, pos + page
        return depth

    def chain_pages(self, tokens: list, ns: int = 0) -> list:
        """Physical page ids of the resident chain for ``tokens``, in
        depth order — what a directory pull gathers at the SOURCE. Pure
        read: no references move, no LRU touch."""
        page = self.page_size
        node = self._roots.get(ns)
        if node is None:
            return []
        out, pos = [], 0
        while pos + page <= len(tokens) - 1:
            child = node.children.get(tuple(tokens[pos:pos + page]))
            if child is None:
                break
            out.append(child.page)
            node, pos = child, pos + page
        return out

    def insert_page(self, tokens: list, page_id: int, ns: int = 0) -> bool:
        """Seat one already-allocated page as the chain node covering
        ``tokens`` (whose length must be a page multiple; the node owns
        the LAST page worth). The cache takes over the CALLER'S pool
        reference — no share — so the caller must free the page iff
        this returns False (missing ancestor, or the node already
        resident)."""
        page = self.page_size
        if not tokens or len(tokens) % page:
            return False
        node, pos = self._root_for(ns), 0
        while pos + page < len(tokens):
            child = node.children.get(tuple(tokens[pos:pos + page]))
            if child is None:
                return False
            node, pos = child, pos + page
        key = tuple(tokens[pos:pos + page])
        if key in node.children:
            return False
        child = _PrefixNode(page_id, key, node)
        child.last_used = next(self._tick)
        node.children[key] = child
        self.n_pages += 1
        return True

    def _chain_key(self, node: _PrefixNode) -> tuple:
        """(namespace, cumulative token tuple) for a node — the spill
        key ``restore_prefixes`` reconstructs from a prompt."""
        segs = []
        n = node
        while n.parent is not None:
            segs.append(n.tokens)
            n = n.parent
        full = tuple(int(t) for seg in reversed(segs) for t in seg)
        ns = next((k for k, r in self._roots.items() if r is n), 0)
        return ns, full

    def register(self, tokens: list, pages: list, ns: int = 0) -> None:
        """Insert every FULL page of ``tokens`` (page i holds
        tokens[i*page:(i+1)*page], physical id pages[i]); the cache takes
        one pool reference per page it newly adopts. Existing nodes with
        the same content win — duplicates are not double-registered."""
        page = self.page_size
        tick = next(self._tick)
        node, pos, i = self._root_for(ns), 0, 0
        while pos + page <= len(tokens):
            key = tuple(tokens[pos:pos + page])
            child = node.children.get(key)
            if child is None:
                child = _PrefixNode(pages[i], key, node)
                self.pool.share([pages[i]])
                node.children[key] = child
                self.n_pages += 1
            child.last_used = tick
            node, pos, i = child, pos + page, i + 1

    def evict_one(self) -> bool:
        """Drop the least-recently-used LEAF (leaves only — interior
        evictions would orphan reachable children into leaked refs).
        Returns False when the cache is empty."""
        best, best_key, best_parent = None, None, None
        stack = list(self._roots.values())
        while stack:
            node = stack.pop()
            for key, child in node.children.items():
                if child.children:
                    stack.append(child)
                elif best is None or child.last_used < best.last_used:
                    best, best_key, best_parent = child, key, node
        if best is None:
            return False
        if self._tier is not None and self._gather is not None:
            # spill instead of discard: gather the page's bytes (every
            # pool leaf, scales included) into the host tier keyed by
            # the chain's cumulative content — the HBM slot still frees
            # below, so the pool identity is untouched and a later
            # restore re-allocates and scatters bitwise
            ns, full = self._chain_key(best)
            self._tier.put(("prefix", ns, full),
                           self._gather([best.page]), pages=1,
                           meta={"ns": ns})
        del best_parent.children[best_key]
        self.pool.free([best.page])
        self.n_pages -= 1
        return True


class Scheduler:
    """Slot + page bookkeeping for the engine. All mutation goes through
    ``submit`` / ``try_admit`` / ``commit_tokens`` / ``grow_for_decode`` /
    ``record_token`` so the invariants (page ownership, FIFO order,
    refcount lifecycle, preemption-never-corrupts) live in one place.
    """

    def __init__(self, *, n_slots: int, pool: PagePool, max_len: int,
                 max_pages_per_slot: int, clock=time.monotonic,
                 prefix_cache: bool = True,
                 allow_partial_share: bool = False,
                 max_queue: Optional[int] = None,
                 admission_headroom=None, spec_lookahead: int = 0,
                 adapter_pool=None, decode_horizon: int = 1):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.n_slots = n_slots
        self.pool = pool
        self.max_len = max_len
        self.max_pages = max_pages_per_slot
        self.max_queue = max_queue
        self.slots: list[Optional[_Slot]] = [None] * n_slots
        # priority-ordered (higher first, FIFO within a class); index 0 is
        # the admission head. Plain list: depths are human-scale and the
        # ordered insert keeps every existing head/pop call site simple.
        self.queue: list[_QueueEntry] = []
        self._ids = itertools.count()
        self._seq = itertools.count()
        self._clock = clock
        self._submit_times: dict[int, float] = {}
        # prefix_cache may be a PrefixCache INSTANCE: the disaggregated
        # decode scheduler shares the prefill side's cache so its
        # growth-under-pressure can evict idle cached pages too (it never
        # registers or matches — admission lives on the prefill side)
        self.cache = (prefix_cache if isinstance(prefix_cache, PrefixCache)
                      else (PrefixCache(pool) if prefix_cache else None))
        self.allow_partial_share = allow_partial_share
        # extra admission headroom beyond THIS scheduler's running decodes
        # — the disaggregated prefill scheduler has no decoding slots of
        # its own, so its engine threads the DECODE side's count through
        # this hook (admitting into that margin trades one admission for
        # immediate preemption churn over there)
        self._headroom_fn = admission_headroom
        # speculative decoding widens the per-decode admission margin: a
        # verify step may scatter up to 1 + spec_lookahead tokens per
        # slot, so each running decode can claim that many positions'
        # worth of pages within one iteration instead of one token's
        if spec_lookahead < 0:
            raise ValueError(f"spec_lookahead must be >= 0, got "
                             f"{spec_lookahead}")
        self.spec_lookahead = spec_lookahead
        # fused-decode horizon (serve/engine.py decode_horizon=K): the
        # engine runs K decode iterations per host dispatch, so every
        # running decode can consume K positions' worth of pages between
        # two scheduling boundaries — admission margins scale to it
        # exactly like spec_lookahead. Mutable: the controller's
        # set_decode_horizon actuation updates it at a boundary.
        if decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, got "
                             f"{decode_horizon}")
        self.decode_horizon = decode_horizon
        # shared AdapterPool (serve/adapters.py) when the engine serves
        # pooled LoRA adapters; refcounts track requests INSIDE this
        # scheduler (queued or seated): retained at every entry point
        # (submit/requeue/adopt), released at every exit (finish,
        # deadline, release_slot, drain_queue) — preemption and
        # admission move a request WITHIN the scheduler and touch
        # nothing. The disagg pair shares one pool, so a handoff's
        # release-then-retain is net-neutral on the tenant's count.
        self.adapter_pool = adapter_pool
        # host-tier spill hooks (serve/tiering.py, duck-typed): with a
        # tier attached, PREEMPTION spills the victim's live pages
        # instead of discarding them, so re-admission is scatter-and-
        # seat (engine-side restore_queued) rather than re-prefill +
        # replay. Spilled or not, the requeue below still happens — the
        # recompute path stays the universal fallback.
        self._tier = None
        self._tier_gather = None
        self.stats = {"admission_blocked": 0, "admitted": 0, "finished": 0,
                      "preempted": 0, "prefix_hits": 0,
                      "prefix_tokens_shared": 0, "cow_forks": 0,
                      "cache_evicted_pages": 0, "deadline_expired": 0,
                      # deadline_expired split BY REASON — a controller
                      # reads these very differently: queued expiry means
                      # admission is the bottleneck (scale up / shed),
                      # running eviction means deadlines are too tight
                      # for the decode rate itself
                      "deadline_missed_queued": 0,
                      "deadline_missed_running": 0,
                      "spec_lookahead_clamped": 0, "refused": {},
                      # requests submitted per adapter slot (keyed by
                      # adapter_id) — the per-tenant demand signal the
                      # router aggregates fleet-wide
                      "adapter_requests": {}}

    def attach_tier(self, tier, gather) -> None:
        """Install the host tier on THIS scheduler's preemption path
        (the prefix cache has its own ``attach_tier`` — disaggregated
        pairs gather from different pools on each side)."""
        self._tier = tier
        self._tier_gather = gather

    # ---- adapter refcounts -------------------------------------------------
    def _adapter_retain(self, request: Request) -> None:
        if self.adapter_pool is not None:
            self.adapter_pool.retain(int(request.adapter_id))

    def _adapter_release(self, request: Request) -> None:
        if self.adapter_pool is not None:
            self.adapter_pool.release(int(request.adapter_id))

    # ---- refusals / queue order --------------------------------------------
    def refuse(self, reason: str, message: str, *, http_status: int = 400,
               **detail):
        """Count + raise a structured refusal (see RefusalError)."""
        self.stats["refused"][reason] = \
            self.stats["refused"].get(reason, 0) + 1
        raise RefusalError(reason, message, http_status=http_status,
                           detail={"queue_depth": len(self.queue), **detail})

    def retry_after_hint(self) -> float:
        """Seconds a refused client should wait before retrying — a HINT
        monotone in load, not a promise: one nominal iteration's worth of
        time per queued-ahead request, scaled up as the decode batch
        fills (a saturated batch drains its queue slower). Derived only
        from queue depth and decode occupancy, the two numbers the
        scheduler itself owns; the aggregate-latency refinement lives
        with whoever holds a LatencyMeter."""
        occupancy = len(self.active_indices()) / self.n_slots
        return round(0.05 * (1 + len(self.queue)) * (1 + occupancy), 3)

    def queue_depth_by_priority(self) -> dict[int, int]:
        """Queued entries per priority class (higher = more urgent).
        A flat queue depth hides WHO is waiting: the controller's shed
        ladder needs to see low-priority work backing up separately from
        interactive traffic before it refuses anybody."""
        depths: dict[int, int] = {}
        for entry in self.queue:
            p = int(entry.request.priority)
            depths[p] = depths.get(p, 0) + 1
        return depths

    def requeue_entry(self, entry: _QueueEntry, submitted_at: float) -> None:
        """Re-enter an EXISTING entry (its request_id and submit time
        survive) at the head of its priority class — the disaggregated
        facade moves decode-side preemptions back to the prefill queue
        through this, and the cross-host handoff requeues a sequence
        whose transfer crashed or timed out mid-flight."""
        self._submit_times[entry.request.request_id] = submitted_at
        self._queue_insert(entry, front=True)
        self._adapter_retain(entry.request)

    def requeue(self, request: Request, generated=(), *,
                first_token_at: float = 0.0,
                submitted_at: Optional[float] = None,
                front: bool = True, new_id: bool = True) -> int:
        """Admit an ALREADY-VALIDATED request carrying a generated suffix
        into this scheduler — the router's fence recovery (a request in
        flight on a dead/wedged replica resubmits here under a fresh
        local id) and the cross-host handoff's drop recovery (the same
        sequence returns to ITS OWN queue, ``new_id=False`` keeping the
        id its submitter holds). Either way the prompt re-prefills and
        the recorded tokens REPLAY through the decode program
        (position-keyed sampling makes the continuation token-identical
        to the uninterrupted run). Skips submit()'s validation — the
        original submit already ran it — and defaults to the queue head:
        the request is older than anything queued here. Returns the
        local request id."""
        if new_id or request.request_id is None:
            request = dataclasses.replace(request,
                                          request_id=next(self._ids))
        self._submit_times[request.request_id] = (
            self._clock() if submitted_at is None else submitted_at)
        self._queue_insert(_QueueEntry(request, list(generated),
                                       first_token_at), front=front)
        self._adapter_retain(request)
        return request.request_id

    def drain_queue(self) -> list[tuple[_QueueEntry, float]]:
        """Remove and return EVERY queued entry with its submit time, in
        queue order — the disaggregated decode side hands preempted
        entries back to the prefill queue through this, and an
        engine-generation swap (serve/elastic.py) exports the old
        generation's queue with it. The entries keep their request ids:
        re-entering them elsewhere goes through ``requeue(new_id=False)``
        / ``requeue_entry``."""
        out = []
        while self.queue:
            entry = self.queue.pop(0)
            self._adapter_release(entry.request)
            out.append((entry,
                        self._submit_times.pop(entry.request.request_id)))
        return out

    def ensure_ids_above(self, n: int) -> None:
        """Advance the request-id counter past ``n``: sequences carried
        into this scheduler from another generation keep their original
        ids (the caller's handles must survive the swap), so future
        submits here must never collide with them."""
        current = next(self._ids)
        self._ids = itertools.count(max(current, int(n)))

    def _queue_insert(self, entry: _QueueEntry, *, front: bool = False) -> None:
        """Ordered insert: after every entry of >= priority (submit — FIFO
        within the class), or before every entry of <= priority (``front``
        — a preempted sequence re-enters at the head of its class, but
        never ahead of strictly higher-priority work)."""
        p = entry.request.priority
        if front:
            i = next((i for i, e in enumerate(self.queue)
                      if e.request.priority <= p), len(self.queue))
        else:
            i = next((i for i, e in enumerate(self.queue)
                      if e.request.priority < p), len(self.queue))
        self.queue.insert(i, entry)

    # ---- allocation under pressure -----------------------------------------
    def _ensure_free(self, n: int) -> bool:
        """Evict idle prefix-cache pages (LRU leaves) until ``n`` are free
        or the cache is drained. False means the pool is truly out —
        every remaining page is owned by a slot."""
        while self.pool.n_free < n and self.cache is not None:
            if not self.cache.evict_one():
                break
            self.stats["cache_evicted_pages"] += 1
        return self.pool.n_free >= n

    def _alloc(self, n: int, headroom: int = 0) -> Optional[list]:
        """Allocate with cache pressure, keeping ``headroom`` pages free
        after the grant (admission uses one page of lookahead per running
        decode so a new prompt doesn't immediately force preemptions)."""
        if not self._ensure_free(n + headroom):
            return None
        return self.pool.alloc(n)

    def cache_pages_held(self) -> int:
        """Pages whose only purpose right now may be prefix reuse — the
        pool-accounting identity is ``n_free + slot-held + cache-only ==
        capacity`` (a page can be both slot-held and cached; this counts
        cache REFERENCES, each of which pins one ``free`` call)."""
        return 0 if self.cache is None else self.cache.n_pages

    # ---- admission ---------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Validate + enqueue; returns the request id. Refuses requests
        that could NEVER run (empty prompt, context past max_len, worst-case
        pages past the whole pool — with preemption-by-recompute the pool
        must still fit ONE worst-case request or the retry loop could never
        terminate) with a 400-class RefusalError, and refuses on a full
        queue (``max_queue`` backpressure) with a 429-class one — refusing
        at submit keeps the queue head from deadlocking forever, and the
        structured reason keeps the client from guessing why."""
        n = len(request.prompt_ids)
        if n < 1:
            self.refuse("empty_prompt", "empty prompt")
        if request.max_new_tokens < 1:
            self.refuse("bad_params",
                        f"max_new_tokens must be >= 1, got "
                        f"{request.max_new_tokens}")
        if not 0.0 <= request.temperature:
            self.refuse("bad_params", f"temperature must be >= 0, got "
                        f"{request.temperature}")
        if not 0.0 < request.top_p <= 1.0:
            self.refuse("bad_params",
                        f"top_p must be in (0, 1], got {request.top_p}")
        if not 0 <= request.seed < 2 ** 31:
            # the engine carries seeds as int32 arrays; refusing here beats
            # an OverflowError mid-flight with the slot already admitted
            self.refuse("bad_params",
                        f"seed must fit int32 (0 <= seed < 2**31), got "
                        f"{request.seed}")
        if not -(2 ** 31) <= request.top_k < 2 ** 31:
            # same int32 path as seed (decode_arrays): an unchecked top_k
            # would overflow AFTER admission and kill the engine thread
            # (top_k <= 0 stays a valid "disabled")
            self.refuse("bad_params", f"top_k must fit int32, got "
                        f"{request.top_k}")
        if request.deadline_s is not None and request.deadline_s <= 0:
            self.refuse("bad_params", f"deadline_s must be > 0, got "
                        f"{request.deadline_s}")
        aid = request.adapter_id
        if isinstance(aid, bool) or not isinstance(aid, (int, np.integer)):
            self.refuse("bad_params",
                        f"adapter_id must be an int, got {aid!r}")
        if aid != 0:
            # refuse UNKNOWN adapters at submit (not mid-flight): the
            # pool never loads on demand, so an id that is not live now
            # could only ever decode garbage from a recycled slot
            if self.adapter_pool is None:
                self.refuse(
                    "unknown_adapter",
                    f"adapter_id {aid} but this engine serves no adapter "
                    f"pool (constructed with max_adapters=None)")
            if not self.adapter_pool.is_live(int(aid)):
                self.refuse(
                    "unknown_adapter",
                    f"adapter_id {aid} is not resident in the adapter "
                    f"pool (live: {self.adapter_pool.live_slots()}) — "
                    f"publish the adapter first",
                    http_status=404)
        total = n + request.max_new_tokens
        if total > self.max_len:
            self.refuse(
                "context_too_long",
                f"prompt ({n}) + max_new_tokens ({request.max_new_tokens}) "
                f"= {total} exceeds the engine's max_len ({self.max_len})")
        if pages_for_tokens(total, self.pool.page_size) > self.pool.capacity:
            self.refuse(
                "exceeds_pool",
                f"request needs {pages_for_tokens(total, self.pool.page_size)}"
                f" pages, more than the whole pool ({self.pool.capacity}) — "
                f"it could never run to completion even alone")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.refuse(
                "queue_full",
                f"admission queue is full ({len(self.queue)} >= "
                f"{self.max_queue}); retry later", http_status=429,
                retry_after_s=self.retry_after_hint())
        request = dataclasses.replace(request,
                                      request_id=next(self._ids))
        self._submit_times[request.request_id] = self._clock()
        self._queue_insert(_QueueEntry(request))
        self._adapter_retain(request)
        counts = self.stats["adapter_requests"]
        counts[int(aid)] = counts.get(int(aid), 0) + 1
        return request.request_id

    def try_admit(self) -> list[Admission]:
        """Admit queue-head entries (priority order, FIFO within a class)
        while a slot is free and the pool (after prefix sharing) grants the
        CURRENT context's pages. Preempted entries sit at the head of
        their priority class and re-admit first — their context includes
        the tokens already generated (recompute). The engine runs each
        admission's fork copy + prefill, reporting progress through
        ``commit_tokens``."""
        admissions = []
        page = self.pool.page_size
        while self.queue:
            slot_idx = next((i for i, s in enumerate(self.slots)
                             if s is None), None)
            if slot_idx is None:
                break
            entry = self.queue[0]
            req = entry.request
            # the prefill target is the PROMPT alone, resumed or not: a
            # preempted sequence's generated tokens replay through the
            # decode program after the prompt is back (bitwise recompute)
            tokens = list(req.prompt_ids)
            full, partial = ([], None) if self.cache is None else \
                self.cache.match(tokens, self.allow_partial_share,
                                 ns=int(req.adapter_id))
            k_full = len(full)
            shared_len = k_full * page + (partial[1] if partial else 0)
            n_priv = pages_for_tokens(len(tokens), page) - k_full
            # take the references on every matched page BEFORE allocation:
            # _alloc's cache-eviction pressure may drop the matched nodes
            # themselves (their cache ref could be the only one), and a
            # share-after-evict would either crash on a dead page or hand
            # this slot a page alloc just handed out again as its own private one
            shared_pages = [node.page for node in full]
            self.pool.share(shared_pages)
            protect = [partial[0].page] if partial else []
            if protect:              # the CoW source must survive too — the
                self.pool.share(protect)   # engine copies it after we return
            # headroom: every running decode may need a page within one
            # page_size worth of steps — admitting into that margin would
            # trade one prompt's admission for immediate preemption churn
            # (decodes running in a sibling scheduler count via the hook).
            # Under speculation each decode can consume 1 + spec_lookahead
            # positions per iteration, and under a K-step horizon K
            # positions per BOUNDARY, so the margin scales to the pages
            # that worth of tokens can claim.
            per_decode = pages_for_tokens(
                self.decode_horizon + self.spec_lookahead, page)
            headroom = (len(self.active_indices()) + (
                self._headroom_fn() if self._headroom_fn else 0)) * per_decode
            priv = self._alloc(n_priv, headroom=headroom)
            if protect:
                # safe to release now: if the source node was evicted
                # above, its page can only be handed out again to a LATER
                # admission in this same loop, and the engine executes
                # each admission's fork copy before any later admission's
                # writes — the copy always reads the original bytes
                self.pool.free(protect)
            if priv is None:
                # backpressure: head blocks (strict FIFO), decode goes on —
                # release the speculative references and stay queued
                self.pool.free(shared_pages)
                self.stats["admission_blocked"] += 1
                break
            fork = None
            if partial is not None:
                # the first private page starts life as a CoW fork of the
                # partially-matched shared page: the remainder prefill is
                # about to write into its territory
                fork = (partial[0].page, priv[0])
                self.stats["cow_forks"] += 1
            if shared_len:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_shared"] += shared_len
            self.queue.pop(0)
            if self._tier is not None and entry.generated:
                # recompute admission won over a pending restore (its
                # allocation kept failing, or the share-aware grant here
                # was simply cheaper): the spilled record is stale now —
                # drop it and count the miss. The replay that follows is
                # still bitwise; only the recompute savings are lost.
                if self._tier.drop(("seq", req.request_id)):
                    self._tier.note_miss()
            self.slots[slot_idx] = _Slot(
                request=req, pages=shared_pages + priv,
                generated=list(entry.generated), cache_len=shared_len,
                admitted_at=self._clock(), seq=next(self._seq),
                target_len=len(tokens), prefilling=True,
                shared_len=shared_len, resumed=bool(entry.generated),
                replay_pos=0, first_token_at=entry.first_token_at)
            self.stats["admitted"] += 1
            admissions.append(Admission(
                slot_idx=slot_idx, request=req, tokens=tokens,
                shared_len=shared_len, fork=fork,
                resumed=bool(entry.generated)))
        return admissions

    # ---- prefill progress --------------------------------------------------
    def commit_tokens(self, slot_idx: int, n: int) -> None:
        """The engine committed ``n`` more context tokens into the slot's
        pages (one prefill chunk, or the whole bucket). When the target is
        reached the slot joins the decode batch and its full prompt pages
        register in the prefix cache."""
        slot = self.slots[slot_idx]
        assert slot is not None and slot.prefilling, \
            f"commit_tokens on non-prefilling slot {slot_idx}"
        slot.cache_len += n
        assert slot.cache_len <= slot.target_len, \
            f"prefill overran its target on slot {slot_idx}"
        if slot.cache_len == slot.target_len:
            slot.prefilling = False
            if self.cache is not None:
                n_prompt = len(slot.request.prompt_ids)
                n_full = n_prompt // self.pool.page_size
                self.cache.register(list(slot.request.prompt_ids[:n_full
                                         * self.pool.page_size]),
                                    slot.pages[:n_full],
                                    ns=int(slot.request.adapter_id))

    # ---- growth + preemption ----------------------------------------------
    def preempt(self, slot_idx: int) -> None:
        """Cleanly un-admit a sequence: its pages' references drop, its
        (request, generated-so-far) re-enters at the HEAD of its priority
        class, and the next admission recomputes the context — no token it
        already produced is lost or changed (position-keyed sampling), no
        running sequence is ever corrupted."""
        slot = self.slots[slot_idx]
        assert slot is not None, f"preempting idle slot {slot_idx}"
        if (self._tier is not None and self._tier_gather is not None
                and not slot.prefilling and slot.generated):
            # spill the LIVE context before the references drop: exactly
            # the pages cache_len occupies (cache_len == prompt +
            # replay_pos for a decoding slot — a victim preempted
            # mid-replay spills its partial rebuild, and replay_pos in
            # the record makes the restore seat exact)
            n_pages = pages_for_tokens(slot.cache_len, self.pool.page_size)
            self._tier.put(
                ("seq", slot.request.request_id),
                self._tier_gather(slot.pages[:n_pages]), pages=n_pages,
                meta={"cache_len": slot.cache_len,
                      "generated": list(slot.generated),
                      "replay_pos": slot.replay_pos,
                      "admitted_at": slot.admitted_at})
        self.pool.free(slot.pages)
        self.slots[slot_idx] = None
        self._queue_insert(_QueueEntry(slot.request, list(slot.generated),
                                       slot.first_token_at), front=True)
        self.stats["preempted"] += 1

    def grow_for_decode(self) -> tuple[int, int]:
        """Before a decode step: every decoding slot must own the page its
        next write lands in. Oldest slots grow first; on exhaustion the
        LOWEST-PRIORITY live sequence is preempted, youngest first within
        a class (possibly the grower itself, when nothing cheaper is left)
        and its pages fund the others. Returns (pages_grown, preempted)."""
        grown = preempted = 0
        order = sorted((i for i, s in enumerate(self.slots)
                        if s is not None and not s.prefilling),
                       key=lambda i: self.slots[i].seq)
        for slot_idx in order:
            slot = self.slots[slot_idx]
            if slot is None:        # preempted as a victim earlier in loop
                continue
            while slot.cache_len // self.pool.page_size >= len(slot.pages):
                pages = self._alloc(1)
                if pages is not None:
                    slot.pages.extend(pages)
                    grown += 1
                    continue
                victim = max((i for i, s in enumerate(self.slots)
                              if s is not None),
                             key=lambda i: (-self.slots[i].request.priority,
                                            self.slots[i].seq))
                self.preempt(victim)
                preempted += 1
                if victim == slot_idx:
                    break           # the grower itself was the victim
        return grown, preempted

    def ensure_lookahead(self, slot_idx: int, extra: int) -> int:
        """Grow a decoding slot's pages to cover ``extra`` SPECULATED
        positions beyond its next write (the verify scatter targets
        positions cache_len .. cache_len + extra). Opportunistic, unlike
        ``grow_for_decode``: allocation failure (after cache-eviction
        pressure) CLAMPS the lookahead instead of preempting — candidate
        tokens are a throughput optimization and must never cost a live
        sequence its pages — so the grant also keeps one page of
        headroom per OTHER active decode (their imminent MANDATORY
        next-write page: draining the pool for drafts here would hand
        the next ``grow_for_decode`` a preemption spec-off never takes).
        Returns the extra positions actually covered;
        the engine drops the drafts past that. Rejected speculation needs
        no un-grow: ``lengths`` rolls back and the next scatter
        overwrites the dead k/v in place, so a granted page simply
        arrives a few tokens early."""
        if extra < 0:
            raise ValueError(f"lookahead must be >= 0, got {extra}")
        slot = self.slots[slot_idx]
        assert slot is not None and not slot.prefilling, \
            f"ensure_lookahead on idle/prefilling slot {slot_idx}"
        page = self.pool.page_size
        headroom = max(0, len(self.active_indices()) - 1)
        while (slot.cache_len + extra) // page >= len(slot.pages):
            got = self._alloc(1, headroom=headroom)
            if got is None:
                self.stats["spec_lookahead_clamped"] += 1
                return max(len(slot.pages) * page - 1 - slot.cache_len, 0)
            slot.pages.extend(got)
        return extra

    def reserve_horizon(self, want: int) -> int:
        """Worst-case page reservation for a fused decode horizon: extend
        every active slot's pages to cover up to ``want`` decode writes
        past its current cache_len, so the K-step device loop NEVER
        needs a mid-horizon host allocation. Opportunistic like
        ``ensure_lookahead`` — allocation failure (after cache-eviction
        pressure) SHORTENS the horizon instead of preempting; the
        mandatory single next write stays ``grow_for_decode``'s job with
        its refuse-or-preempt discipline.

        Returns the number of writes covered for EVERY active slot — the
        horizon the engine may run unattended. A slot whose own
        remaining budget ``r < want`` only needs ``r`` pages' worth (its
        lane goes dead in-device after r tokens), so a nearly-finished
        request never clamps the batch's horizon below what its budget
        already guarantees. Pages granted for a horizon that later
        shortens simply arrive early — the next horizon's writes land in
        them (no un-grow, same as speculation's lookahead)."""
        if want < 1:
            raise ValueError(f"horizon must be >= 1, got {want}")
        page = self.pool.page_size
        covered = want
        for slot_idx in self.active_indices():
            slot = self.slots[slot_idx]
            r = max(1, slot.request.max_new_tokens - len(slot.generated))
            need = min(want, r)
            while (slot.cache_len + need - 1) // page >= len(slot.pages):
                got = self._alloc(1)
                if got is None:
                    break
                slot.pages.extend(got)
            can = len(slot.pages) * page - slot.cache_len
            if can >= r:
                continue            # budget dies before the pages run out
            covered = min(covered, can)
        return max(0, min(covered, want))

    def max_remaining_budget(self) -> int:
        """The largest remaining token budget over active slots — the
        horizon length past which EVERY device lane is provably dead
        (budgets only shrink; eos can only finish a lane sooner). The
        engine clamps its fused horizon to this so it never dispatches
        steps no slot can use (the all-dead trailing dispatch would
        otherwise burn a full horizon of device time at the end of
        every batch)."""
        rem = 0
        for slot_idx in self.active_indices():
            slot = self.slots[slot_idx]
            rem = max(rem,
                      slot.request.max_new_tokens - len(slot.generated))
        return rem

    # ---- decode bookkeeping ------------------------------------------------
    def record_token(self, slot_idx: int, token: int, *,
                     from_decode: bool) -> Optional[RequestResult]:
        """Append one sampled token. ``from_decode=True`` means a decode
        step just wrote the PREVIOUS token's k/v into the cache (cache_len
        advances); the first token (sampled off prefill logits) doesn't.
        During a post-preemption REPLAY the sample is discarded instead of
        appended — the decode step ran only to rewrite a recorded token's
        k/v, and its output equals that recording bitwise. Returns the
        RequestResult if the sequence just finished (slot freed and page
        references dropped), else None."""
        slot = self.slots[slot_idx]
        assert slot is not None, f"record_token on idle slot {slot_idx}"
        if from_decode:
            slot.cache_len += 1
        if slot.replaying:
            slot.replay_pos += 1
            return None
        slot.generated.append(int(token))
        slot.replay_pos = len(slot.generated) - 1
        if not slot.first_token_at:
            slot.first_token_at = self._clock()
        req = slot.request
        finished = None
        if req.eos_id is not None and token == req.eos_id:
            finished = "eos"
        elif len(slot.generated) >= req.max_new_tokens:
            finished = "length"
        if finished is None:
            return None
        self.pool.free(slot.pages)
        self.slots[slot_idx] = None
        self.stats["finished"] += 1
        self._adapter_release(req)
        return RequestResult(
            request_id=req.request_id, prompt_ids=list(req.prompt_ids),
            generated_ids=list(slot.generated), finish_reason=finished,
            submitted_at=self._submit_times.pop(req.request_id),
            admitted_at=slot.admitted_at, finished_at=self._clock(),
            first_token_at=slot.first_token_at)

    # ---- deadlines ---------------------------------------------------------
    def _deadline_result(self, req: Request, generated: list,
                         admitted_at: float, first_token_at: float,
                         now: float, where: str = "queued") -> RequestResult:
        self.stats["deadline_expired"] += 1
        self.stats[f"deadline_missed_{where}"] += 1
        return RequestResult(
            request_id=req.request_id, prompt_ids=list(req.prompt_ids),
            generated_ids=list(generated), finish_reason="deadline",
            submitted_at=self._submit_times.pop(req.request_id),
            admitted_at=admitted_at, finished_at=now,
            first_token_at=first_token_at)

    def expire_deadlines(self, now: Optional[float] = None) \
            -> list[RequestResult]:
        """Evict everything past its deadline — queued entries leave the
        queue, RUNNING sequences (prefilling or decoding) are evicted
        through the same clean path as EOS: pages freed, tokens produced
        so far returned, finish_reason "deadline". Called by the engine at
        every iteration boundary — expiry is always an orderly eviction,
        never a mid-iteration abort (the invariant all scheduling shares:
        refuse or cleanly evict/preempt, never corrupt)."""
        now = self._clock() if now is None else now

        def expired(req: Request) -> bool:
            return (req.deadline_s is not None
                    and now - self._submit_times[req.request_id]
                    > req.deadline_s)

        results = []
        for entry in [e for e in self.queue if expired(e.request)]:
            self.queue.remove(entry)
            self._adapter_release(entry.request)
            if self._tier is not None:
                # an expired entry's spilled pages will never restore
                self._tier.drop(("seq", entry.request.request_id))
            results.append(self._deadline_result(
                entry.request, entry.generated, now, entry.first_token_at,
                now, where="queued"))
        for i, slot in enumerate(self.slots):
            if slot is not None and expired(slot.request):
                self.pool.free(slot.pages)
                self.slots[i] = None
                self._adapter_release(slot.request)
                results.append(self._deadline_result(
                    slot.request, slot.generated, slot.admitted_at,
                    slot.first_token_at, now, where="running"))
        return results

    def deadline_due(self, now: Optional[float] = None) -> bool:
        """Whether ANY queued or running request is past its deadline —
        the cheap probe the pipelined horizon path runs between
        dispatches: False means ``expire_deadlines`` would be a no-op,
        so the pipeline may keep flowing without draining; True forces
        the drain-and-expire boundary (deadline eviction stays an
        orderly horizon-boundary event, never a mid-horizon abort)."""
        now = self._clock() if now is None else now
        reqs = itertools.chain(
            (e.request for e in self.queue),
            (s.request for s in self.slots if s is not None))
        return any(
            req.deadline_s is not None
            and now - self._submit_times[req.request_id] > req.deadline_s
            for req in reqs)

    # ---- page handoff (disaggregated serving seam) -------------------------
    def release_slot(self, slot_idx: int) -> tuple[_Slot, float]:
        """Remove a prefill-complete slot WITHOUT freeing its pages:
        ownership of the page references moves with the returned slot
        record (serve/disagg.py wraps it in a Handoff — same-host transfer
        is exactly this refcount move, zero page copies). Returns
        (slot, submitted_at)."""
        slot = self.slots[slot_idx]
        assert slot is not None and not slot.prefilling, \
            f"release_slot on idle/prefilling slot {slot_idx}"
        self.slots[slot_idx] = None
        self._adapter_release(slot.request)
        return slot, self._submit_times.pop(slot.request.request_id)

    def take_queued(self, request_id: int) \
            -> Optional[tuple[_QueueEntry, float]]:
        """Remove and return (entry, submitted_at) for a queued request
        — the restore path's counterpart to ``release_slot``: the entry
        leaves the queue WITHOUT a result because it is about to be
        seated directly via ``adopt`` (which re-retains the adapter and
        re-records the submit time). None when not queued."""
        for i, entry in enumerate(self.queue):
            if entry.request.request_id == request_id:
                self.queue.pop(i)
                self._adapter_release(entry.request)
                return entry, self._submit_times.pop(request_id)
        return None

    def adopt(self, *, request: Request, pages: list, cache_len: int,
              generated: list, submitted_at: float, admitted_at: float,
              first_token_at: float = 0.0, resumed: bool = False,
              replay_pos: Optional[int] = None) -> Optional[int]:
        """Seat a handed-off sequence (pages already committed elsewhere —
        the prefill engine, or the previous engine generation) into a free
        slot, taking over its page references. Returns the slot index, or
        None when no slot is free. A RESUMED sequence's cache holds only
        its re-prefilled prompt, so it replays its recorded tokens through
        the decode program from position 0 (see the module docstring); a
        non-resumed one arrives with its full k/v — including every
        generated token's — so the next decode consumes its NEWEST token
        (replay_pos at the end: a mid-stream generation-swap seat that
        replayed from 0 would scatter old tokens' k/v at fresh
        positions). An explicit ``replay_pos`` overrides both defaults —
        a tier restore (serve/tiering.py) seats the sequence at the
        EXACT position its preemption recorded (the victim may itself
        have been mid-replay, so neither 0 nor the end is right)."""
        slot_idx = next((i for i, s in enumerate(self.slots) if s is None),
                        None)
        if slot_idx is None:
            return None
        self._submit_times[request.request_id] = submitted_at
        self.slots[slot_idx] = _Slot(
            request=request, pages=list(pages), generated=list(generated),
            cache_len=cache_len, admitted_at=admitted_at,
            seq=next(self._seq), target_len=cache_len, prefilling=False,
            shared_len=0, resumed=resumed,
            replay_pos=(replay_pos if replay_pos is not None
                        else (0 if resumed else max(0, len(generated) - 1))),
            first_token_at=first_token_at)
        self._adapter_retain(request)
        self.stats["admitted"] += 1
        return slot_idx

    # ---- engine-facing state views ----------------------------------------
    def active_indices(self) -> list[int]:
        """Slots in the decode batch (prefill complete)."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.prefilling]

    def prefilling_indices(self) -> list[int]:
        """Slots still streaming prefill chunks, admission order."""
        return sorted((i for i, s in enumerate(self.slots)
                       if s is not None and s.prefilling),
                      key=lambda i: self.slots[i].seq)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def table_row(self, slot_idx: int) -> np.ndarray:
        """The slot's [max_pages] block table (0 = trash beyond the owned
        pages — the causal mask keeps those positions out of any attend,
        and ``TRASH_PAGE`` never appears among the owned pages)."""
        row = np.zeros(self.max_pages, np.int32)
        slot = self.slots[slot_idx]
        if slot is not None:
            assert TRASH_PAGE not in slot.pages
            row[:len(slot.pages)] = slot.pages
        return row

    def decode_arrays(self) -> dict:
        """Flat numpy views of the decoding set, shaped for the ONE
        compiled decode step: idle and still-prefilling slots carry token
        0 / length 0 / zero table rows, i.e. their lane computes into the
        trash page and is discarded."""
        s = self.n_slots
        out = {
            "tokens": np.zeros(s, np.int32),
            "lengths": np.zeros(s, np.int32),
            "tables": np.zeros((s, self.max_pages), np.int32),
            "seeds": np.zeros(s, np.int32),
            "temps": np.zeros(s, np.float32),
            "top_ks": np.zeros(s, np.int32),
            "top_ps": np.ones(s, np.float32),
            "actives": np.zeros(s, bool),
            # per-slot adapter ids: idle lanes decode under the zero
            # adapter (slot 0's stack rows are zeros — an exact +0)
            "adapters": np.zeros(s, np.int32),
            # the fused-horizon lanes (serve/engine.py horizon_for): the
            # in-device live mask finishes a lane exactly where
            # record_token would — eos_ids is -1 for "no eos" (vocab id
            # 0 is a legal eos), budgets is the remaining max_new_tokens
            # allowance. The K=1 program ignores both.
            "eos_ids": np.full(s, -1, np.int32),
            "budgets": np.zeros(s, np.int32),
        }
        for i, slot in enumerate(self.slots):
            if slot is None or slot.prefilling:
                continue
            req = slot.request
            # normally the newest sample; during replay, the next recorded
            # token whose k/v needs rewriting
            out["tokens"][i] = slot.generated[slot.replay_pos]
            out["lengths"][i] = slot.cache_len
            out["tables"][i] = self.table_row(i)
            out["seeds"][i] = req.seed
            out["temps"][i] = req.temperature
            out["top_ks"][i] = req.top_k
            out["top_ps"][i] = req.top_p
            out["actives"][i] = True
            out["adapters"][i] = req.adapter_id
            out["eos_ids"][i] = -1 if req.eos_id is None else req.eos_id
            out["budgets"][i] = max(
                0, req.max_new_tokens - len(slot.generated))
        return out
