"""Tiered KV: a host-RAM spill tier under the page pool, plus the
fleet-wide prefix directory that lets replicas serve each other's cache.

Counterpart of ``distributed_training_guide_tpu/serve/tiering.py``, the
same code over this package's ``serve/transport.py``: a spilled payload is
a dict of host tensors (pinned when gathered from the card) or numpy
arrays, counted in bytes as the JAX package counts them.

- :class:`HostTier`: a byte-budgeted LRU store of gathered page payloads
  (every pool leaf: an int8 pool spills its int8 payload AND its fp32
  scale rows). The raw bytes round-trip, so a restore is bitwise the
  spilled pages. The tier never touches a device or a pool.
- Spill hooks, installed through ``attach_tier`` on the scheduler and the
  prefix cache: ``PrefixCache.evict_one`` gathers a page before freeing
  it, keyed by the chain's token content per adapter namespace;
  ``Scheduler.preempt`` gathers a decoding victim's live pages keyed by
  request id, with ``cache_len`` / ``replay_pos`` in the record.
- Restore helpers (``restore_queued``, ``restore_prefixes``) the engine
  runs at the top of each step, ahead of admission. Restores only take
  FREE pages; one that cannot allocate leaves the entry queued, and the
  recompute admission stays the fallback.
- :func:`pull_prefix`: the fleet directory's data path, a sibling
  replica's cached chain moved over the transport's delivery protocol.
  Any failure ends as an ordinary cache miss.

Accounting: a spilled page's slot returns to the free list at spill
time, so the pool identity ``free + held + cached == capacity`` is
unchanged; the tier's own books (``bytes_used == sum of record bytes <=
budget``) audit separately (``kv_pages.pool_audit(tier=)``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

from .transport import (encode_frame, loopback_channel,
                        payload_nbytes)


def prefix_digest(tokens, adapter_id: int = 0) -> bytes:
    """Content hash of a page-aligned token run — the SAME bytes-in,
    bytes-out recipe as the router's ``prefix_affinity_key`` (which
    delegates here), so an engine-exported cache key and a router-side
    request key agree iff the token content agrees. Namespaced by
    adapter id exactly like the cache tree: adapter 0 adds no salt, so
    base-model keys are stable across the multi-LoRA upgrade."""
    arr = np.asarray(list(tokens), np.int64)
    h = hashlib.blake2b(digest_size=8)
    if adapter_id:
        h.update(np.int64(adapter_id).tobytes())
    h.update(arr.tobytes())
    return h.digest()


def cache_prefix_keys(cache) -> list[str]:
    """Hex digests of EVERY committed chain depth in a prefix cache —
    one key per node, hashing the cumulative token content from the
    namespace root down (so a replica holding a 4-page chain advertises
    all four aligned depths, and a request needing only 2 of them still
    matches). Read lock-free off the live tree for ``stats()``; a
    concurrent mutation makes the walk raise, in which case this
    snapshot just reports empty — the directory keeps the previous
    fenced entry."""
    try:
        keys = []
        for ns, root in list(cache._roots.items()):
            stack = [(root, ())]
            while stack:
                node, toks = stack.pop()
                for child_toks, child in list(node.children.items()):
                    full = toks + tuple(child_toks)
                    keys.append(prefix_digest(full, ns).hex())
                    stack.append((child, full))
        return keys
    except Exception:
        return []


@dataclasses.dataclass
class TierRecord:
    """One spilled payload: host leaf arrays + the scheduling metadata a
    restore needs to seat it exactly where it left off."""
    payload: dict               # {leaf name: host tensor [L, n, ...]}
    meta: dict
    nbytes: int
    pages: int                  # HBM pages this payload re-occupies


class HostTier:
    """Byte-budgeted host-RAM store of spilled page payloads, LRU on
    reference. Pure host bookkeeping: no pool, no device, no locks (it
    is only ever touched from the engine thread). ``put`` rejects a
    record larger than the whole budget and evicts LRU records to make
    room otherwise — eviction here loses only the RECOMPUTE SAVINGS,
    never correctness (the fallback is the pre-tier recompute path)."""

    def __init__(self, budget_bytes: int):
        if budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got "
                             f"{budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self._records: OrderedDict[tuple, TierRecord] = OrderedDict()
        self.bytes_used = 0
        self.counters = {"spills": 0, "spill_rejects": 0, "evictions": 0,
                         "restore_hits": 0, "restore_misses": 0,
                         "dropped": 0, "bytes_spilled": 0,
                         "bytes_restored": 0}

    def __len__(self) -> int:
        return len(self._records)

    def __contains__(self, key) -> bool:
        return key in self._records

    @property
    def spilled_pages(self) -> int:
        return sum(r.pages for r in self._records.values())

    def keys(self):
        return list(self._records.keys())

    def put(self, key, payload: dict, *, pages: int = 0,
            meta: Optional[dict] = None) -> bool:
        """Admit a spilled payload under ``key`` (replacing any previous
        record); False when it can never fit the budget."""
        nbytes = payload_nbytes(payload)
        if nbytes > self.budget_bytes:
            self.counters["spill_rejects"] += 1
            return False
        if key in self._records:
            old = self._records.pop(key)
            self.bytes_used -= old.nbytes
        while self.bytes_used + nbytes > self.budget_bytes:
            _, victim = self._records.popitem(last=False)
            self.bytes_used -= victim.nbytes
            self.counters["evictions"] += 1
        self._records[key] = TierRecord(payload=payload,
                                        meta=dict(meta or {}),
                                        nbytes=nbytes, pages=int(pages))
        self.bytes_used += nbytes
        self.counters["spills"] += 1
        self.counters["bytes_spilled"] += nbytes
        return True

    def get(self, key) -> Optional[TierRecord]:
        """Peek (and LRU-touch) without removing — restore paths peek
        first so an allocation failure leaves the record in place."""
        rec = self._records.get(key)
        if rec is not None:
            self._records.move_to_end(key)
        return rec

    def take(self, key) -> Optional[TierRecord]:
        """Remove and return a record — the restore succeeded."""
        rec = self._records.pop(key, None)
        if rec is not None:
            self.bytes_used -= rec.nbytes
            self.counters["restore_hits"] += 1
            self.counters["bytes_restored"] += rec.nbytes
        return rec

    def drop(self, key) -> bool:
        """Remove a record that will never be restored (deadline expiry,
        the sequence re-admitted through recompute instead)."""
        rec = self._records.pop(key, None)
        if rec is None:
            return False
        self.bytes_used -= rec.nbytes
        self.counters["dropped"] += 1
        return True

    def note_miss(self) -> None:
        self.counters["restore_misses"] += 1

    def carry_from(self, other: "HostTier") -> tuple[int, int]:
        """Adopt every record from ``other`` — the generation-swap
        carry (serve/elastic.py). Records move oldest-first so this
        tier's LRU order matches the old one's; each is re-admitted
        under THIS tier's budget, so shrinking the budget across a swap
        sheds the coldest records (losing only recompute savings, never
        correctness). ``other`` is left empty. Returns (carried,
        dropped)."""
        carried = dropped = 0
        for key, rec in list(other._records.items()):
            if self.put(key, rec.payload, pages=rec.pages, meta=rec.meta):
                carried += 1
            else:
                dropped += 1
        other._records.clear()
        other.bytes_used = 0
        return carried, dropped

    def audit(self) -> None:
        """Raise unless the tier's books balance: the byte gauge equals
        the sum of resident records and never exceeds the budget."""
        total = sum(r.nbytes for r in self._records.values())
        if total != self.bytes_used:
            raise AssertionError(f"host tier bytes_used {self.bytes_used} "
                                 f"!= sum of records {total}")
        if self.bytes_used > self.budget_bytes:
            raise AssertionError(f"host tier over budget: {self.bytes_used}"
                                 f" > {self.budget_bytes}")

    def gauges(self) -> dict:
        """The stats()/healthz surface (lock-free host reads)."""
        return {"host_tier_bytes": self.bytes_used,
                "host_tier_budget_bytes": self.budget_bytes,
                "host_tier_records": len(self._records),
                "spilled_pages": self.spilled_pages,
                "restore_hits": self.counters["restore_hits"],
                "restore_misses": self.counters["restore_misses"],
                "tier_spills": self.counters["spills"],
                "tier_spill_rejects": self.counters["spill_rejects"],
                "tier_evictions": self.counters["evictions"],
                "tier_dropped": self.counters["dropped"],
                "tier_bytes_spilled": self.counters["bytes_spilled"],
                "tier_bytes_restored": self.counters["bytes_restored"]}


# ---- restore paths (engine-step helpers) -----------------------------------

def restore_queued(sched, tier: HostTier,
                   scatter: Callable[[list, dict], None],
                   alloc: Optional[Callable[[int], Optional[list]]] = None) \
        -> int:
    """Seat spilled preempted sequences back into HBM, ahead of
    admission: walk the queue IN ORDER and, while the head run carries
    tier records, allocate fresh pages, scatter the payload back
    (bitwise), and ``adopt`` at the exact (cache_len, replay_pos) the
    preemption recorded — no re-prefill, no replay of already-cached
    tokens. Stops at the first entry without a record (strict queue
    order: a restore never jumps an earlier admission), at the first
    allocation failure (the record stays; next iteration retries,
    recompute admission remains the fallback), or when no slot is free.
    Restores use only FREE pages — never cache-eviction pressure, which
    could evict exactly the prefixes the queued work wants."""
    restored = 0
    for rid in [e.request.request_id for e in list(sched.queue)]:
        key = ("seq", rid)
        rec = tier.get(key)
        if rec is None:
            break
        if all(s is not None for s in sched.slots):
            break
        if alloc is not None:
            page_ids = alloc(rec.pages)
        else:
            page_ids = (sched.pool.alloc(rec.pages)
                        if sched.pool.n_free >= rec.pages else None)
        if page_ids is None:
            break
        taken = sched.take_queued(rid)
        if taken is None:           # raced away (should not happen inline)
            sched.pool.free(page_ids)
            tier.drop(key)
            continue
        entry, submitted_at = taken
        scatter(page_ids, rec.payload)
        m = rec.meta
        sched.adopt(request=entry.request, pages=page_ids,
                    cache_len=m["cache_len"], generated=list(m["generated"]),
                    submitted_at=submitted_at, admitted_at=m["admitted_at"],
                    first_token_at=entry.first_token_at, resumed=True,
                    replay_pos=m["replay_pos"])
        tier.take(key)
        restored += 1
    return restored


def restore_prefixes(cache, tier: HostTier, tokens, *, ns: int = 0,
                     alloc: Callable[[int], Optional[list]],
                     scatter: Callable[[list, dict], None],
                     free: Callable[[list], None]) -> int:
    """Re-seat spilled prefix pages for ``tokens`` (the queue head's
    prompt) into the HBM cache so the admission that follows shares
    them instead of recomputing. Walks depth-by-depth from the cache's
    current HBM chain: each tier hit allocates one page, scatters the
    spilled bytes back, and inserts the chain node; the walk stops at
    the first gap (tier miss), allocation failure, or insert conflict —
    every outcome leaves a consistent chain prefix."""
    page = cache.page_size
    k_full = (len(tokens) - 1) // page
    depth = cache.chain_depth(tokens, ns=ns)
    restored = 0
    for j in range(depth + 1, k_full + 1):
        covered = [int(t) for t in tokens[:j * page]]
        key = ("prefix", int(ns), tuple(covered))
        if tier.get(key) is None:
            break
        got = alloc(1)
        if got is None:
            break
        rec = tier.take(key)
        scatter(got, rec.payload)
        if not cache.insert_page(covered, got[0], ns=ns):
            free(got)
            break
        restored += 1
    return restored


# ---- fleet directory data path ---------------------------------------------

def pull_prefix(src, dst, prompt_ids, *, adapter_id: int = 0,
                xfer_id: int = 0, ack_timeout_s: float = 2.0) -> dict:
    """Move the missing prefix-chain suffix for ``prompt_ids`` from a
    sibling replica's HBM cache into ``dst``'s, over the transport's delivery
    protocol (real socketpair, FRAME→ACK→COMMIT→FIN, ``handoff_fault``
    injection live on the wire). Engines expose ``scheduler`` (cache +
    pool), ``gather_pages`` and ``scatter_pages``; the source is only
    READ (its refcounts never move). Returns {ok, reason, pages,
    bytes}: any wire failure or allocation loss ends with ``ok=False``
    and NOTHING half-seated — at worst a shorter chain than hoped, each
    page either fully scattered + inserted or freed."""
    cache = dst.scheduler.cache
    if cache is None or src.scheduler.cache is None:
        return {"ok": False, "reason": "no_cache", "pages": 0, "bytes": 0}
    page = cache.page_size
    tokens = [int(t) for t in prompt_ids]
    k_full = (len(tokens) - 1) // page
    if k_full < 1:
        return {"ok": False, "reason": "no_full_page", "pages": 0,
                "bytes": 0}
    d0 = cache.chain_depth(tokens, ns=int(adapter_id))
    if d0 >= k_full:
        return {"ok": True, "reason": "already_resident", "pages": 0,
                "bytes": 0}
    src_pages = src.scheduler.cache.chain_pages(tokens, ns=int(adapter_id))
    if len(src_pages) <= d0:
        return {"ok": False, "reason": "src_cold", "pages": 0, "bytes": 0}
    depths = list(range(d0 + 1, len(src_pages) + 1))
    payload = src.gather_pages(src_pages[d0:])
    header = {"kind": "prefix_pull", "ns": int(adapter_id),
              "page_size": page, "depths": depths,
              "tokens": tokens[:len(src_pages) * page]}
    frame = encode_frame(int(xfer_id), header, payload)
    sender, receiver = loopback_channel(ack_timeout_s=ack_timeout_s)
    try:
        outcome = sender.send(frame, int(xfer_id))
        if outcome != "delivered":
            return {"ok": False, "reason": outcome, "pages": 0,
                    "bytes": len(frame)}
        got_id, got_header, got_payload = receiver.inbox.get_nowait()
    finally:
        sender.sock.close()
        receiver.sock.close()
    if got_id != int(xfer_id) or got_header.get("kind") != "prefix_pull":
        return {"ok": False, "reason": "desync", "pages": 0,
                "bytes": len(frame)}
    seated = 0
    for i, j in enumerate(got_header["depths"]):
        covered = got_header["tokens"][:j * page]
        got = dst.scheduler.pool.alloc(1)
        if got is None:
            break
        piece = {name: arr[:, i:i + 1] for name, arr in got_payload.items()}
        dst.scatter_pages(got, piece)
        if not cache.insert_page(covered, got[0], ns=int(adapter_id)):
            dst.scheduler.pool.free(got)
            break
        seated += 1
    return {"ok": seated > 0,
            "reason": "delivered" if seated else "dst_full",
            "pages": seated, "bytes": len(frame)}


# ---- spill-side helpers (engine wiring) ------------------------------------

def make_gather(engine) -> Callable[[list], dict]:
    """The gather callback the engine installs on its scheduler + cache:
    reads the CURRENT pool arrays at call time (the pages dict is
    reassigned on every scatter/decode)."""
    return lambda page_ids: engine.gather_pages(page_ids)
