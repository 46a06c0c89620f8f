"""Speculative decoding, the drafting half (Leviathan et al.,
arXiv:2211.17192; Chen et al., arXiv:2302.01318).

Counterpart of ``distributed_training_guide_tpu/serve/spec.py``. A
drafter proposes up to k candidate tokens per slot; ONE ``[S, k+1]``
verification forward through the paged cache (``serve/engine.py``
``ModelPrograms.verify_for``, the chunked-prefill form, K4 at T = k + 1
on the card) scores all of them, and the accepted prefix lands in one
weight read.

Acceptance is exact by construction: the verify forward draws the target
token at every drafted position with the same (seed, position) stream the
plain decode step uses, and a draft is accepted exactly when it equals
that draw. The emitted tokens are always the target sampler's own, so
spec-on emits the spec-off stream whenever the verify forward's logits
equal the decode step's; drafts only decide how many tokens land per
weight pass. On the card the verify forward is a different shape of
product than the decode step (K4's plan folds T x groups rows, cuBLAS
picks per M), so its logits may differ in the last bits:
``chip_smoke.py`` phase 23 measures that and what identity it leaves.

Two drafters behind one interface:

- :class:`NgramDrafter`: prompt lookup. The context's longest suffix
  n-gram is matched against the prompt + generated history, and the
  tokens that followed its most recent earlier occurrence become the
  candidates. Host-only.
- :class:`DraftModelDrafter`: a small model of any family with its OWN
  full-residency page pool, a batched greedy draft loop over the
  engine's slots, and sync-by-context rollback (longest common prefix,
  then catch-up chunks), so eviction, preemption and rejection on the
  target side need no callbacks. Its forwards are the family's
  ``paged_decode_step`` on the engine's device: K4 on the card.
"""
from __future__ import annotations


import numpy as np
import torch

from .._device import resolve_device
from ..models.registry import ModelBundle, family_module
from ..ops.paged_decode import HEAD_DIMS, MAX_PAGE, paged_decode_eligible
from .kv_pages import PagePool, init_pages, make_attend, pages_for_tokens


def new_spec_counters() -> dict:
    """The host-side speculation counters one engine keeps
    (``serve/engine.py:spec_metrics`` derives the stats() rows)."""
    return {"spec_steps": 0, "tokens_drafted": 0, "tokens_accepted": 0,
            "tokens_rejected": 0}


class Drafter:
    """Per-slot candidate streams for speculative decoding.

    ``k`` bounds the candidates per proposal; ``propose`` returns up to
    ``budget`` (<= k) candidate ids for one slot given its full context
    (prompt + tokens generated so far). ``propose_many`` is the engine's
    entry point (one call per iteration, every decoding slot at once).

    A slot may be re-seated with a different sequence at any iteration
    boundary (eviction, preemption and deadline expiry are invisible
    here), so any per-slot state must reconcile from the context alone.
    """

    k: int = 0

    def propose(self, slot_idx: int, context: list, budget: int) -> list:
        raise NotImplementedError

    def propose_many(self, contexts: dict, budgets: dict) -> dict:
        return {i: self.propose(i, contexts[i], budgets[i])
                for i in contexts}

    def stats(self) -> dict:
        """Host-side drafter counters (merged into engine stats())."""
        return {}


class NgramDrafter(Drafter):
    """Prompt-lookup drafting: match the context's suffix n-gram, longest
    n first, against the history, and propose the tokens that followed
    its most recent earlier occurrence with a full continuation (else the
    longest truncated one). The scan is bounded to the last
    ``max_lookback`` tokens, so its host cost per iteration does not grow
    with the context."""

    def __init__(self, k: int = 4, max_n: int = 3, min_n: int = 1,
                 max_lookback: int = 512):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"min_n={min_n}, max_n={max_n}")
        if max_lookback < max_n + 1:
            raise ValueError(f"max_lookback ({max_lookback}) must exceed "
                             f"max_n ({max_n})")
        self.k = k
        self.max_n = max_n
        self.min_n = min_n
        self.max_lookback = max_lookback

    def propose(self, slot_idx: int, context: list, budget: int) -> list:
        budget = min(budget, self.k)
        if budget < 1:
            return []
        context = list(context[-self.max_lookback:])
        for n in range(self.max_n, self.min_n - 1, -1):
            if len(context) <= n:
                continue
            suffix = context[-n:]
            best: list = []
            for j in range(len(context) - n - 1, -1, -1):
                if context[j:j + n] == suffix:
                    cand = context[j + n:j + n + budget]
                    if len(cand) >= budget:
                        return [int(x) for x in cand]
                    if len(cand) > len(best):
                        best = cand
            if best:
                return [int(x) for x in best]
        return []


class DraftModelDrafter(Drafter):
    """Draft-model drafting: a family model runs a batched GREEDY draft
    loop over the engine's slots, with its own page pool sized for full
    residency, so the draft cache never contends with the target's pool.
    Greedy, because a candidate is a guess at the target's draw and the
    draft model's argmax is its best single guess.

    ``device`` is the engine's (default ``cuda``); ``params`` are moved
    there. On the card the draft model's geometry must suit K4, checked
    here rather than inside the first live draft forward."""

    def __init__(self, bundle: ModelBundle, params, *, n_slots: int,
                 max_len: int, k: int = 4, page_size: int = 16,
                 chunk: int = 16, attend_impl: str = "auto", device=None):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if attend_impl not in ("auto", "flash", "xla"):
            raise ValueError(f"attend_impl must be 'auto', 'flash' or "
                             f"'xla', got {attend_impl!r}")
        self.device = resolve_device(device)
        if attend_impl == "xla" and self.device.type != "cpu":
            raise ValueError("attend_impl='xla' (the gather path) is "
                             "accepted only with device='cpu'")
        self.bundle = bundle
        self.config = bundle.config
        self.mod = family_module(bundle.family)
        self.k = k
        self.n_slots = n_slots
        max_pos = getattr(self.config, "max_position_embeddings", None)
        self.max_len = min(max_len, max_pos) if max_pos else max_len
        self.page_size = page_size
        if (self.device.type == "cuda" and not paged_decode_eligible(
                self.config.head_size, page_size)):
            raise ValueError(
                f"draft model head_dim {self.config.head_size} / page_size "
                f"{page_size}: the paged kernel takes head_dim in "
                f"{HEAD_DIMS} and pages of 1 to {MAX_PAGE} positions")
        self.max_pages = pages_for_tokens(self.max_len, page_size)
        n_pages = 1 + n_slots * self.max_pages
        self.pool = PagePool(n_pages, page_size)
        self.pages = init_pages(self.config, n_pages, page_size,
                                device=self.device)

        def place(tree):
            if isinstance(tree, dict):
                return {key: place(v) for key, v in tree.items()}
            return tree.to(self.device)

        self.params = place(params)
        self.chunk = chunk
        self.attend_impl = attend_impl
        self._slot_pages: list = [[] for _ in range(n_slots)]
        self._consumed: list = [[] for _ in range(n_slots)]
        self._counters = {"draft_model_steps": 0, "catchup_tokens": 0,
                          "catchup_chunks": 0, "resyncs": 0}

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # ---- the draft forwards (in place on the drafter's pool) ---------------
    def _step(self, tokens, lengths, tables) -> torch.Tensor:
        """One batched greedy draft step over [n_slots] lanes (idle lanes
        carry zero tables and write into the trash page)."""
        attend = make_attend(tables, lengths, impl=self.attend_impl)
        logits, _ = self.mod.paged_decode_step(
            self.config, self.params, tokens[:, None], lengths, self.pages,
            attend)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _catchup(self, ids, start, table, n_valid) -> None:
        """Feed one [1, chunk] catch-up chunk of a slot's context into the
        draft cache; the logits are not needed."""
        attend = make_attend(table, start, impl=self.attend_impl,
                             n_valid=n_valid)
        self.mod.paged_decode_step(self.config, self.params, ids, start,
                                   self.pages, attend)

    # ---- per-slot cache bookkeeping ----------------------------------------
    def _ensure_pages(self, slot_idx: int, n_tokens: int) -> None:
        """The slot owns pages covering positions 0..n_tokens-1 (the pool
        is sized for full residency, so this cannot fail)."""
        need = pages_for_tokens(n_tokens, self.page_size)
        pages = self._slot_pages[slot_idx]
        while len(pages) < need:
            got = self.pool.alloc(1)
            assert got is not None, "full-residency draft pool exhausted"
            pages.extend(got)

    def _table_row(self, slot_idx: int) -> np.ndarray:
        row = np.zeros(self.max_pages, np.int32)
        pages = self._slot_pages[slot_idx]
        row[:len(pages)] = pages
        return row

    def _sync(self, slot_idx: int, target: list) -> None:
        """Reconcile the slot's draft cache with ``target`` (the true
        context minus its newest token): roll back to the longest common
        prefix (dead k/v past it is overwritten in place), then stream
        catch-up chunks for the rest."""
        consumed = self._consumed[slot_idx]
        common = 0
        for a, b in zip(consumed, target):
            if a != b:
                break
            common += 1
        if common < len(consumed):
            del consumed[common:]
            self._counters["resyncs"] += 1
        while len(consumed) < len(target):
            start = len(consumed)
            m = min(self.chunk, len(target) - start)
            self._ensure_pages(slot_idx, start + m)
            ids = np.zeros((1, self.chunk), np.int32)
            ids[0, :m] = target[start:start + m]
            self._catchup(self._to_device(ids),
                          self._to_device(np.array([start], np.int32)),
                          self._to_device(self._table_row(slot_idx)[None]),
                          self._to_device(np.array([m], np.int32)))
            consumed.extend(int(x) for x in target[start:start + m])
            self._counters["catchup_tokens"] += m
            self._counters["catchup_chunks"] += 1

    # ---- the Drafter surface -----------------------------------------------
    def propose(self, slot_idx: int, context: list, budget: int) -> list:
        out = self.propose_many({slot_idx: context}, {slot_idx: budget})
        return out.get(slot_idx, [])

    @torch.no_grad()
    def propose_many(self, contexts: dict, budgets: dict) -> dict:
        drafts: dict = {i: [] for i in contexts}
        quota: dict = {}
        for i, ctx in contexts.items():
            # the loop consumes positions len(ctx)-1 .. len(ctx)-2+b: clip
            # b to the draft model's own position table
            b = min(budgets[i], self.k, self.max_len - len(ctx))
            if b < 1 or not ctx:
                continue
            self._sync(i, list(ctx[:-1]))
            self._ensure_pages(i, len(ctx) + b - 1)
            quota[i] = b
        if not quota:
            return drafts
        s = self.n_slots
        tokens = np.zeros(s, np.int32)
        lengths = np.zeros(s, np.int32)
        tables = np.zeros((s, self.max_pages), np.int32)
        for i in quota:
            tokens[i] = contexts[i][-1]
            lengths[i] = len(contexts[i]) - 1
            tables[i] = self._table_row(i)
        tables_dev = self._to_device(tables)
        for _ in range(max(quota.values())):
            nxt = self._step(self._to_device(tokens),
                             self._to_device(lengths), tables_dev)
            self._counters["draft_model_steps"] += 1
            nxt = nxt.cpu().numpy()
            for i, b in quota.items():
                if len(drafts[i]) >= b:
                    continue        # lane frozen: re-feeds the same token
                                    # into the same position (harmless)
                self._consumed[i].append(int(tokens[i]))
                drafts[i].append(int(nxt[i]))
                tokens[i] = nxt[i]
                lengths[i] += 1
        return drafts

    def stats(self) -> dict:
        return dict(self._counters)


__all__ = ["DraftModelDrafter", "Drafter", "NgramDrafter",
           "new_spec_counters"]
