"""Paged KV cache: fixed-size pages, a refcounted free-list allocator,
per-sequence block tables, and the attend over the table.

Counterpart of ``distributed_training_guide_tpu/serve/kv_pages.py``. The
resident cache is a POOL of pages ``[L, n_pages, page_size, kvh, hd]``
(PagedAttention, Kwon et al., arXiv:2309.06180); a sequence owns
``ceil(tokens / page_size)`` pages wired together by an int32 block
table, and pages are refcounted so identical prompt prefixes share them
copy-on-write. Physical page 0 is the TRASH page: never allocated, it
takes every write that must land nowhere (idle decode slots, the padded
tail of a bucketed prefill or of a final chunk), and no live block table
references it, so what it holds never reaches a live slot's attend.

Where the JAX package donates the pools to a jitted program and gets new
ones back, the port updates them IN PLACE (``index_put_``):
``paged_attend``, ``commit_prefill`` and ``copy_pages`` write into the
tensors they are given and return those same tensors. Duplicate scatter
indices occur only at the trash page, where which write wins does not
matter.

``paged_attend`` scatters the new k/v, then attends through the block
table: ``impl="auto"`` / ``"flash"`` calls ``ops/paged_decode.py``'s
``paged_flash_attend`` (the CUDA kernel on the card, its plain version
for CPU tensors); ``"xla"`` is the gather path, ``paged_attend_reference``,
and is refused for CUDA tensors so that no engine on the card runs it.

QUANTIZED pools (``kv_dtype="int8"``): an int8 payload plus one fp32
scale per (position, kv-head) vector, a :class:`Quantized` of
``[L, P, page, kvh, hd]`` int8 and ``[L, P, page, kvh, 1]`` fp32. Every
write site quantizes (a pure function of that token's k/v, so replays
rewrite the same bytes); the kernel dequantizes inside its loop.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._device import resolve_device
from ..ops.paged_decode import paged_attend_reference, paged_flash_attend
from ..train.precision import (Quantized, dequantize_blockwise,
                               quantize_blockwise)

TRASH_PAGE = 0  # physical page id reserved for masked/idle writes

KV_DTYPES = ("fp32", "bf16", "int8")
_KV_FLOAT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    """Pages a sequence of ``n_tokens`` occupies."""
    return -(-n_tokens // page_size)


def kv_dtype_name(config, kv_dtype=None) -> str:
    """The engine's ``kv_dtype=`` knob: None inherits the model's compute
    dtype, otherwise one of ``KV_DTYPES``."""
    if kv_dtype is None:
        return "bf16" if config.dtype == torch.bfloat16 else "fp32"
    name = str(kv_dtype).lower()
    name = {"float32": "fp32", "bfloat16": "bf16"}.get(name, name)
    if name not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                         f"{kv_dtype!r}")
    return name


def quantize_kv(x: torch.Tensor) -> Quantized:
    """Block-wise absmax int8 with the block = the trailing head_dim axis:
    one fp32 scale per (position, kv-head) vector."""
    return quantize_blockwise(x, block_size=x.shape[-1])


def dequantize_kv(qt: Quantized, dtype=torch.float32) -> torch.Tensor:
    return dequantize_blockwise(qt, dtype=dtype)


def _leaves(pool) -> list:
    return list(pool) if isinstance(pool, Quantized) else [pool]


def pool_nbytes(pages: dict) -> int:
    """Resident bytes of a pools dict, scales included."""
    return int(sum(x.numel() * x.element_size()
                   for pool in pages.values() for x in _leaves(pool)))


def kv_page_bytes(config, *, page_size: int, n_pages: int = 1,
                  kv_dtype=None) -> int:
    """Resident bytes of ``n_pages`` pages at ``kv_dtype``: pages x layers
    x 2 (k and v) x page_size x kv_heads x (head_dim x itemsize, + 4 B of
    fp32 scale per vector under int8)."""
    name = kv_dtype_name(config, kv_dtype)
    per_vector = (config.head_size + 4 if name == "int8" else
                  config.head_size * torch.finfo(_KV_FLOAT[name]).bits // 8)
    return (n_pages * config.num_layers * 2 * page_size
            * config.num_kv_heads * per_vector)


def init_pages(config, n_pages: int, page_size: int, kv_dtype=None,
               device=None, kv_heads=None) -> dict:
    """Zeroed page pools {"k", "v"}: [L, n_pages, page_size, kvh, hd], or
    :class:`Quantized` pools under ``kv_dtype="int8"``. ``kv_heads``: a
    rank's share of the kv heads (the tp-sharded pool,
    ``serve/sharding.py``); every one by default."""
    name = kv_dtype_name(config, kv_dtype)
    dev = resolve_device(device)
    shape = (config.num_layers, n_pages, page_size,
             config.num_kv_heads if kv_heads is None else kv_heads,
             config.head_size)
    if name == "int8":
        def pool():
            return Quantized(
                q=torch.zeros(shape, dtype=torch.int8, device=dev),
                scale=torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                  device=dev))
        return {"k": pool(), "v": pool()}
    return {"k": torch.zeros(shape, dtype=_KV_FLOAT[name], device=dev),
            "v": torch.zeros(shape, dtype=_KV_FLOAT[name], device=dev)}


class PagePool:
    """Host-side refcounted free-list allocator over physical page ids
    1..n_pages-1 (page 0 is the trash page). Allocation is all-or-nothing;
    ``share`` adds references to live pages; ``free`` drops one reference
    per page and re-lists it at zero. LIFO free list with a parallel set
    for membership."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page {TRASH_PAGE} is "
                             f"the reserved trash page), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free = list(range(n_pages - 1, TRASH_PAGE, -1))
        self._free_set = set(self._free)
        self._refs = [0] * n_pages

    @property
    def capacity(self) -> int:
        """Total allocatable pages (trash page excluded)."""
        return self.n_pages - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def describe(self, page: int) -> str:
        """One-line holder context for a page id, for error messages."""
        if not 0 <= page < self.n_pages:
            state = (f"out of range (valid ids {TRASH_PAGE + 1}.."
                     f"{self.n_pages - 1})")
        elif page == TRASH_PAGE:
            state = "the reserved trash page"
        else:
            state = (f"refcount {self._refs[page]}, "
                     + ("free-listed" if page in self._free_set else "held"))
        return (f"page {page}: {state}; pool {self.n_free}/{self.capacity} "
                f"free")

    def alloc(self, n: int) -> Optional[list]:
        """``n`` pages at refcount 1 each, or None (never a partial grant)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        if n == 0:
            return []
        pages = self._free[-n:]
        del self._free[-n:]
        self._free_set.difference_update(pages)
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages: list) -> None:
        """Take one additional reference on each (already-live) page."""
        for p in pages:
            if not (TRASH_PAGE < p < self.n_pages) or self._refs[p] < 1:
                raise ValueError(f"sharing unallocated page id {p} "
                                 f"({self.describe(p)})")
        for p in pages:
            self._refs[p] += 1

    def free(self, pages: list) -> None:
        """Release one reference per page; validation runs before any
        mutation, so a bad batch leaves the pool intact."""
        releases: dict = {}
        for p in pages:
            if not (TRASH_PAGE < p < self.n_pages):
                raise ValueError(f"freeing invalid page id {p} "
                                 f"({self.describe(p)})")
            releases[p] = releases.get(p, 0) + 1
            if p in self._free_set or releases[p] > self._refs[p]:
                raise ValueError(
                    f"double free of page {p} ({self.describe(p)}; this "
                    f"batch releases it {releases[p]}x)")
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                self._free_set.add(p)


def pool_audit(pool: PagePool, holder_maps, *, tier=None) -> None:
    """The capacity identity: each page's refcount equals its holder count
    over ``holder_maps`` (iterables of ``{page: n_refs}``), no held page is
    free-listed, and free + distinct held pages == capacity. A spilled
    page freed its slot at spill time, so a host tier leaves this as it
    is; with ``tier`` its own byte ledger is audited too."""
    held: dict = {}
    for m in holder_maps:
        for p, n in m.items():
            held[p] = held.get(p, 0) + n
    for p, n in held.items():
        if pool.refcount(p) != n:
            raise AssertionError(f"page {p}: {n} holders but refcount "
                                 f"{pool.refcount(p)} ({pool.describe(p)})")
        if p in pool._free_set:
            raise AssertionError(f"held page {p} on the free list "
                                 f"({pool.describe(p)})")
    if pool.n_free + len(held) != pool.capacity:
        raise AssertionError(
            f"capacity audit failed: free={pool.n_free} + "
            f"held={len(held)} != capacity={pool.capacity}")
    if tier is not None:
        tier.audit()


def write_index(tables, lengths, t: int, page: int, n_valid=None) -> tuple:
    """(physical page, offset) [S, T] where each slot's T new tokens land:
    positions ``lengths[s] + 0..T-1`` through the block table, the page
    lookup clipped to the table (jax clamps an out-of-range gather; torch
    would raise) and everything past ``lengths + n_valid`` routed to the
    trash page. The same for every layer of one forward."""
    m = tables.shape[1]
    t_idx = (lengths.long()[:, None]
             + torch.arange(t, device=lengths.device)[None, :])
    phys = torch.gather(tables.long(), 1,
                        torch.clamp(t_idx // page, max=m - 1))
    if n_valid is not None:
        live = t_idx < (lengths.long() + n_valid.long())[:, None]
        phys = torch.where(live, phys, TRASH_PAGE)
    return phys, t_idx % page


def paged_attend(q, k_new, v_new, k_pages, v_pages, tables, lengths, *,
                 window=None, scale=None, softcap=None, impl: str = "auto",
                 n_valid=None, index=None):
    """Scatter each slot's new k/v into its pages (in place), then attend
    q over the slot's block-table context.

    q [S, T, Hq, D]; k_new / v_new [S, T, Hkv, D]; k_pages / v_pages ONE
    layer's pool [P, page, Hkv, D] (or :class:`Quantized`); tables [S, M]
    int32 (0-filled tails route to the trash page); lengths [S] int32,
    tokens already cached per slot, so the T new tokens land at
    ``lengths[s] + 0..T-1``; ``n_valid`` [S] (default T) marks how many of
    the T tokens are real — the pad tail's writes go to the trash page.
    ``index`` is ``write_index(...)`` when the caller already has it.
    Returns (attn [S, T, Hq, D], (k_pages, v_pages))."""
    quantized = isinstance(k_pages, Quantized)
    page = (k_pages.q if quantized else k_pages).shape[1]
    if index is None:
        index = write_index(tables, lengths, q.shape[1], page, n_valid)
    phys, off = index
    if quantized:
        kq, vq = quantize_kv(k_new), quantize_kv(v_new)
        k_pages.q[phys, off] = kq.q
        k_pages.scale[phys, off] = kq.scale
        v_pages.q[phys, off] = vq.q
        v_pages.scale[phys, off] = vq.scale
    else:
        k_pages[phys, off] = k_new.to(k_pages.dtype)
        v_pages[phys, off] = v_new.to(v_pages.dtype)

    # K4 reads q rows contiguous; a fused-QKV family's q (gpt2) is a
    # strided slice of its projection: one copy here (a no-op otherwise)
    q = q.contiguous()
    if impl in ("auto", "flash"):
        attend = paged_flash_attend
    elif impl == "xla":
        if q.is_cuda:
            raise ValueError("impl='xla' (the gather path) runs only on the "
                             "CPU; on the card the paged kernel attends")
        attend = paged_attend_reference
    else:
        raise ValueError(f"impl must be 'auto', 'flash' or 'xla', got "
                         f"{impl!r}")
    if quantized:
        attn = attend(q, k_pages.q, v_pages.q, tables, lengths,
                      k_scale=k_pages.scale[..., 0],
                      v_scale=v_pages.scale[..., 0], window=window,
                      scale=scale, softcap=softcap)
    else:
        attn = attend(q, k_pages, v_pages, tables, lengths, window=window,
                      scale=scale, softcap=softcap)
    return attn, (k_pages, v_pages)


def make_attend(tables, lengths, *, impl: str = "auto", n_valid=None):
    """Bind (tables, lengths, impl, n_valid) into the per-layer attend
    callback ``paged_decode_step`` expects. The write index is computed at
    the first layer's call and reused by the others."""
    index = {}

    def attend(q, k_new, v_new, k_pages, v_pages, *, window=None, scale=None,
               softcap=None):
        page = (k_pages.q if isinstance(k_pages, Quantized)
                else k_pages).shape[1]
        key = (q.shape[1], page)
        if key not in index:
            index[key] = write_index(tables, lengths, q.shape[1], page,
                                     n_valid)
        return paged_attend(q, k_new, v_new, k_pages, v_pages, tables,
                            lengths, window=window, scale=scale,
                            softcap=softcap, impl=impl, n_valid=n_valid,
                            index=index[key])

    return attend


def commit_prefill(k_pages, v_pages, k_dense, v_dense, table_row,
                   n_tokens: int, start: int = 0):
    """Scatter a bucketed prefill's dense cache into one slot's pages, in
    place. k_dense / v_dense [L, Pb, Hkv, D]; table_row [M] the slot's
    block table; positions >= ``n_tokens`` (pad) and < ``start`` (tokens
    already resident through a shared prefix) go to the trash page.
    Returns the pools."""
    quantized = isinstance(k_pages, Quantized)
    pb = k_dense.shape[1]
    page = (k_pages.q if quantized else k_pages).shape[2]
    m = table_row.shape[0]
    t = torch.arange(pb, device=k_dense.device)
    col = torch.clamp(t // page, max=m - 1)
    phys = torch.where((t >= start) & (t < n_tokens),
                       table_row.long()[col], TRASH_PAGE)
    off = t % page
    if quantized:
        kq, vq = quantize_kv(k_dense), quantize_kv(v_dense)
        k_pages.q[:, phys, off] = kq.q
        k_pages.scale[:, phys, off] = kq.scale
        v_pages.q[:, phys, off] = vq.q
        v_pages.scale[:, phys, off] = vq.scale
    else:
        k_pages[:, phys, off] = k_dense.to(k_pages.dtype)
        v_pages[:, phys, off] = v_dense.to(v_pages.dtype)
    return k_pages, v_pages


def copy_pages(k_pages, v_pages, src: int, dst: int):
    """Copy-on-write fork: duplicate page ``src`` into ``dst`` across every
    layer and every pool leaf (an int8 pool's scales fork with their
    payload), in place."""
    for pool in (k_pages, v_pages):
        for leaf in _leaves(pool):
            leaf[:, dst] = leaf[:, src]
    return k_pages, v_pages
