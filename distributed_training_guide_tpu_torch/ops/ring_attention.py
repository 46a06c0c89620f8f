"""Zigzag ring attention: context parallelism over the ``cp`` mesh axis.

Counterpart of ``distributed_training_guide_tpu/ops/ring_attention.py``,
function for function. The sequence of the batch and activations is
sharded over cp contiguously (member r holds positions [r S_loc, (r+1)
S_loc)); attention is the one operation that crosses the shards:

- **zigzag load balance**: the sequence is viewed as 2 cp chunks and two
  permutations (``_zigzag_perms``: two sends per member) move each
  member's (q, k, v) to the zigzag pair (chunk r, chunk 2cp-1-r), so every
  member owns one early and one late chunk and runs 2 cp + 1 live chunk
  pairs under causal masking. Outputs move back, so the function is
  layout-transparent.
- **ring**: the K / V blocks rotate to the next member each hop; the next
  hop's rotation is posted before this hop's pairs and waited on after
  them. Each pair's (o, lse) merges into the running one in fp32
  (``_merge``; a row with no live key on either side stays o = 0, lse =
  -1e30, as K1 returns it).
- **a flash kernel per chunk pair**: diagonal pairs run K1 causal, past
  pairs K1 with ``causal=False``, future pairs issue no launch. With a
  sliding ``window`` every live pair runs K1 causal with its global chunk
  offsets on the band (``(window, q_chunk * s_c, kv_chunk * s_c)``), and
  a pair whose keys all lie below the band of every query issues no
  launch (``_pair_live``).
- **the backward** reruns the ring with the global lse and ``delta =
  rowsum(do * o)`` through K2 / K3 (``flash_bwd_with_stats``); the dk / dv
  accumulators travel with their K / V blocks and arrive home after a
  full cycle. The forward keeps only the output and the sequence-layout
  lse.

The ring runs over a ``MemberExchange`` (``ops/collectives.py``): under a
process group one member per rank (the cp group's neighbour send /
receive), or every member in one process (``LocalExchange``: the card
check runs the ring at cp 4 on one card, and a CPU test holds it against
the JAX ring on one process). The JAX package's scan and unrolled hop
loops are op-for-op the same per hop; the port has one loop, and the
setting (``--cp-hop-loop``, the engine's ``cp_hop_loop``) is validated and
logged where it enters (``accept_hop_loop``).

The forward and backward are one ``torch.library`` custom op
(``dtg_torch::ring_attention``) with its autograd formula, run under the
"flash_out" / "flash_lse" names: a selective checkpoint policy sees one
operation, and under "attn" / "attn_mlp" keeps its output (so the
recompute reruns no exchange); under "all" every rank reruns it in the
same order. Heads and batch need no collective: attention is independent
per (batch, head), so a tp rank runs the ring on its own heads.
"""
from __future__ import annotations

import logging
import weakref
from typing import Optional

import torch

from . import flash_attention as fa
from .attention import check_static_window
from .collectives import MemberExchange
from .remat import checkpoint_name

NEG_INF = -1e30
_UNSET = object()
# id -> MemberExchange (the op takes an int); an entry goes with its exchange
_EXCHANGES: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
HOP_LOOPS = ("auto", "scan", "unrolled")
_log = logging.getLogger(__name__)


def _zigzag_perms(cp: int):
    """Permutations for the contiguous -> zigzag relayout. Contiguous
    member r holds chunks (2r, 2r+1); zigzag member r holds chunks (r,
    2cp-1-r). Chunk c's zigzag owner is c if c < cp else 2cp-1-c; each
    member's half h (chunk 2r+h) has one destination: one permutation per
    half."""
    def owner(c):
        return c if c < cp else 2 * cp - 1 - c

    perm0 = [(r, owner(2 * r)) for r in range(cp)]
    perm1 = [(r, owner(2 * r + 1)) for r in range(cp)]
    inv0 = [(d, s) for (s, d) in perm0]
    inv1 = [(d, s) for (s, d) in perm1]
    return perm0, perm1, inv0, inv1


def _to_zigzag(ex: MemberExchange, items: list) -> list:
    """Each local member's tensors [B, S_loc, ...] (contiguous shards) ->
    per member, per tensor, its two zigzag chunks (chunk r, chunk
    2cp-1-r), each [B, S_loc / 2, ...]."""
    cp = ex.size
    perm0, perm1, _, _ = _zigzag_perms(cp)
    first = [[x.narrow(1, 0, x.shape[1] // 2) for x in item]
             for item in items]
    second = [[x.narrow(1, x.shape[1] // 2, x.shape[1] // 2) for x in item]
              for item in items]
    pa, pb = ex.permute(first, perm0), ex.permute(second, perm1)
    recv_a, recv_b = pa.wait(), pb.wait()
    out = []
    for pos, m in enumerate(ex.local):
        # chunk m has parity m % 2 and arrives through that permutation;
        # chunk 2cp-1-m has the other parity, so they never collide
        a, b = recv_a[pos], recv_b[pos]
        if m % 2:
            a, b = b, a
        out.append([(x0, x1) for x0, x1 in zip(a, b)])
    return out


def _from_zigzag(ex: MemberExchange, items: list) -> list:
    """Inverse of ``_to_zigzag``: per member, per tensor, the (slot 0,
    slot 1) chunks -> the contiguous shard [B, S_loc, ...]."""
    _, _, inv0, inv1 = _zigzag_perms(ex.size)
    send_a, send_b = [], []
    for pos, m in enumerate(ex.local):
        a = [p[0] for p in items[pos]]
        b = [p[1] for p in items[pos]]
        if m % 2:
            a, b = b, a
        send_a.append(a)
        send_b.append(b)
    pa, pb = ex.permute(send_a, inv0), ex.permute(send_b, inv1)
    half0, half1 = pa.wait(), pb.wait()
    return [[torch.cat([x0, x1], dim=1) for x0, x1 in zip(h0, h1)]
            for h0, h1 in zip(half0, half1)]


def _merge(o, lse, o_i, lse_i):
    """Combine two normalized flash partials: o [B, S, H, D] fp32, lse
    [B, H, S] fp32. A row empty on both sides stays o = 0, lse =
    NEG_INF."""
    mx = torch.maximum(lse, lse_i)
    mx_safe = torch.where(mx < NEG_INF / 2, 0.0, mx)
    w0 = torch.exp(lse - mx_safe)
    w1 = torch.exp(lse_i - mx_safe)
    tot = w0 + w1
    safe_tot = torch.where(tot == 0.0, 1.0, tot)

    def rows(w):        # [B, H, S] -> [B, S, H, 1]
        return w.transpose(1, 2)[..., None]

    o_new = (o * rows(w0) + o_i * rows(w1)) / rows(safe_tot)
    lse_new = torch.where(tot == 0.0, NEG_INF, mx_safe + torch.log(safe_tot))
    return o_new, lse_new


def _relation(kv_chunk: int, q_chunk: int, causal: bool) -> int:
    """0 past (full attention) / 1 diagonal (causal) / 2 future (skip)."""
    if not causal:
        return 0
    if kv_chunk == q_chunk:
        return 1
    return 0 if kv_chunk < q_chunk else 2


def _pair_live(kv_chunk: int, q_chunk: int, s_c: int, window: int) -> bool:
    """Banded mode: a (q-chunk, kv-chunk) pair is dead when it is future
    (kv newer than q) or when every key of the kv chunk lies below the
    sliding-window band of every query of the q chunk (the newest key
    still inside the oldest query's window). ``2**30`` (no window) keeps
    every past pair live."""
    return (kv_chunk <= q_chunk
            and (kv_chunk + 1) * s_c - 1 >= q_chunk * s_c - (window - 1))


def _pairs(cp: int, my: int, hop: int, causal: bool, window, s_c: int):
    """The live (a, c, kernel keywords) of one member's hop: q slot a
    against kv slot c, from the hop's kv source member."""
    src = (my - hop) % cp
    my_chunks = (my, 2 * cp - 1 - my)
    kv_chunks = (src, 2 * cp - 1 - src)
    for a in range(2):
        for c in range(2):
            if window is not None:
                if _pair_live(kv_chunks[c], my_chunks[a], s_c, window):
                    yield a, c, dict(causal=True, band=(
                        window, my_chunks[a] * s_c, kv_chunks[c] * s_c))
            else:
                rel = _relation(kv_chunks[c], my_chunks[a], causal)
                if rel < 2:
                    yield a, c, dict(causal=rel == 1)


def live_pairs(cp: int, causal: bool = True, window=None,
               s_c: int = 1) -> int:
    """Chunk pairs that launch a kernel over the whole ring (every member,
    every hop): cp (2cp + 1) under causal masking without a window."""
    return sum(1 for m in range(cp) for i in range(cp)
               for _ in _pairs(cp, m, i, causal, window, s_c))


def _ring(cp: int):
    return [(i, (i + 1) % cp) for i in range(cp)]


def ring_forward(ex: MemberExchange, qs, ks, vs, *, causal: bool = True,
                 window=None, scale=None, softcap=None) -> tuple:
    """(outs, lse_seqs) per local member: o [B, S_loc, Hq, D] in q's dtype
    and the sequence-layout lse [B, S_loc, Hq] fp32."""
    cp = ex.size
    s_loc = qs[0].shape[1]
    if s_loc % 2:
        raise ValueError(f"local sequence {s_loc} must be even (2*cp "
                         f"chunks); pad the sequence to a multiple of "
                         f"{2 * cp}")
    s_c = s_loc // 2
    zz = _to_zigzag(ex, [[q, k, v] for q, k, v in zip(qs, ks, vs)])
    blocks = [[k0, k1, v0, v1] for _, (k0, k1), (v0, v1) in zz]
    o, lse = [], []
    for (q0, _), _, _ in zz:
        b, _, hq, d = q0.shape
        o.append([torch.zeros(b, s_c, hq, d, dtype=torch.float32,
                              device=q0.device) for _ in range(2)])
        lse.append([torch.full((b, hq, s_c), NEG_INF, dtype=torch.float32,
                               device=q0.device) for _ in range(2)])
    ring = _ring(cp)
    for hop in range(cp):
        nxt = ex.permute(blocks, ring) if hop < cp - 1 else None
        for pos, m in enumerate(ex.local):
            qz = zz[pos][0]
            kb, vb = blocks[pos][:2], blocks[pos][2:]
            for a, c, kw in _pairs(cp, m, hop, causal, window, s_c):
                o_i, lse_i = fa.flash_fwd(qz[a], kb[c], vb[c], scale=scale,
                                          softcap=softcap, **kw)
                o[pos][a], lse[pos][a] = _merge(o[pos][a], lse[pos][a],
                                                o_i.float(), lse_i)
        if nxt is not None:
            blocks = nxt.wait()
    dtype = qs[0].dtype
    back = _from_zigzag(ex, [
        [(o[pos][0].to(dtype), o[pos][1].to(dtype)),
         (lse[pos][0].transpose(1, 2), lse[pos][1].transpose(1, 2))]
        for pos in range(len(ex.local))])
    return [x[0] for x in back], [x[1] for x in back]


def ring_backward(ex: MemberExchange, qs, ks, vs, outs, lse_seqs, dos, *,
                  causal: bool = True, window=None, scale=None,
                  softcap=None) -> tuple:
    """(dqs, dks, dvs) per local member, from the forward's outputs and
    sequence-layout lse (the global softmax stats) and the output grads."""
    cp = ex.size
    zz = _to_zigzag(ex, [list(t) for t in zip(qs, ks, vs, outs, lse_seqs,
                                              dos)])
    s_c = qs[0].shape[1] // 2
    state = []
    for (qz, kz, vz, oz, lz, dz) in zz:
        lse = [x.transpose(1, 2).contiguous() for x in lz]
        delta = [torch.einsum("bshd,bshd->bhs", d_.float(),
                              o_.float()).contiguous()
                 for d_, o_ in zip(dz, oz)]
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in qz]
        state.append((qz, dz, lse, delta, dq))
    blocks = [[kz[0], kz[1], vz[0], vz[1]] for _, kz, vz, _, _, _ in zz]
    acc = [[torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for x in blk] for blk in blocks]
    ring = _ring(cp)
    for hop in range(cp):
        nxt = ex.permute(blocks, ring) if hop < cp - 1 else None
        for pos, m in enumerate(ex.local):
            qz, dz, lse, delta, dq = state[pos]
            kb, vb = blocks[pos][:2], blocks[pos][2:]
            for a, c, kw in _pairs(cp, m, hop, causal, window, s_c):
                dq_i, dk_i, dv_i = fa.flash_bwd_with_stats(
                    qz[a], kb[c], vb[c], dz[a], lse[a], delta[a],
                    scale=scale, softcap=softcap, **kw)
                dq[a].add_(dq_i.float())
                acc[pos][c].add_(dk_i.float())
                acc[pos][2 + c].add_(dv_i.float())
        # dk / dv travel with their K / V blocks: the last rotation
        # delivers them to their owners
        acc = ex.permute(acc, ring).wait()
        if nxt is not None:
            blocks = nxt.wait()
    qd, kd = qs[0].dtype, ks[0].dtype
    back = _from_zigzag(ex, [
        [(st[4][0].to(qd), st[4][1].to(qd)),
         (a_[0].to(kd), a_[1].to(kd)), (a_[2].to(kd), a_[3].to(kd))]
        for st, a_ in zip(state, acc)])
    return ([x[0] for x in back], [x[1] for x in back],
            [x[2] for x in back])


# ---------------------------------------------------------------------------
# the dispatcher op and its autograd formula
# ---------------------------------------------------------------------------

@torch.library.custom_op("dtg_torch::ring_attention", mutates_args=())
def ring_attention_op(qs: list[torch.Tensor], ks: list[torch.Tensor],
                      vs: list[torch.Tensor], exchange: int, causal: bool,
                      window: Optional[int], scale: Optional[float],
                      softcap: Optional[float]) -> list[torch.Tensor]:
    """The ring's forward as one dispatcher operation: the local members'
    outputs, then their sequence-layout lse. ``exchange`` is the id of a
    registered ``MemberExchange`` (``register_exchange``)."""
    outs, lses = ring_forward(_EXCHANGES[exchange], qs, ks, vs,
                              causal=causal, window=window, scale=scale,
                              softcap=softcap)
    return outs + lses


@ring_attention_op.register_fake
def _(qs, ks, vs, exchange, causal, window, scale, softcap):
    return ([torch.empty_like(q) for q in qs]
            + [q.new_empty(q.shape[:3], dtype=torch.float32) for q in qs])


def _ring_setup(ctx, inputs, output):
    qs, ks, vs, exchange, causal, window, scale, softcap = inputs
    n = len(qs)
    ctx.save_for_backward(*qs, *ks, *vs, *output)
    ctx.n = n
    # the graph holds the exchange until its backward has run
    ctx.args = (_EXCHANGES[exchange], causal, window, scale, softcap)


def _ring_backward(ctx, grads):
    n = ctx.n
    saved = ctx.saved_tensors
    qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
    outs, lses = saved[3 * n:4 * n], saved[4 * n:]
    ex, causal, window, scale, softcap = ctx.args
    dos = [torch.zeros_like(o) if g is None else g.to(o.dtype)
           for g, o in zip(grads[:n], outs)]
    dqs, dks, dvs = ring_backward(ex, qs, ks, vs, outs,
                                  lses, dos, causal=causal, window=window,
                                  scale=scale, softcap=softcap)
    return dqs, dks, dvs, None, None, None, None, None


ring_attention_op.register_autograd(_ring_backward,
                                    setup_context=_ring_setup)


def register_exchange(ex: MemberExchange) -> int:
    """The id the op names ``ex`` by; the entry lives as long as ``ex``."""
    _EXCHANGES[id(ex)] = ex
    return id(ex)


def accept_hop_loop(hop_loop: str, cp: int) -> str:
    """Validate the JAX ring's hop-loop form (``--cp-hop-loop``, the
    engine's ``cp_hop_loop``) and, under cp > 1, log it. The JAX package's
    scan and unrolled forms are op-for-op the same per hop, so the port
    runs one loop whatever the value."""
    if hop_loop not in HOP_LOOPS:
        raise ValueError(f"hop_loop must be 'auto', 'scan', or 'unrolled'; "
                         f"got {hop_loop!r}")
    if cp > 1:
        _log.info("ring attention over cp %d: hop_loop %r (one loop; the "
                  "JAX package's scan and unrolled forms are op-for-op the "
                  "same per hop)", cp, hop_loop)
    return hop_loop


def ring_attention(ex: MemberExchange, qs, ks, vs, *, causal: bool = True,
                   window=None, scale=None, softcap=None) -> list:
    """The local members' outputs of the ring over ``ex`` (one q / k / v
    [B, S_loc, H, D] per local member, the sequence shards in member
    order), autograd through the ring's backward."""
    if window is not None and not causal:
        raise ValueError(
            "window (sliding-window attention) requires causal=True")
    check_static_window(window)
    with checkpoint_name("flash_out", "flash_lse"):
        out = ring_attention_op(list(qs), list(ks), list(vs),
                                register_exchange(ex), causal,
                                None if window is None else int(window),
                                scale, softcap)
    return out[:len(qs)]


def make_ring_attention(exchange: MemberExchange, *, causal: bool = True,
                        window=None, scale=None, logit_softcap=None):
    """An attention callable with the ``multihead_attention`` signature
    (q, k, v [B, S_loc, H, D], this process's one member of ``exchange``)
    running the ring. ``window`` / ``scale`` / ``logit_softcap``: the
    sliding window (a per-call ``window`` overrides it), Gemma-2's score
    scale and tanh cap, threaded into every pair's kernels forward and
    backward."""
    if window is not None and not causal:
        raise ValueError(
            "window (sliding-window attention) requires causal=True")
    check_static_window(window)
    if len(exchange.local) != 1:
        raise ValueError("make_ring_attention takes a one-member exchange "
                         "(a process group); call ring_attention with "
                         "every member's tensors for a LocalExchange")
    register_exchange(exchange)
    window_default = window

    def attention(q, k, v, standard_layout: bool = True, window=_UNSET,
                  **kwargs):
        wcall = window_default if window is _UNSET else window
        if not standard_layout:
            raise ValueError(
                "ring attention assumes contiguous positions (rank r owns "
                "[r*S/cp, (r+1)*S/cp)); caller-supplied positions would "
                "desynchronize the causal mask: don't pass explicit "
                "positions under context parallelism")
        return ring_attention(exchange, [q], [k], [v], causal=causal,
                              window=wcall, scale=scale,
                              softcap=logit_softcap)[0]

    attention.accepts_window = True
    return attention
