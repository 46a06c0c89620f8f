"""Ulysses (all-to-all) context parallelism: the ring's head-sharded dual.

Counterpart of ``distributed_training_guide_tpu/ops/ulysses_attention.py``
(DeepSpeed-Ulysses, Jacobs et al. 2023). Outside attention the sequence is
sharded over cp exactly as for the ring; during attention the layout
flips: an all-to-all over cp turns each member's [B, S / cp, H, D] into
[B, S, H / cp, D], attention runs on the full sequence for the member's
heads (K1-K3 on the card; window, scale and softcap pass straight through,
since each member sees every position of its heads), and a second
all-to-all flips the output back. Under tensor parallelism a rank's heads
are already its tp shard, so the flip is over cp alone.

Where cp does not divide the local kv heads (a GQA model), the JAX
package's "auto" gives way to its einsum path over the whole sequence;
the port computes that same function on the same shards: q, k and v
all-gathered over cp (one all-gather each, whose backward sums each
member's gradient share), the attention over the whole sequence with the
caller's ``impl`` ("auto" picks K1-K3 on the card as it does for one
device, the einsum path on the CPU), and the member's rows of the output
kept. An explicit ``impl="flash"`` refuses there, as in JAX.
"""
from __future__ import annotations

from .attention import multihead_attention
from .collectives import MemberExchange

_UNSET = object()


def ulysses_members(ex: MemberExchange, qs, ks, vs, *, causal: bool = True,
                    window=None, impl: str = "auto", scale=None,
                    logit_softcap=None) -> list:
    """Ulysses attention over ``ex``: one q / k / v [B, S_loc, H, D] per
    local member (the sequence shards in member order) -> each member's
    output [B, S_loc, Hq, D]."""
    cp = ex.size
    hq, hkv = qs[0].shape[2], ks[0].shape[2]
    divisible = hq % cp == 0 and hkv % cp == 0
    if not divisible:
        if impl == "flash":
            raise ValueError(
                f"ulysses flash attention needs cp={cp} to divide the "
                f"local heads (q {hq}, kv {hkv}); use impl='auto' or "
                f"'xla', or the ring (--context-impl ring)")
        return _gathered(ex, qs, ks, vs, causal=causal, window=window,
                         impl=impl, scale=scale, logit_softcap=logit_softcap)
    # sequence-sharded -> head-sharded: chunk j of the heads to member j,
    # the sequence shards concatenated in member order
    qh = ex.all_to_all(list(qs), 2, 1)
    kh = ex.all_to_all(list(ks), 2, 1)
    vh = ex.all_to_all(list(vs), 2, 1)
    outs = [multihead_attention(q, k, v, causal=causal, impl=impl,
                                window=window, scale=scale,
                                logit_softcap=logit_softcap)
            for q, k, v in zip(qh, kh, vh)]
    # and back: chunk j of the sequence to member j, heads in member order
    return ex.all_to_all(outs, 1, 2)


def _gathered(ex, qs, ks, vs, *, causal, window, impl, scale,
              logit_softcap):
    """The attention over the whole sequence from every member's shards;
    each member keeps its own rows."""
    import torch

    full = [ex.all_gather(list(xs), 1) for xs in (qs, ks, vs)]
    outs = []
    for pos, m in enumerate(ex.local):
        q, k, v = (f[pos] for f in full)
        out = multihead_attention(q, k, v, causal=causal, impl=impl,
                                  window=window, scale=scale,
                                  logit_softcap=logit_softcap)
        s_loc = qs[pos].shape[1]
        outs.append(torch.narrow(out, 1, m * s_loc, s_loc))
    return outs


def make_ulysses_attention(exchange: MemberExchange, *, causal: bool = True,
                           window=None, impl: str = "auto", scale=None,
                           logit_softcap=None):
    """Attention callable (the ``make_ring_attention`` contract) running the
    Ulysses layout flip over ``exchange`` (this process's one member).
    ``impl``: 'flash' forces the kernels (and refuses heads cp does not
    divide), 'xla' the einsum path, 'auto' the kernels on the card where
    the shapes allow. A per-call ``window`` overrides the default."""
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"impl must be 'auto', 'flash' or 'xla', got "
                         f"{impl!r}")
    window_default = window

    def attention(q, k, v, standard_layout: bool = True, window=_UNSET,
                  **kwargs):
        if not standard_layout:
            raise ValueError(
                "ulysses attention assumes the standard contiguous position "
                "layout; don't pass explicit positions under context "
                "parallelism")
        wcall = window_default if window is _UNSET else window
        return ulysses_members(exchange, [q], [k], [v], causal=causal,
                               window=wcall, impl=impl, scale=scale,
                               logit_softcap=logit_softcap)[0]

    attention.accepts_window = True
    return attention
