"""The port's ring and Ulysses attention against the JAX package's, in one
process.

The port runs every cp member in this process (``LocalExchange``: the
ring's rotations are list rotations, Ulysses' all-to-all a reshuffle of
chunks). The ring cases are held to the JAX package's whole-sequence
attention (``ops/attention.py:multihead_attention``, ``impl="xla"``), the
function its ``make_ring_attention`` computes: the JAX package's
``tests/test_context_parallel.py`` and ``tests/test_swa.py`` hold its ring
to it (the two agreed within 1.2e-6 on these inputs), and an
interpret-mode ring compile cost the tier-1 run a minute of CPU a case.
The ring's pieces are held to JAX's own below (``_merge``, the zigzag
permutations, the pair predicates). Ulysses is held to
``make_ulysses_attention`` on the 8-device CPU mesh, jitted and built once
per module. Inputs: B 1, S 64, Hq 4, Hkv 2, D 16, fp32,
from a numpy seed. Causal, the non-causal zigzag, banded with softcap and
scale, Ulysses where cp divides the kv heads and where it does not
(JAX's "auto" gives way to its einsum path; the port computes the same
function), held to 1e-5 (o) and 1e-4 (grads). Also: ``_merge`` on rows
empty on both sides, the launch counts of the ring's pairs, and the
relayout and pair predicates against JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.ops import attention as jattention
from distributed_training_guide_tpu.ops import ring_attention as jring
from distributed_training_guide_tpu.ops.ulysses_attention import (
    make_ulysses_attention as jmake_ulysses)
from distributed_training_guide_tpu.parallel import make_mesh as jmake_mesh
from distributed_training_guide_tpu_torch.ops import flash_attention as fa
from distributed_training_guide_tpu_torch.ops import ring_attention as tring
from distributed_training_guide_tpu_torch.ops import ulysses_attention as tul
from distributed_training_guide_tpu_torch.ops.collectives import (
    LocalExchange)
import torch_threads  # noqa: F401  (one torch thread a test process)

B, S, HQ, HKV, D = 1, 64, 4, 2, 16
O_TOL, G_TOL = 1e-5, 1e-4
# (name, cp, causal, window, scale, softcap)
RING_CASES = [("causal", 4, True, None, None, None),
              ("noncausal", 4, False, None, None, None),
              ("banded", 4, True, 20, 0.3, 5.0)]
# (name, cp): cp 4 does not divide the 2 kv heads, cp 2 does
ULYSSES_CASES = [("indivisible", 4), ("divisible", 2)]


def _inputs():
    rng = np.random.default_rng(14)
    q = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    do = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    return q, k, v, do


def _jax_value_and_vjp(fn, q, k, v, do):
    """The output and the vjp of ``fn`` at ``do``, jitted as one program."""
    def value_and_vjp(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(do)

    out, grads = jax.jit(value_and_vjp)(*map(jnp.asarray, (q, k, v, do)))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def jax_refs():
    q, k, v, do = _inputs()
    refs = {}
    for name, cp, causal, window, scale, cap in RING_CASES:
        def fn(q, k, v, causal=causal, window=window, scale=scale, cap=cap):
            return jattention.multihead_attention(
                q, k, v, causal=causal, impl="xla", window=window,
                scale=scale, logit_softcap=cap)
        refs[f"ring-{name}"] = _jax_value_and_vjp(fn, q, k, v, do)
    for name, cp in ULYSSES_CASES:
        mesh = jmake_mesh(devices=jax.devices()[:cp], cp=cp)
        ul = jmake_ulysses(mesh, impl="auto")
        refs[f"ulysses-{name}"] = _jax_value_and_vjp(ul, q, k, v, do)
    return refs


def _port(fn, cp, q, k, v, do):
    """Every member's shard through ``fn(ex, qs, ks, vs)``; the outputs
    and the grads of sum(out * do), whole-sequence."""
    ex = LocalExchange(cp)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    shards = [list(torch.chunk(x, cp, dim=1)) for x in leaves]
    out = torch.cat(fn(ex, *shards), dim=1)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("name,cp,causal,window,scale,cap", RING_CASES,
                         ids=[c[0] for c in RING_CASES])
def test_ring_matches_jax(jax_refs, name, cp, causal, window, scale, cap):
    q, k, v, do = _inputs()
    counts = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    got = _port(lambda ex, qs, ks, vs: tring.ring_attention(
        ex, qs, ks, vs, causal=causal, window=window, scale=scale,
        softcap=cap), cp, q, k, v, do)
    want = jax_refs[f"ring-{name}"]
    np.testing.assert_allclose(got[0], want[0], rtol=O_TOL, atol=O_TOL)
    for key, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=G_TOL, atol=G_TOL,
                                   err_msg=key)
    # the CPU wrappers count no launch: only a CUDA tensor launches
    assert (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == counts


@pytest.mark.parametrize("name,cp", ULYSSES_CASES,
                         ids=[c[0] for c in ULYSSES_CASES])
def test_ulysses_matches_jax(jax_refs, name, cp):
    q, k, v, do = _inputs()
    got = _port(lambda ex, qs, ks, vs: tul.ulysses_members(ex, qs, ks, vs),
                cp, q, k, v, do)
    want = jax_refs[f"ulysses-{name}"]
    np.testing.assert_allclose(got[0], want[0], rtol=O_TOL, atol=O_TOL)
    for key, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=G_TOL, atol=G_TOL,
                                   err_msg=key)


def test_ulysses_flash_refuses_indivisible_heads():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs())
    ex = LocalExchange(4)
    shards = [list(torch.chunk(x, 4, dim=1)) for x in (q, k, v)]
    with pytest.raises(ValueError, match="divide the local heads"):
        tul.ulysses_members(ex, *shards, impl="flash")


def test_merge_keeps_rows_empty_on_both_sides():
    """Rows with lse = -1e30 on both sides stay o = 0, lse = -1e30; one
    empty side takes the other's row; JAX's ``_merge`` on the same
    values (its [B, H, S, D] layout) agrees."""
    rng = np.random.default_rng(3)
    o = rng.standard_normal((1, 4, 2, 8)).astype(np.float32)    # B S H D
    o_i = rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
    lse = rng.standard_normal((1, 2, 4)).astype(np.float32)      # B H S
    lse_i = rng.standard_normal((1, 2, 4)).astype(np.float32)
    lse[:, :, 0] = lse_i[:, :, 0] = tring.NEG_INF      # both empty
    o[:, 0] = o_i[:, 0] = 0.0
    lse[:, :, 1] = tring.NEG_INF                        # one side empty
    o[:, 1] = 0.0
    got_o, got_lse = tring._merge(*(torch.from_numpy(x)
                                    for x in (o, lse, o_i, lse_i)))
    jo, jlse = jring._merge(*(jnp.asarray(x) for x in (
        o.transpose(0, 2, 1, 3), lse, o_i.transpose(0, 2, 1, 3), lse_i)))
    np.testing.assert_allclose(got_o.numpy(),
                               np.asarray(jo).transpose(0, 2, 1, 3),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(jlse), rtol=1e-6)
    assert torch.all(got_o[:, 0] == 0)
    assert torch.all(got_lse[:, :, 0] == tring.NEG_INF)
    np.testing.assert_allclose(got_o[:, 1].numpy(), o_i[:, 1], rtol=1e-6)
    np.testing.assert_allclose(got_lse[:, :, 1].numpy(), lse_i[:, :, 1],
                               rtol=1e-6)


@pytest.mark.parametrize("cp", [2, 4, 8])
def test_zigzag_perms_and_pair_predicates_equal_jax(cp):
    assert tring._zigzag_perms(cp) == jring._zigzag_perms(cp)
    s_c = 16
    for q_chunk in range(2 * cp):
        for kv_chunk in range(2 * cp):
            for causal in (True, False):
                assert tring._relation(kv_chunk, q_chunk, causal) == int(
                    jring._relation(kv_chunk, q_chunk, causal))
            for window in (1, 16, 40, 2 ** 30):
                assert tring._pair_live(kv_chunk, q_chunk, s_c, window) == \
                    bool(jring._pair_live(kv_chunk, q_chunk, s_c, window))
    # every member runs 2 cp + 1 live pairs under causal masking
    assert tring.live_pairs(cp) == cp * (2 * cp + 1)
    assert tring.live_pairs(cp, causal=False) == 4 * cp * cp


def test_ring_zigzag_relayout_round_trips():
    """to_zigzag then from_zigzag is the identity, and member r holds
    chunks (r, 2cp-1-r) between them."""
    cp, s = 4, 64
    x = torch.arange(s, dtype=torch.float32)[None, :, None]
    ex = LocalExchange(cp)
    zz = tring._to_zigzag(ex, [[c] for c in torch.chunk(x, cp, dim=1)])
    s_c = s // (2 * cp)
    for r, ((c0, c1),) in enumerate(zz):
        assert int(c0[0, 0, 0]) == r * s_c
        assert int(c1[0, 0, 0]) == (2 * cp - 1 - r) * s_c
    back = tring._from_zigzag(ex, zz)
    assert torch.equal(torch.cat([b[0] for b in back], dim=1), x)


def test_ring_callable_refuses_explicit_positions():
    attn = tring.make_ring_attention(_OneMember(), window=None)
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="contiguous positions"):
        attn(q, q, q, standard_layout=False)
    assert attn.accepts_window
    with pytest.raises(ValueError, match="hop_loop"):
        tring.accept_hop_loop("spiral", 2)
    assert [tring.accept_hop_loop(h, 2) for h in tring.HOP_LOOPS] == list(
        tring.HOP_LOOPS)


class _OneMember(LocalExchange):
    def __init__(self):
        super().__init__(1)


@pytest.mark.parametrize("policy,forwards", [("attn", 1), ("attn_mlp", 1),
                                             ("all", 2), ("dots", 2)])
def test_remat_policy_saves_or_reruns_the_ring(monkeypatch, policy,
                                               forwards):
    """The ring is one dispatcher op under the "flash_out" / "flash_lse"
    names: the "attn" policies keep its output (the recompute reruns no
    ring forward, so no exchange), "all" and "dots" rerun it once; the
    grads are the same either way."""
    from distributed_training_guide_tpu_torch.ops.remat import remat

    runs = []
    real = tring.ring_forward

    def counted(*a, **kw):
        runs.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tring, "ring_forward", counted)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs())
    ex = LocalExchange(4)

    def layer(q, k, v):
        outs = tring.ring_attention(ex, *(list(torch.chunk(x, 4, dim=1))
                                          for x in (q, k, v)))
        return torch.tanh(torch.cat(outs, dim=1))

    grads = []
    for use_remat in (False, True):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        runs.clear()
        out = (remat(layer, *leaves, policy=policy) if use_remat
               else layer(*leaves))
        grads.append(torch.autograd.grad(out, leaves, do))
        if use_remat:
            assert len(runs) == forwards
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("rope_type", ["dynamic", "longrope"])
def test_sequence_shard_rope_reads_the_whole_sequence_length(rope_type):
    """Under cp each rank's RoPE tables are its rows of the whole
    sequence's: its global positions, and a sequence-dependent scaling
    (dynamic NTK, longrope) read at the whole sequence's length, as JAX's
    global max position gives it."""
    from distributed_training_guide_tpu_torch.ops.rope import (
        freeze_rope_scaling, rope_tables)

    scaling = {"dynamic": {"rope_type": "dynamic", "factor": 2.0},
               "longrope": {"rope_type": "longrope",
                            "original_max_position_embeddings": 32,
                            "short_factor": [1.0] * 8,
                            "long_factor": [2.0] * 8}}[rope_type]
    scaling = freeze_rope_scaling(scaling)
    s, cp = 128, 4
    whole = rope_tables(16, torch.arange(s)[None], 10000.0, scaling, 32)
    n = s // cp
    for r in range(cp):
        pos = torch.arange(n)[None] + r * n
        shard = rope_tables(16, pos, 10000.0, scaling, 32, seq_len=s)
        for w, g in zip(whole, shard):
            torch.testing.assert_close(g, w[:, r * n:(r + 1) * n], rtol=0,
                                       atol=0)
    # without the whole length, rank 0 would read its own shard's
    alone = rope_tables(16, torch.arange(n)[None], 10000.0, scaling, 32)
    assert not torch.equal(alone[0], whole[0][:, :n])


def test_trainer_refuses_a_callable_that_drops_the_attention_extras():
    """A user-supplied attn_impl cannot receive Gemma-2's softcap or score
    scale (the Trainer-built ring and Ulysses bake them in), nor a window
    unless it declares ``accepts_window``: the Trainer refuses it."""
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.train import optimizer as topt
    from distributed_training_guide_tpu_torch.train.step import Trainer

    def attn(q, k, v, standard_layout=True):
        return q

    for over in ({"attn_logit_softcap": 50.0}, {"sliding_window": 8}):
        with pytest.raises(ValueError, match="silently dropped"):
            Trainer(bundle=get_model("llama-debug", **over),
                    optimizer=topt.adamw_cosine(1e-3), attn_impl=attn,
                    device="cpu")
    attn.accepts_window = True
    Trainer(bundle=get_model("llama-debug", sliding_window=8),
            optimizer=topt.adamw_cosine(1e-3), attn_impl=attn, device="cpu")
    with pytest.raises(ValueError, match="context_impl"):
        Trainer(bundle=get_model("llama-debug"),
                optimizer=topt.adamw_cosine(1e-3), context_impl="spiral",
                device="cpu")


def test_exchange_registry_holds_an_exchange_only_while_it_is_used():
    """The ring's op names its exchange by id: the registry holds it
    weakly, a graph keeps it until that graph is gone, and then the
    entry goes with it."""
    import gc

    x = torch.randn(1, 16, 2, 8, requires_grad=True)
    ex = LocalExchange(2)
    key = id(ex)
    outs = tring.ring_attention(ex, *([list(torch.chunk(x, 2, dim=1))] * 3))
    del ex
    gc.collect()
    assert key in tring._EXCHANGES
    (g,) = torch.autograd.grad(torch.cat(outs, dim=1).sum(), [x])
    assert torch.isfinite(g).all()
    del outs
    gc.collect()
    assert key not in tring._EXCHANGES
