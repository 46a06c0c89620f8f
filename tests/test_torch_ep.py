"""The port's expert-parallel MoE dispatch against the JAX package's, in
one process.

The port runs every member in this process (``LocalExchange``: the
all-gather a concatenation, the reduce-scatter a sum and a split); the
JAX reference is ``make_ragged_ep_dispatch`` on the 8-device CPU mesh
(``ep=4``; ``ep=2, fsdp=2`` with ``embed_axis``, where the port's two
fsdp rows each run an ep pair and the experts' fsdp gather is the weight
itself, its grads summed over the rows as the reduce-scatter sums them),
jitted, its grouped GEMM on the CPU's scan path. Inputs at moe-debug's
widths (E 4, k 2, D 64, F 128; 16 tokens a member) from a numpy seed:
rows, routing and weights, held to 1e-5 of each output's and each
gradient's scale in fp32. Also: ``_local_groups_compute`` against JAX's
at every expert offset, the dense (capacity) dispatch over 4 virtual
members at capacity factors where at least half of the pairs drop,
against JAX's ``_moe_ffn`` on the global batch (the same dropped set,
``dropped_frac`` equal, y within 1e-5), and what the dispatch refuses."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.models import moe as jmoe
from distributed_training_guide_tpu.parallel import make_mesh as jmake_mesh
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.models import moe as tmoe
from distributed_training_guide_tpu_torch.ops import grouped_matmul as tgm
from distributed_training_guide_tpu_torch.ops.collectives import (
    LocalExchange)
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-5
T_MEMBER = 16


def _close(got, want, tol=TOL, err_msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=err_msg)


def _config(**over):
    jcfg = jget_model("moe-debug", dtype=jnp.float32, moe_dispatch="ragged",
                      **over).config
    tcfg = get_model("moe-debug", dtype=torch.float32, moe_dispatch="ragged",
                     **over).config
    return jcfg, tcfg


def _inputs(n_members, cfg, seed=15):
    """Rows [T, D], distinct top-k experts per token [T, k], normalized
    positive weights [T, k], expert stacks and the output cotangent."""
    rng = np.random.default_rng(seed)
    ex, k, d, f = (cfg.num_experts, cfg.experts_per_token, cfg.hidden_size,
                   cfg.intermediate_size)
    t = n_members * T_MEMBER
    x = rng.standard_normal((t, d)).astype(np.float32)
    idx = np.stack([rng.permutation(ex)[:k] for _ in range(t)]).astype(
        np.int32)
    probs = rng.uniform(0.1, 1.0, (t, k)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    w = {"gate": 0.1 * rng.standard_normal((ex, d, f)),
         "up": 0.1 * rng.standard_normal((ex, d, f)),
         "down": 0.1 * rng.standard_normal((ex, f, d))}
    w = {n: v.astype(np.float32) for n, v in w.items()}
    cot = rng.standard_normal((t, d)).astype(np.float32)
    return x, idx, probs, w, cot


def _jax_ragged(mesh_kw, embed_axis, cfg, x, idx, probs, w, cot):
    mesh = jmake_mesh(**mesh_kw)
    disp = jmoe.make_ragged_ep_dispatch(mesh, cfg, embed_axis=embed_axis)

    def scalar(x, probs, gate, up, down):
        y = disp(x, jnp.asarray(idx), probs, gate, up, down)
        return jnp.sum(y * cot), y

    (_, y), grads = jax.jit(jax.value_and_grad(
        scalar, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        x, probs, w["gate"], w["up"], w["down"])
    return [np.asarray(y)] + [np.asarray(g) for g in grads]


def _port_ragged(rows, ep, cfg, x, idx, probs, w, cot):
    """``rows`` data rows (fsdp) of ``ep`` members each: member (r, e)
    holds token block r * ep + e and experts block e."""
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, probs, w["gate"], w["up"], w["down"])]
    tx, tprobs, gate, up, down = leaves
    tidx = torch.from_numpy(idx).long()
    n = rows * ep
    xs, ps, ids = (list(torch.chunk(a, n)) for a in (tx, tprobs, tidx))
    e_loc = cfg.num_experts // ep
    ws = [[wt[e * e_loc:(e + 1) * e_loc] for e in range(ep)]
          for wt in (gate, up, down)]
    disp = tmoe.make_ragged_ep_dispatch(LocalExchange(ep), cfg)
    ys = []
    for r in range(rows):
        blk = slice(r * ep, (r + 1) * ep)
        ys += disp(xs[blk], ids[blk], ps[blk], *ws)
    y = torch.cat(ys)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(cot))
    return [y.detach().numpy()] + [g.numpy() for g in grads]


# (name, JAX mesh axes, JAX embed_axis, port fsdp rows, port ep)
RAGGED_CASES = [("ep4", {"ep": 4}, None, 1, 4),
                ("ep2_fsdp2", {"ep": 2, "fsdp": 2}, "fsdp", 2, 2)]


@pytest.mark.parametrize("name,mesh_kw,embed_axis,rows,ep", RAGGED_CASES,
                         ids=[c[0] for c in RAGGED_CASES])
def test_ragged_ep_dispatch_matches_jax(eight_devices, name, mesh_kw,
                                        embed_axis, rows, ep):
    """Outputs and the grads of sum(y * cot) with respect to the rows, the
    weights and the three expert stacks, each within 1e-5 of its scale;
    on CPU tensors no kernel launches."""
    jcfg, tcfg = _config()
    args = _inputs(rows * ep, tcfg)
    want = _jax_ragged(mesh_kw, embed_axis, jcfg, *args)
    before = (tgm.GMM_LAUNCHES, tgm.TGMM_LAUNCHES)
    got = _port_ragged(rows, ep, tcfg, *args)
    assert (tgm.GMM_LAUNCHES, tgm.TGMM_LAUNCHES) == before
    for key, g, w in zip(("y", "dx", "dprobs", "dgate", "dup", "ddown"),
                         got, want):
        _close(g, w, err_msg=key)


def test_ragged_ep_dispatch_matches_the_single_device_dispatch():
    """The 4-member exchange against the port's own single-device ragged
    dispatch on the same tokens: the window's gather at a device offset
    and its scatter back give the single device's outputs and grads."""
    _, tcfg = _config()
    x, idx, probs, w, cot = _inputs(4, tcfg)
    got = _port_ragged(1, 4, tcfg, x, idx, probs, w, cot)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, probs, w["gate"], w["up"], w["down"])]
    ef = torch.from_numpy(idx).long().T.reshape(-1)
    moe = dict(zip(("gate", "up", "down"), leaves[2:]))
    y = tmoe._ragged_dispatch(tcfg, leaves[0], ef, leaves[1].T.reshape(-1),
                              tmoe._group_sizes(ef, tcfg.num_experts), moe,
                              tcfg.dtype)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(cot))
    for key, g, want in zip(("y", "dx", "dprobs", "dgate", "dup", "ddown"),
                            got, [y.detach()] + list(grads)):
        _close(g, want.numpy(), err_msg=key)


@pytest.mark.parametrize("e0", [0, 1, 2, 3])
def test_local_groups_compute_matches_jax(e0):
    """One expert's window (e_local 1) at every offset of a group-sorted
    buffer: the rows of the other groups come back zero, the window's rows
    and the grads as JAX's within 1e-5 of their scale."""
    jcfg, tcfg = _config()
    x, idx, _, w, cot = _inputs(2, tcfg, seed=e0)
    ef = idx.T.reshape(-1)
    order = np.argsort(ef, kind="stable")
    xs = np.repeat(x, tcfg.experts_per_token, 0)[order]
    sizes = np.bincount(ef, minlength=tcfg.num_experts).astype(np.int32)
    cot = np.repeat(cot, tcfg.experts_per_token, 0)
    ws = {n: v[e0:e0 + 1] for n, v in w.items()}

    def jscalar(xs, gate, up, down):
        y = jmoe._local_groups_compute(xs, jnp.asarray(sizes), gate, up,
                                       down, e0, 1, jnp.float32)
        return jnp.sum(y * cot), y

    (_, jy), jg = jax.jit(jax.value_and_grad(
        jscalar, argnums=(0, 1, 2, 3), has_aux=True))(
        xs, ws["gate"], ws["up"], ws["down"])
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (xs, ws["gate"], ws["up"], ws["down"])]
    y = tmoe._local_groups_compute(leaves[0], torch.from_numpy(sizes),
                                   *leaves[1:], e0, 1, torch.float32)
    lo = int(sizes[:e0].sum())
    live = np.zeros(len(xs), bool)
    live[lo:lo + sizes[e0]] = True
    assert torch.all(y[torch.from_numpy(~live)] == 0)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(cot))
    _close(y.detach().numpy(), jy)
    for key, g, want in zip(("dx", "dgate", "dup", "ddown"), grads, jg):
        _close(g.numpy(), want, err_msg=key)


# (k, capacity factor, ep): the port's ep members, or 1 (each member runs
# every expert on its own tokens, the slot map global: ddp / fsdp / cp)
DENSE_CASES = [(1, 0.5, 4), (2, 0.5, 4), (2, 0.5, 1), (2, 0.25, 4)]


@pytest.mark.parametrize("k,cf,ep", DENSE_CASES,
                         ids=[f"k{k}-cf{cf}-ep{ep}" for k, cf, ep in
                              DENSE_CASES])
def test_dense_dispatch_over_members_drops_the_global_set(k, cf, ep):
    """4 members of 16 tokens against JAX's ``_moe_ffn`` on the global
    batch [4, 16, D]: the capacity is the global ``ceil(cf k T / E)`` and
    the slots go by the global priority, so the pairs each member drops
    are JAX's (dropped_frac equal, at least half of the pairs dropped;
    the tokens with no kept pair are exactly JAX's zero rows), y within
    1e-5 of its scale, and the grads of the rows and the expert stacks
    as those of the port's single-device dispatch."""
    over = dict(experts_per_token=k, capacity_factor=cf)
    jb = jget_model("moe-debug", dtype=jnp.float32, **over)
    jparams = jb.init(jb.config, jax.random.key(0))
    layer = jax.tree.map(lambda a: np.asarray(a)[0],
                         jparams["layers"]["moe"])
    x = np.random.default_rng(k).standard_normal(
        (4, T_MEMBER, jb.config.hidden_size)).astype(np.float32)
    jy, _, jdropped = jmoe._moe_ffn(jb.config, jnp.asarray(x),
                                    jax.tree.map(jnp.asarray, layer))
    jy = np.asarray(jy).reshape(-1, x.shape[-1])
    assert float(jdropped) >= 0.5

    cfg = get_model("moe-debug", dtype=torch.float32, **over).config
    w = from_jax.params_from_numpy(layer, device="cpu")
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1])).requires_grad_()
    stacks = [w[n].clone().requires_grad_() for n in ("gate", "up", "down")]
    probs = torch.softmax(xt @ w["router"], -1)
    tp, ti = torch.topk(probs, k, dim=-1)
    tp = tp / tp.sum(-1, keepdim=True)
    ex = LocalExchange(4)
    e_loc = cfg.num_experts // ep
    members = list(zip(torch.chunk(xt, 4), torch.chunk(ti, 4),
                       torch.chunk(tp, 4)))
    ys, dropped = tmoe.dense_ep_dispatch(
        cfg, [m[0] for m in members], [m[1] for m in members],
        [m[2] for m in members],
        [dict(zip(("gate", "up", "down"),
                  (s[(m % ep) * e_loc:(m % ep + 1) * e_loc]
                   for s in stacks))) for m in range(4)],
        route=ex, ep=ex if ep > 1 else None)
    y = torch.cat(ys)
    assert float(dropped) == float(jdropped)
    zero_rows = np.linalg.norm(jy, axis=-1) == 0
    assert np.array_equal(zero_rows,
                          (y.detach().norm(dim=-1) == 0).numpy())
    _close(y.detach().numpy(), jy)

    cot = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(y.shape)).astype(np.float32))
    got = torch.autograd.grad(y, [xt] + stacks, cot, retain_graph=True)
    ref, _ = tmoe.dense_ep_dispatch(cfg, [xt], [ti], [tp],
                                    [dict(zip(("gate", "up", "down"),
                                              stacks))])
    want = torch.autograd.grad(ref[0], [xt] + stacks, cot)
    for key, g, wnt in zip(("dx", "dgate", "dup", "ddown"), got, want):
        _close(g.numpy(), wnt.numpy(), err_msg=key)


def test_ragged_ep_dispatch_refusals_and_single_member():
    """None where no axis is wider than one member (the local dispatch is
    the program); ``overlap=True`` builds the double-buffered ring (held
    against the bulk exchange in ``tests/test_torch_overlap.py``) and
    refuses what the bulk form refuses; E must divide over ep."""
    _, tcfg = _config()
    assert tmoe.make_ragged_ep_dispatch(None, tcfg) is None
    assert tmoe.make_ragged_ep_dispatch(LocalExchange(1), tcfg) is None
    with pytest.raises(ValueError, match="divisible by the ep axis"):
        tmoe.make_ragged_ep_dispatch(LocalExchange(3), tcfg, overlap=True)
    assert tmoe.make_ragged_ep_dispatch(None, tcfg, overlap=True) is None
    with pytest.raises(ValueError, match="divisible by the ep axis"):
        tmoe.make_ragged_ep_dispatch(LocalExchange(3), tcfg)
    cfg = dataclasses.replace(tcfg, num_experts=8)
    assert tmoe.make_ragged_ep_dispatch(LocalExchange(4), cfg).ep.size == 4
    assert tmoe.make_ragged_ep_dispatch(LocalExchange(4), cfg,
                                        overlap=True).overlap
