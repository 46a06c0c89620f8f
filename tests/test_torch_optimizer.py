"""The port's optimizers against the JAX package's optax chains on the CPU:
``adamw_cosine(grad_clip=)``, ``adafactor_cosine`` and ``lion_cosine``
over three updates from the same params and grads (made with numpy from a
seed), fp32 params within 1e-6 relative. The leaves cover adafactor's
factored case (two axes of at least 128, also stacked on a leading layer
axis) and its unfactored cases (a leaf under 128 wide, a 1-d leaf)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_guide_tpu.train import optimizer as jopt
from distributed_training_guide_tpu.train import precision as jprec
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train import precision as tprec

SHAPES = {"wide": (130, 256), "stacked": (2, 128, 160), "narrow": (64, 300),
          "vec": (300,)}
RTOL = 1e-6


def _draw(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(name, kw, grad_scale=1.0, steps=3, policy=None):
    rng = np.random.default_rng(7)
    init = _draw(rng)
    grads = [_draw(rng, grad_scale) for _ in range(steps)]
    tx = getattr(jopt, f"{name}_cosine")(1e-2, t_max=10, **kw)
    tpol = tprec.resolve_policy(policy)
    if policy is not None:
        tx = jprec.resolve_policy(policy).wrap(tx)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    ost = getattr(topt, f"{name}_cosine")(1e-2, t_max=10, **kw).init(
        list(tp.values()), tpol)
    for g in grads:
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        ost.step()
    return tp, jp, ost, jstate


def _assert_params_close(tp, jp):
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=RTOL, err_msg=k)


@pytest.mark.parametrize("grad_clip,grad_scale", [
    (None, 1.0), (1.0, 1.0), (1e3, 1.0)],
    ids=["no-clip", "clipped", "under-the-norm"])
def test_adamw_cosine_grad_clip_matches_optax(grad_clip, grad_scale):
    """The global norm of these grads is ~320: a max norm of 1 clips every
    update, one of 1e3 none."""
    tp, jp, ost, _ = _run_both("adamw", {"grad_clip": grad_clip},
                               grad_scale)
    assert isinstance(ost.optimizer, torch.optim.AdamW)
    _assert_params_close(tp, jp)


def test_adafactor_matches_optax_chain():
    tp, jp, ost, jstate = _run_both("adafactor", {})
    _assert_params_close(tp, jp)
    opt = ost.optimizer
    assert isinstance(opt, topt.Adafactor) and opt.count == 3
    factored = next(s for s in jax.tree.leaves(
        jstate, is_leaf=lambda x: isinstance(x, optax.FactoredState))
        if isinstance(s, optax.FactoredState))
    for k, p in tp.items():
        slots = opt.state[p]
        dims = topt.factored_dims(p.shape, 128)
        if dims is None:          # full accumulator, like optax's v
            assert set(slots) == {"v"}, k
            np.testing.assert_allclose(slots["v"].numpy(),
                                       np.asarray(factored.v[k]),
                                       rtol=1e-5, err_msg=k)
        else:
            assert set(slots) == {"v_row", "v_col"}, k
            for slot in ("v_row", "v_col"):
                np.testing.assert_allclose(
                    slots[slot].numpy(), np.asarray(getattr(factored,
                                                            slot)[k]),
                    rtol=1e-5, err_msg=(k, slot))
    assert topt.factored_dims((64, 300), 128) is None       # < 128 wide
    assert topt.factored_dims((300,), 128) is None
    assert topt.factored_dims((2, 128, 160), 128) == (1, 2)


def test_lion_matches_optax():
    tp, jp, ost, _ = _run_both("lion", {})
    assert isinstance(ost.optimizer, topt.Lion)
    _assert_params_close(tp, jp)


@pytest.mark.parametrize("name", ["lion", "adafactor"])
def test_bf16_master_of_the_other_optimizers_matches_jax(name):
    """Under bf16-master lion's momentum and adafactor's accumulators are
    stored bf16 and the params too (within 1 bf16 ulp of JAX's)."""
    rng = np.random.default_rng(3)
    init = _draw(rng)
    grads = [_draw(rng) for _ in range(2)]
    jpol = jprec.resolve_policy("bf16-master")
    tx = jpol.wrap(getattr(jopt, f"{name}_cosine")(1e-2, t_max=10))
    jp = jpol.cast_params({k: jnp.asarray(v) for k, v in init.items()})
    jstate = tx.init(jp)
    tpol = tprec.resolve_policy("bf16-master")
    tp = tpol.cast_params({k: torch.from_numpy(v.copy())
                           for k, v in init.items()})
    ost = getattr(topt, f"{name}_cosine")(1e-2, t_max=10).init(
        list(tp.values()), tpol)
    for g in grads:
        jg = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()}
        updates, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k]).to(torch.bfloat16)
        ost.step()
    for k, p in tp.items():
        assert p.dtype == torch.bfloat16
        a = p.detach().view(torch.int16).numpy().astype(np.int64)
        b = np.asarray(jp[k]).view(np.int16).astype(np.int64)
        assert np.abs(a - b).max() <= 1, k
        assert all(v.dtype == torch.bfloat16
                   for v in ost.optimizer.state[p].values())


@pytest.mark.parametrize("name", ["lion", "adafactor"])
def test_adam8bit_refuses_an_optimizer_without_adam_moments(name):
    with pytest.raises(ValueError, match="adam8bit"):
        jprec.resolve_policy("adam8bit").wrap(
            getattr(jopt, f"{name}_cosine")(1e-3)).init(
                {"w": jnp.zeros((4, 4))})
    with pytest.raises(ValueError, match="adam8bit"):
        getattr(topt, f"{name}_cosine")(1e-3).init(
            [torch.zeros(4, 4)], tprec.resolve_policy("adam8bit"))


def test_optimizers_table_matches_jax():
    assert set(topt.OPTIMIZERS) == set(jopt.OPTIMIZERS)


@pytest.mark.parametrize("name", ["adamw", "lion", "adafactor"])
def test_bf16_params_under_the_fp32_policy_keep_bf16_state_as_optax(name):
    """``--param-dtype bfloat16`` with the default (no-op) policy: optax
    runs unwrapped, so every slot stays in the param's dtype (bf16) and the
    arithmetic is bf16. The port keeps the same storage and computes in
    bf16 too: after three updates adamw's and lion's params equal optax's
    bitwise; adafactor's (whose means XLA sums in another order) are within
    1 bf16 ulp, and at most 1 in 10,000 of them differ at all."""
    rng = np.random.default_rng(5)
    init = _draw(rng)
    grads = [_draw(rng) for _ in range(3)]
    tx = getattr(jopt, f"{name}_cosine")(1e-2, t_max=10)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in init.items()}
    jstate = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).to(torch.bfloat16)
          for k, v in init.items()}
    ost = getattr(topt, f"{name}_cosine")(1e-2, t_max=10).init(
        list(tp.values()), tprec.resolve_policy("fp32"))
    for g in grads:
        jg = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()}
        updates, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k]).to(torch.bfloat16)
        ost.step()
    for leaf in jax.tree.leaves(jstate):
        assert leaf.dtype in (jnp.bfloat16, jnp.int32), leaf.dtype
    differ = total = 0
    for k, p in tp.items():
        assert p.dtype == torch.bfloat16
        assert all(v.dtype == torch.bfloat16
                   for v in ost.optimizer.state[p].values()), k
        a = p.detach().view(torch.int16).numpy().astype(np.int64)
        b = np.asarray(jp[k]).view(np.int16).astype(np.int64)
        assert np.abs(a - b).max() <= 1, k
        differ += int((a != b).sum())
        total += a.size
    assert differ <= (1e-4 * total if name == "adafactor" else 0), (
        differ, total)
