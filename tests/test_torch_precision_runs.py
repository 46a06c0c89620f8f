"""The precision policies' longer runs on the CPU (split from
``tests/test_torch_precision.py``, whose test count puts it early in
pytest-xdist's loadfile queue; a file of few tests runs late, after the
JAX package's ``tests/test_pipeline.py``, whose start bounds the tier-1
run): three wrapped AdamW updates under ``bf16-master``, ``adam8bit``
and both against JAX's ``POLICIES[...].wrap(adamw)``, and adam8bit's
blocks where tp shards split them, on 4 gloo ranks
(``tests/torch_dist_worker.py --scenario quantize``)."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_guide_tpu.train import optimizer as jopt
from distributed_training_guide_tpu.train import precision as jprec
from distributed_training_guide_tpu_torch.train import optimizer as topt
from distributed_training_guide_tpu_torch.train import precision as tprec
import torch_threads  # noqa: F401  (one torch thread a test process)


def _bf16_ulps(a: torch.Tensor, b: np.ndarray) -> int:
    """Largest distance in bf16 steps between two bf16 arrays of the same
    signs (their bit patterns as ordered integers)."""
    ta = a.view(torch.int16).numpy().astype(np.int64)
    tb = np.asarray(b).view(np.int16).astype(np.int64)
    return int(np.abs(ta - tb).max())


SHAPES = {"w": (6, 130), "norm": (130,), "stack": (2, 4, 96)}


def _leaves(rng, dtype=np.float32):
    return {k: rng.standard_normal(s).astype(dtype) for k, s in
            SHAPES.items()}


def jax_leaves(state):
    """The optax states of a chain, depth first."""
    out = []
    stack = [state]
    while stack:
        s = stack.pop()
        out.append(s)
        if isinstance(s, tuple) and not hasattr(s, "_fields"):
            stack.extend(reversed(s))
    return out


@pytest.mark.parametrize("policy", ["bf16-master", "adam8bit",
                                    "bf16-master+adam8bit"])
def test_wrapped_adamw_steps_match_jax(policy):
    """Three AdamW updates under the policy from the same params and grads:
    bf16 params within 1 bf16 ulp of JAX's ``POLICIES[...].wrap(adamw)``
    (both round one fp32 result once; torch and optax order the fp32
    arithmetic alike, so a tie can flip one step), fp32 params within 1e-6
    relative; the stored moments: bf16 within 1 ulp, int8 payloads within
    one step and scales within 1e-6 relative."""
    rng = np.random.default_rng(2)
    init = _leaves(rng)
    grads = [_leaves(rng) for _ in range(3)]
    jpol = jprec.resolve_policy(policy)
    tpol = tprec.resolve_policy(policy)
    tx = jpol.wrap(jopt.adamw_cosine(1e-2, t_max=10))
    jp = jpol.cast_params({k: jnp.asarray(v) for k, v in init.items()})
    jstate = tx.init(jp)
    tparams = tpol.cast_params({k: torch.from_numpy(v.copy())
                                for k, v in init.items()})
    ost = topt.adamw_cosine(1e-2, t_max=10).init(list(tparams.values()),
                                                 tpol)
    assert isinstance(ost.optimizer, topt.AdamW)
    for g in grads:
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        updates, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k]).to(p.dtype)
        ost.step()
    adam = next(s for s in jax_leaves(jstate)
                if isinstance(s, optax.ScaleByAdamState))
    assert int(adam.count) == ost.optimizer.count == 3
    for k, p in tparams.items():
        if p.dtype == torch.bfloat16:
            assert _bf16_ulps(p.detach(), jp[k]) <= 1, k
        else:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        slots = ost.optimizer.state[p]
        for slot, jm in (("exp_avg", adam.mu[k]), ("exp_avg_sq", adam.nu[k])):
            mine = slots[slot]
            if isinstance(mine, tprec.Quantized):
                assert np.abs(mine.q.numpy().astype(int)
                              - np.asarray(jm.q).astype(int)).max() <= 1
                np.testing.assert_allclose(mine.scale.numpy(),
                                           np.asarray(jm.scale), rtol=1e-6)
            else:
                assert mine.dtype == torch.bfloat16
                assert _bf16_ulps(mine, jm) <= 1, (k, slot)



def _gang(tmp_path, nproc: int, scenario: str) -> dict:
    """Run one scenario of ``tests/torch_dist_worker.py`` on ``nproc``
    gloo ranks and return rank 0's JSON result."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "distributed_training_guide_tpu_torch.launch."
         "local", "--nproc", str(nproc), "--log-dir", str(tmp_path / "logs"),
         "--", sys.executable, str(root / "tests" / "torch_dist_worker.py"),
         "--dir", str(tmp_path), "--scenario", scenario], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    logs = "\n".join(p.read_text()[-3000:]
                     for p in sorted((tmp_path / "logs").glob("*.err")))
    assert out.returncode == 0, out.stderr[-3000:] + logs
    return json.loads((tmp_path / f"{scenario}.json").read_text())


def test_adam8bit_blocks_split_by_tp_shards_match_one_device(tmp_path):
    """adam8bit's blocks where tp 4 cuts the trailing axis mid-block (520
    columns: 5 blocks of 104, shards of 130): the sharded quantizer gives
    each rank its columns of the one-device ``q``, the one-device scales
    whole, and its columns of the dequantized moment, bitwise; 500 columns
    (4 blocks of 125, one a shard) stay on the local path. A tp 4 adam8bit
    run over a 520-token vocab trains, and restores from its checkpoint
    (the replicated scales) to the same next losses."""
    got = _gang(tmp_path, 4, "quantize")
    for d, straddles in (("520", True), ("500", False)):
        for kind in ("mu", "nu"):
            r = got[f"{d}-{kind}"]
            assert r["straddles"] == straddles
            assert r["q"] and r["scale"] and r["dequant"], (d, kind, r)
    train = got["train"]
    assert all(np.isfinite(train["losses"]))
    assert train["resumed"] == train["losses"][1:]
