"""Training under a plan, the pieces the plans refused until now, against
the JAX package.

One gang of 4 CPU ranks (``tests/torch_dist_worker.py --scenario
plans_rest``, started once for this module by the port's ``launch.local``)
runs, from the JAX init of llama-debug (fp32, AdamW 1e-3), the runs of
``REST_RUNS`` (two steps each): a custom ``loss_fn`` under fsdp 4, tp 4, cp
2 x dp 2 and pp 2 x dp 2 (the loss on the gathered global logits);
``loss_chunks`` 4 under cp 2 x dp 2, pp 2 x dp 2 and pp 2 x cp 2 (the
fused loss on each rank's rows and sequence shard); ZeRO-1 / 2 beside fsdp
and ZeRO-1 beside tp (the optimizer's embed dim over (dp, fsdp)); tp 4 with
and without sequence parallelism on a config tp does not divide (the
replicated fallback); one post-training step under fsdp 4 and tp 4; an
async save of an fsdp 4 state against the synchronous one; and an fp32
checkpoint re-encoded into ``bf16-master+adam8bit`` under fsdp 4. The JAX
references are the JAX Trainer on one device (the same math: every plan
computes the global loss) and, for the fallback, under tp on 4 of its
forced CPU devices. Bounds: ``tests/test_torch_dist.py``'s (loss rtol
1e-4, params rtol 1e-2 / atol 1e-4), the fused loss's value within 1e-5.
The unsharded step loop (against plans at world 1), the ep x fsdp exchange
over virtual members and the reference's softcap defect run in this
process.
"""
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_dist import _flatten, _gang, _logs
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]
SEQ, GLOBAL_BATCH = 32, 8
LOSS_RTOL = 1e-4
CHUNK_LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-2, 1e-4
# kept in step with tests/torch_dist_worker.py:REST_ODD
REST_ODD = dict(hidden_size=48, num_heads=6, num_kv_heads=2,
                intermediate_size=90)
# run -> the JAX reference it is held to
CUSTOM = ["custom_fsdp4", "custom_tp4", "custom_cp2_dp2", "custom_pp2_dp2"]
CHUNKS = ["chunks_cp2_dp2", "chunks_pp2_dp2", "chunks_pp2_cp2"]
ZERO = {"zero1_fsdp2_dp2": ("plain", "fsdp", {"fsdp": 2, "dp": 2}),
        "zero2_fsdp2_dp2": ("accum2", "fsdp", {"fsdp": 2, "dp": 2}),
        "zero1_tp2_dp2": ("plain", "tp", {"tp": 2, "dp": 2})}


def jax_custom_loss(logits, labels):
    """The JAX twin of ``torch_dist_worker.rest_custom_loss``."""
    lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
    t = labels[:, 1:]
    nll = -jnp.take_along_axis(lp, t[..., None], -1)[..., 0]
    return (0.9 * nll - 0.1 * lp.mean(-1)).mean()


def _post_batch(vocab):
    """8 rollouts over 32 positions, groups of 3 / 3 / 2 spanning the
    data ranks, one empty continuation, one full row."""
    rng = np.random.default_rng(7)
    prompt = np.array([2, 3, 4, 1, 5, 2, 6, 3], np.int32)
    total = np.array([10, 32, 4, 20, 17, 9, 30, 12], np.int32)
    tokens = rng.integers(3, vocab, (GLOBAL_BATCH, SEQ)).astype(np.int32)
    tokens[np.arange(SEQ)[None, :] >= total[:, None]] = 0
    return {"tokens": tokens, "prompt_lens": prompt, "total_lens": total,
            "rewards": rng.random(GLOBAL_BATCH).astype(np.float32),
            "group_ids": np.array([0, 0, 0, 1, 1, 1, 2, 2], np.int32)}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    from distributed_training_guide_tpu.models import get_model
    from distributed_training_guide_tpu.parallel import make_mesh, make_plan
    from distributed_training_guide_tpu.train import Trainer, adamw_cosine
    from distributed_training_guide_tpu.train import step as jstep

    tmp = tmp_path_factory.mktemp("plans_rest")
    ids = np.random.RandomState(0).randint(0, 512, (GLOBAL_BATCH, SEQ))
    refs = {}

    def trainer(over=None, plan=None, **kw):
        plan = plan or make_plan("single", make_mesh(
            devices=jax.devices()[:1]))
        return Trainer(bundle=get_model("llama-debug", dtype=jnp.float32,
                                        **(over or {})),
                       optimizer=adamw_cosine(1e-3), plan=plan,
                       donate=False, **kw)

    def run(t, state, ids_, steps=2):
        sh = t.batch_shardings()["input_ids"]
        batch = {k: jax.device_put(jnp.asarray(ids_), sh)
                 for k in ("input_ids", "labels")}
        losses = []
        for _ in range(steps):
            state, m = t.step_fn(state, batch)
            losses.append(float(m["loss"]))
        return losses, _flatten(jax.tree.map(np.asarray, state.params))

    t = trainer()
    init = t.init_state(0)
    np.savez(tmp / "init.npz",
             **_flatten(jax.tree.map(np.asarray, init.params)))
    refs["plain"] = run(t, init, ids)
    tc = trainer(loss_fn=jax_custom_loss)
    refs["custom"] = run(tc, tc.init_state(0), ids)
    ta = trainer(grad_accum=2)
    refs["accum2"] = run(ta, ta.init_state(0),
                         ids.reshape(2, GLOBAL_BATCH // 2, SEQ))
    post = _post_batch(512)
    np.savez(tmp / "post.npz", **post)
    tp_ = trainer()
    jstate, jm = jstep.make_post_step(tp_, objective="reinforce",
                                      baseline="group")(
        tp_.init_state(0), {k: jnp.asarray(v) for k, v in post.items()})
    refs["post"] = (float(jm["loss"]),
                    _flatten(jax.tree.map(np.asarray, jstate.params)))
    to = trainer(REST_ODD, plan=make_plan("tp", make_mesh(
        tp=4, devices=jax.devices()[:4])))
    odd = to.init_state(0)
    np.savez(tmp / "odd_init.npz",
             **_flatten(jax.tree.map(np.asarray, odd.params)))
    refs["odd"] = run(to, odd, ids)
    np.savez(tmp / "batches.npz", ids=ids)
    out = _gang(4, [sys.executable, str(ROOT / "tests" /
                                        "torch_dist_worker.py"),
                    "--dir", str(tmp), "--scenario", "plans_rest"], tmp,
                timeout=400)
    assert out.returncode == 0 and (tmp / "done").exists(), (
        out.stdout[-3000:] + out.stderr[-3000:] + _logs(tmp))
    return tmp, refs


def _held_to(got, ref, loss_rtol=LOSS_RTOL):
    jlosses, jparams = ref
    np.testing.assert_allclose(got["losses"], jlosses, rtol=loss_rtol)
    assert set(jparams) == {k[2:] for k in got.files if k.startswith("p/")}
    for path, want in jparams.items():
        np.testing.assert_allclose(got[f"p/{path}"], want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=path)


def _facts(gang):
    tmp, _ = gang
    return json.loads((tmp / "plans_rest.json").read_text())


@contextlib.contextmanager
def _world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_step_loop_without_a_plan_is_bitwise_the_plans_at_world_1():
    """The Trainer's one step loop: without a plan (the ``single`` plan)
    and under ddp, fsdp, tp_fsdp and zero2 (grad_accum 2) at world 1 on a
    real gloo group, two AdamW steps give bitwise the same losses and
    params (every collective a one-rank copy)."""
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.parallel import (make_mesh,
                                                               make_plan)
    from distributed_training_guide_tpu_torch.train import optimizer as topt
    from distributed_training_guide_tpu_torch.train.state import (
        named_leaves)
    from distributed_training_guide_tpu_torch.train.step import Trainer

    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 512, (4, 32)))

    def run(strategy, accum):
        plan = None if strategy is None else make_plan(
            strategy, make_mesh(device="cpu"))
        t = Trainer(bundle=get_model("llama-debug", dtype=torch.float32),
                    optimizer=topt.adamw_cosine(1e-3), plan=plan,
                    grad_accum=accum, device="cpu")
        state = t.init_state(0)
        x = ids if accum == 1 else ids.reshape(accum, -1, 32)
        losses = []
        for _ in range(2):
            state, m = t.step_fn(state, {"input_ids": x, "labels": x})
            losses.append(m["loss"].item())
        return losses, {p: v.detach().clone()
                        for p, v in named_leaves(state.params)}

    with _world_of_one():
        for accum in (1, 2):
            want = run(None, accum)
            for strategy in ("single", "ddp", "fsdp", "tp_fsdp", "zero2"):
                got = run(strategy, accum)
                assert got[0] == want[0], (strategy, accum)
                for path, v in want[1].items():
                    assert torch.equal(got[1][path], v), (strategy, path)


@pytest.mark.parametrize("run", CUSTOM)
def test_custom_loss_under_a_plan_holds_jax(gang, run):
    """``loss_fn`` on the global logits, gathered over tp's vocab, the
    data rows and cp's sequence (under pp per microbatch on the last
    stage), against the JAX Trainer with the same loss."""
    tmp, refs = gang
    _held_to(np.load(tmp / f"rest_{run}.npz"), refs["custom"])


@pytest.mark.parametrize("run", CHUNKS)
def test_loss_chunks_under_cp_and_pp_hold_jax(gang, run):
    """The fused loss on each rank's sequence shard against its shifted
    targets (cp) and per microbatch on the last stage (pp): the first loss
    within 1e-5 of JAX's whole loss in fp32, the trajectory at the gang's
    bounds."""
    tmp, refs = gang
    got = np.load(tmp / f"rest_{run}.npz")
    np.testing.assert_allclose(got["losses"][0], refs["plain"][0][0],
                               rtol=CHUNK_LOSS_RTOL)
    _held_to(got, refs["plain"])


def test_async_sharded_save_restores_bitwise_the_synchronous(gang):
    """An fsdp 4 state saved asynchronously (the step after it runs while
    the write does) restores bitwise the synchronous save of the same
    state, under fsdp 4 and resharded under tp_fsdp 2 x 2; save() blocked
    only for the staging."""
    facts = _facts(gang)["async"]
    assert facts["equal"] == {"fsdp4": True, "tp_fsdp": True}
    assert facts["async"] is True and facts["blocking_s"] > 0


def test_fp32_checkpoint_reencodes_under_fsdp_bitwise_the_unsharded(gang):
    """Every param and moment of the fp32 checkpoint re-encoded into
    ``bf16-master+adam8bit`` under fsdp 4 (each rank its shards; scales of
    blocks its shards split taken globally) equals the unsharded
    re-encoding, gathered; the first losses agree in fp32."""
    facts = _facts(gang)["reencode"]
    assert facts["keys_equal"]
    assert len(facts["bitwise"]) == facts["n_tensors"] > 0
    np.testing.assert_allclose(*facts["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("run", list(ZERO))
def test_zero_beside_sharded_params_holds_jax(gang, run):
    """ZeRO beside fsdp or tp: the trajectory against JAX's, and each
    rank's optimizer shard shaped as JAX's ``_opt_state_shardings`` lays
    out the moments on the same mesh."""
    from distributed_training_guide_tpu.models import get_model
    from distributed_training_guide_tpu.parallel import make_mesh, make_plan
    from distributed_training_guide_tpu.train import Trainer, adamw_cosine

    tmp, refs = gang
    ref, strategy, mesh_kw = ZERO[run]
    _held_to(np.load(tmp / f"rest_{run}.npz"), refs[ref])
    zero = {"zero2": True} if run.startswith("zero2") else {"zero1": True}
    jt = Trainer(bundle=get_model("llama-debug", dtype=jnp.float32),
                 optimizer=adamw_cosine(1e-3), donate=False,
                 plan=make_plan(strategy, make_mesh(
                     devices=jax.devices()[:4], **mesh_kw), **zero))
    def name(k):
        return str(getattr(k, "key", getattr(k, "name", k)))

    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            jt.opt_shardings_device)[0]:
        keys = [name(k) for k in path]
        if "mu" in keys:
            want["/".join(keys[keys.index("mu") + 1:])] = sh
    shapes = {"/".join(name(k) for k in p): s.shape
              for p, s in jax.tree_util.tree_flatten_with_path(
                  jt.param_shapes)[0]}
    held = _facts(gang)[run]
    assert set(held) == set(want) == set(shapes)
    for leaf, sh in want.items():
        assert held[leaf]["exp_avg"] == list(sh.shard_shape(shapes[leaf])), (
            leaf)


@pytest.mark.parametrize("run", ["post_fsdp4", "post_tp4"])
def test_post_step_under_a_plan_holds_jax(gang, run):
    """One REINFORCE step (group baseline, groups spanning the data ranks)
    under fsdp 4 and tp 4: the advantages from the whole batch,
    ``post_loss`` on the gathered logits, against the JAX post step."""
    tmp, refs = gang
    got = np.load(tmp / f"rest_{run}.npz")
    jloss, jparams = refs["post"]
    np.testing.assert_allclose(float(got["loss"]), jloss, rtol=1e-5,
                               atol=1e-5)
    for path, want in jparams.items():
        np.testing.assert_allclose(got[f"p/{path}"], want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=path)


def test_price_post_colocation_under_fsdp_equals_jax():
    """The post colocation under fsdp 8: the policy's bytes per device
    over the plan's shardings, byte for byte JAX's (the optimizers' 0-d
    step counters set aside, as ``tests/test_torch_post.py`` does)."""
    from distributed_training_guide_tpu.models import get_model as jget
    from distributed_training_guide_tpu.parallel import make_mesh as jmesh
    from distributed_training_guide_tpu.parallel import make_plan as jplan
    from distributed_training_guide_tpu.train import Trainer as JTrainer
    from distributed_training_guide_tpu.train import adamw_cosine as jadam
    from distributed_training_guide_tpu.train import preflight as jpre
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.parallel import (make_mesh,
                                                               make_plan)
    from distributed_training_guide_tpu_torch.train import optimizer as topt
    from distributed_training_guide_tpu_torch.train import preflight as tpre
    from distributed_training_guide_tpu_torch.train.step import Trainer

    kw = dict(n_slots=4, max_len=64, page_size=16)
    jt = JTrainer(bundle=jget("llama-debug"), optimizer=jadam(1e-3),
                  plan=jplan("fsdp", jmesh(fsdp=8)), donate=False)
    want = jpre.price_post_colocation(jt, **kw)
    jcount = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(
        jax.eval_shape(jt.optimizer.init, jt.param_shapes)) if x.ndim == 0)
    with tpre.fake_group(8):
        t = Trainer(bundle=get_model("llama-debug"),
                    optimizer=topt.adamw_cosine(1e-3), device="meta",
                    plan=make_plan("fsdp", make_mesh(device="cpu", fsdp=8)))
        got = tpre.price_post_colocation(t, **kw)
        opt = dataclasses.replace(t, device="meta").init_state(
            0).opt_state.optimizer
        tcount = sum(s["step"].numel() * s["step"].element_size()
                     for s in opt.state.values())
    assert got.keys() == want.keys()
    assert got["policy_param_bytes"] < want["engine_param_bytes"]
    for k, w in want.items():
        g = got[k]
        if k in ("policy_opt_state_bytes", "total_bytes"):
            g, w = g - tcount, w - jcount
        assert g == w, k


@pytest.mark.parametrize("run", ["odd_tp4_sp", "odd_tp4"])
def test_tp_that_does_not_divide_runs_the_replicated_fallback(gang, run):
    """6 q heads and an MLP width of 90 under tp 4 (sequence parallel or
    not): attention and the MLP run whole on every tp rank (their tp
    shards gathered), against the JAX Trainer under tp 4."""
    tmp, refs = gang
    _held_to(np.load(tmp / f"rest_{run}.npz"), refs["odd"])


def test_ep_fsdp_exchange_over_virtual_members_holds_jax():
    """ep 2 x fsdp 2 over 4 virtual members in one process (``embed`` a
    ``LocalExchange``: each ep member's embed shards gathered over its
    fsdp row): bitwise the emulation on gathered weights, and within 1e-5
    of JAX's ep_fsdp exchange, outputs and every grad."""
    from test_torch_ep import _config, _inputs, _jax_ragged, _port_ragged

    from distributed_training_guide_tpu_torch.models import moe as tmoe
    from distributed_training_guide_tpu_torch.ops.collectives import (
        LocalExchange)

    jcfg, tcfg = _config()
    args = _inputs(4, tcfg)
    x, idx, probs, w, cot = args
    want = _jax_ragged({"ep": 2, "fsdp": 2}, "fsdp", jcfg, *args)
    emulated = _port_ragged(2, 2, tcfg, *args)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, probs, w["gate"], w["up"], w["down"])]
    tx, tprobs, gate, up, down = leaves
    xs, ps, ids = (list(torch.chunk(a, 4)) for a in (
        tx, tprobs, torch.from_numpy(idx).long()))
    e_loc = tcfg.num_experts // 2

    def block(wt, e, f, dim):
        return wt[e * e_loc:(e + 1) * e_loc].chunk(2, dim)[f]

    ws = [[block(wt, e, f, dim) for f in range(2) for e in range(2)]
          for wt, dim in ((gate, 1), (up, 1), (down, 2))]
    disp = tmoe.make_ragged_ep_dispatch(LocalExchange(2), tcfg,
                                        embed=LocalExchange(2))
    y = torch.cat(disp(xs, ids, ps, *ws))
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(cot))
    got = [y.detach().numpy()] + [g.numpy() for g in grads]
    for key, g, e, j in zip(("y", "dx", "dprobs", "dgate", "dup", "ddown"),
                            got, emulated, want):
        assert np.array_equal(g, e), key
        scale = max(float(np.abs(j).max()), 1e-30)
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-5 * scale,
                                   err_msg=key)


def test_reference_chunked_loss_drops_the_final_softcap():
    """A defect of the JAX package, pinned: its ``loss_chunks`` on a config
    with ``final_logit_softcap`` falls back to ``chunked_causal_lm_loss``,
    which never applies the cap, so its loss is not its whole loss. The
    port refuses that case, citing ROADMAP.md queue 3."""
    from distributed_training_guide_tpu.models import get_model as jget
    from distributed_training_guide_tpu.parallel import make_mesh, make_plan
    from distributed_training_guide_tpu.train import Trainer as JTrainer
    from distributed_training_guide_tpu.train import adamw_cosine as jadam
    from distributed_training_guide_tpu_torch.models import get_model
    from distributed_training_guide_tpu_torch.train import optimizer as topt
    from distributed_training_guide_tpu_torch.train.step import Trainer

    ids = jnp.asarray(np.random.RandomState(5).randint(0, 512, (2, 32)))
    losses = []
    for cap, chunks in ((0.05, 0), (0.05, 4), (None, 0)):
        jt = JTrainer(bundle=jget("llama-debug", dtype=jnp.float32,
                                  final_logit_softcap=cap),
                      optimizer=jadam(1e-3), loss_chunks=chunks,
                      donate=False, plan=make_plan("single", make_mesh(
                          devices=jax.devices()[:1])))
        _, m = jt.step_fn(jt.init_state(0), {"input_ids": ids,
                                             "labels": ids})
        losses.append(float(m["loss"]))
    capped, chunked, uncapped = losses
    # the chunked loss is the uncapped model's, not the capped one's
    assert chunked == pytest.approx(uncapped, rel=1e-6)
    assert abs(chunked - capped) > 100 * 1e-6 * abs(capped)
    with pytest.raises(NotImplementedError,
                       match="softcap.*queue 3.*Found in the reference"):
        Trainer(bundle=get_model("llama-debug", dtype=torch.float32,
                                 final_logit_softcap=0.05),
                optimizer=topt.adamw_cosine(1e-3), device="cpu",
                loss_chunks=4)
