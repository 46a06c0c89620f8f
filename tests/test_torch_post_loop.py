"""The port's on-policy loop (``post/*``) and the engine's publish seam on
the CPU: ``publish_params`` refuses a wrong layout naming the leaf, copies
the published leaves, and decodes after a publish exactly as a fresh
engine built from the published params (bf16 and int8 storage too); greedy
rollouts are token-identical to the JAX package's on the same weights; the
ledger skips a torn line and a resumed batch regenerates exactly what was
missing; the loop's reward climbs on the dense synthetic task; a NaN update
gates the publish; adapter publishing rolls out what merged publishing
does; the CLI prints the JAX CLI's keys and refuses an impossible
colocation before allocating anything."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_guide_tpu.models import get_model as jget_model
from distributed_training_guide_tpu.post import rollout as jrollout
from distributed_training_guide_tpu.serve import ServeEngine as JEngine
from distributed_training_guide_tpu_torch.models import from_jax, get_model
from distributed_training_guide_tpu_torch.models.lora import lora_bundle
from distributed_training_guide_tpu_torch.post import (
    PostTrainingLoop, ProgrammaticScorer, Rollout, RolloutLedger,
    TeacherScorer, band_reward, generate_rollouts, merged_params,
    publish_trained_adapter, rollout_seed)
from distributed_training_guide_tpu_torch.post.cli import main
from distributed_training_guide_tpu_torch.serve import (Request, ServeEngine,
                                                        generate_many)
from distributed_training_guide_tpu_torch.train.optimizer import adamw_cosine
from distributed_training_guide_tpu_torch.train.state import named_leaves
from distributed_training_guide_tpu_torch.train.step import Trainer
import torch_threads  # noqa: F401  (one torch thread a test process)

ENGINE = dict(n_slots=4, page_size=16, max_len=64, device="cpu")
JAX_KEYS = {"iteration", "rollout_tokens", "rollout_wall_s",
            "rollout_tokens_per_s", "resumed_from_ledger", "reward_mean",
            "publish_ms", "published", "publish_skipped_nonfinite", "step_s",
            "loss", "grad_norm", "post_tokens", "post_logprob_mean"}


@pytest.fixture(scope="module")
def models():
    jb = jget_model("llama-debug", dtype=jnp.float32)
    jparams = jb.init(jb.config, jax.random.key(0))
    tb = get_model("llama-debug", dtype=torch.float32)
    tparams = from_jax.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, tb, tparams


def _reqs(n=3, max_new=8, temp=0.0):
    return [Request(prompt_ids=[3 + i, 17, 42], max_new_tokens=max_new,
                    seed=100 + i, temperature=temp) for i in range(n)]


def _tokens(eng, reqs):
    return [list(r.generated_ids) for r in generate_many(
        eng, [dataclasses.replace(r, request_id=None) for r in reqs])]


def _shifted(tparams, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {p: t + 0.05 * torch.randn(t.shape, generator=g)
            for p, t in named_leaves(tparams)}


def _unflat(flat):
    out = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


@pytest.mark.parametrize("weight_dtype", [None, "bf16", "int8"])
def test_publish_equals_a_fresh_engine_and_copies(models, weight_dtype):
    _, _, tb, tparams = models
    new = _unflat(_shifted(tparams))
    eng = ServeEngine(tb, tparams, weight_dtype=weight_dtype, **ENGINE)
    before = _tokens(eng, _reqs(temp=0.7))
    assert eng.publish_params(new) == 1
    fresh = ServeEngine(tb, new, weight_dtype=weight_dtype, **ENGINE)
    assert _tokens(eng, _reqs(temp=0.7)) == _tokens(fresh, _reqs(temp=0.7))
    assert _tokens(eng, _reqs(temp=0.7)) != before
    for (_, a), (_, b) in zip(named_leaves(eng.params),
                              named_leaves(fresh.params)):
        for x, y in ((a.q, b.q), (a.scale, b.scale)) if hasattr(a, "q") \
                else ((a, b),):
            assert torch.equal(x, y)
    # copied, never aliased: the publisher's tensors may change after
    want = _tokens(eng, _reqs())
    for _, t in named_leaves(new):
        t.add_(1.0)
    assert _tokens(eng, _reqs()) == want
    if weight_dtype is not None:     # the stored layout is accepted too
        eng.publish_params(fresh.params)
        assert _tokens(eng, _reqs()) == _tokens(fresh, _reqs())


def test_publish_drops_the_prefix_cache(models):
    """A prompt whose pages the prefix cache holds from before a publish
    decodes as on a fresh engine after it: the cached k/v of the old
    weights is dropped, not reused."""
    _, _, tb, tparams = models
    new = _unflat(_shifted(tparams, seed=2))
    kw = dict(ENGINE, page_size=4)
    prompt = [Request(prompt_ids=list(range(3, 15)), max_new_tokens=6)]
    eng = ServeEngine(tb, tparams, **kw)
    _tokens(eng, prompt)
    assert eng.scheduler.cache.n_pages > 0
    eng.publish_params(new)
    assert eng.scheduler.cache.n_pages == 0
    assert _tokens(eng, prompt) == _tokens(ServeEngine(tb, new, **kw),
                                           prompt)
    assert eng.stats()["prefix_hits"] == 0
    assert _tokens(eng, prompt) == _tokens(ServeEngine(tb, new, **kw),
                                           prompt)
    assert eng.stats()["prefix_hits"] == 1     # the new weights' pages


def test_publish_refusals_name_the_leaf(models):
    _, _, tb, tparams = models
    eng = ServeEngine(tb, tparams, **ENGINE)
    flat = dict(named_leaves(tparams))
    bad = dict(flat)
    del bad["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        eng.publish_params(_unflat(bad))
    bad = {**flat, "layers/attn/wq": flat["layers/attn/wq"][:, :, :8]}
    with pytest.raises(ValueError, match="layers/attn/wq has shape"):
        eng.publish_params(_unflat(bad))
    bad = {**flat, "lm_head": flat["lm_head"].double()}
    with pytest.raises(ValueError, match="lm_head has dtype"):
        eng.publish_params(_unflat(bad))
    eng.publish_params(jax.tree.map(np.asarray, models[1]))   # numpy leaves
    with eng.programs.swap_guard():
        with pytest.raises(RuntimeError, match="swap"):
            eng.publish_params(tparams)
        with pytest.raises(RuntimeError, match="already in flight"):
            with eng.programs.swap_guard():
                pass
    eng.submit(_reqs(1)[0])
    with pytest.raises(RuntimeError, match="in flight"):
        eng.publish_params(tparams)
    assert eng.publish_params(tparams, force=True) == 2
    eng.drain()
    while eng.has_work:
        eng.step()


def test_greedy_rollouts_are_token_identical_to_jax(models, tmp_path):
    jb, jparams, tb, tparams = models
    prompts = [[3, 10, 17], [5, 6], [9, 9, 9, 9], [100]]
    kw = dict(iteration=2, base_seed=3, max_new_tokens=8, temperature=0.0,
              group_ids=[0, 0, 1, 1])
    want, _ = jrollout.generate_rollouts(
        JEngine(jb, jparams, n_slots=4, page_size=16, max_len=64), prompts,
        **kw)
    led = RolloutLedger(tmp_path / "led.jsonl")
    got, stats = generate_rollouts(ServeEngine(tb, tparams, **ENGINE),
                                   prompts, ledger=led, **kw)
    assert [r.to_json() for r in got] == [r.to_json() for r in want]
    assert stats["rollout_tokens"] == sum(len(r.generated_ids)
                                          for r in got)
    assert rollout_seed(3, 2, 1) == jrollout.rollout_seed(3, 2, 1)
    # the ledger holds them; a torn tail line is skipped, not fatal
    with open(led.path, "a") as fp:
        fp.write('{"iteration": 2, "index": 99, "trunc')
    assert {i: r.to_json() for i, r in led.completed(2).items()} == {
        r.index: r.to_json() for r in got}
    assert led.last_iteration() == 2 and led.completed(0) == {}


def test_resumed_batch_regenerates_only_what_was_missing(models, tmp_path):
    """Sampled rollouts, half of them on the ledger: a fresh engine
    generates the rest, bitwise what one uninterrupted batch gave."""
    _, _, tb, tparams = models
    prompts = [[3, 10, 17]] * 6
    kw = dict(iteration=0, base_seed=7, max_new_tokens=6, temperature=1.0)
    full, _ = generate_rollouts(ServeEngine(tb, tparams, **ENGINE), prompts,
                                **kw)
    led = RolloutLedger(tmp_path / "led.jsonl")
    for r in full[:3]:
        led.record(r)
    again, stats = generate_rollouts(ServeEngine(tb, tparams, **ENGINE),
                                     prompts, ledger=led, **kw)
    assert stats["resumed_from_ledger"] == 3
    assert stats["rollout_tokens"] == sum(len(r.generated_ids)
                                          for r in full[3:])
    assert [r.to_json() for r in again] == [r.to_json() for r in full]
    assert Rollout.from_json(full[0].to_json()) == full[0]


def test_reinforce_loop_reward_climbs_and_engine_is_fresh(models):
    """The dense task (``band_reward``, as the JAX package's own loop
    test): six iterations of full-param REINFORCE raise the reward, every
    boundary publishes, and the engine then decodes as a fresh engine on
    the final merged params."""
    _, _, tb, _ = models
    trainer = Trainer(bundle=tb, optimizer=adamw_cosine(0.1),
                      guard_policy="skip", device="cpu")
    state = trainer.init_state(0)
    engine = ServeEngine(tb, merged_params(trainer, state),
                         **{**ENGINE, "n_slots": 8})
    loop = PostTrainingLoop(
        trainer, engine, ProgrammaticScorer(band_reward(64)),
        [[3, 10, 17]] * 24, state=state, max_new_tokens=16,
        temperature=1.0, base_seed=0)
    hist = loop.run(6)
    rewards = [m["reward_mean"] for m in hist]
    assert rewards[-1] > rewards[0] + 0.1, rewards
    assert loop.publishes == 6 and all(m["published"] for m in hist)
    assert all(set(m) == JAX_KEYS for m in hist)
    fresh = ServeEngine(tb, merged_params(trainer, loop.state),
                        **{**ENGINE, "n_slots": 8})
    assert _tokens(engine, _reqs(temp=0.7)) == _tokens(fresh,
                                                       _reqs(temp=0.7))


def test_nan_update_gates_the_publish(models, monkeypatch):
    _, _, tb, _ = models
    monkeypatch.setenv("DTG_FAULT_NAN_LOSS_STEP", "1")
    trainer = Trainer(bundle=tb, optimizer=adamw_cosine(0.05),
                      guard_policy="skip", device="cpu")
    state = trainer.init_state(0)
    engine = ServeEngine(tb, merged_params(trainer, state), **ENGINE)
    loop = PostTrainingLoop(
        trainer, engine, ProgrammaticScorer(band_reward(64)),
        [[3, 10, 17]] * 2, state=state, max_new_tokens=6, temperature=1.0,
        base_seed=0, publish_every=2)
    m0 = loop.run_iteration()              # not a boundary
    good = {p: t.clone() for p, t in named_leaves(engine.params)}
    m1 = loop.run_iteration()              # NaN at the boundary: skipped
    assert all(torch.equal(t, good[p])
               for p, t in named_leaves(engine.params))
    m2 = loop.run_iteration()              # still due: publishes
    assert not m0["published"] and not m0["publish_skipped_nonfinite"]
    assert m1["publish_skipped_nonfinite"] and not m1["published"]
    assert m2["published"] and np.isfinite(m2["loss"])
    assert loop.publishes_skipped == 1 and engine.programs.publish_count == 1
    assert all(bool(torch.isfinite(t).all())
               for _, t in named_leaves(loop.state.params))


def _lora_loop(tb, mode, **kw):
    bundle = lora_bundle(tb, rank=4, targets=("wq", "wv"))
    trainer = Trainer(bundle=bundle, optimizer=adamw_cosine(0.1),
                      lora_only=True, guard_policy="skip", device="cpu")
    state = trainer.init_state(0)
    engine = ServeEngine(tb, merged_params(trainer, state), **ENGINE,
                         **({"max_adapters": 2, "adapter_rank": 4}
                            if mode == "adapter" else {}))
    return trainer, engine, state


def test_adapter_publish_rolls_out_what_the_merged_publish_does(models):
    _, _, tb, _ = models
    runs = {}
    for mode in ("merged", "adapter"):
        trainer, engine, state = _lora_loop(tb, mode)
        loop = PostTrainingLoop(
            trainer, engine, ProgrammaticScorer(band_reward(64)),
            [[3, 10, 17], [4, 11], [5, 5, 5], [6]], state=state,
            max_new_tokens=8, temperature=0.0, baseline="none",
            publish_mode=mode)
        hist = loop.run(3)
        runs[mode] = (loop, [m["reward_mean"] for m in hist])
    assert runs["adapter"][1] == runs["merged"][1]
    loop = runs["adapter"][0]
    assert loop.adapter_slot == 1 and loop.engine.stats()[
        "adapter_publishes"] == 3
    assert loop.engine.stats()["adapter_updates"] == 2
    with pytest.raises(ValueError, match="max_adapters"):
        trainer, engine, state = _lora_loop(tb, "merged")
        PostTrainingLoop(trainer, engine, ProgrammaticScorer(band_reward(8)),
                         [[3]], state=state, publish_mode="adapter")
    slot = publish_trained_adapter(loop.engine, loop.state, slot=1)
    assert slot == 1
    # a fleet target: a router over two replicas sharing the programs
    # (one pool takes the insert once), and a disaggregated pair
    from distributed_training_guide_tpu_torch.serve.disagg import \
        DisaggEngine
    from distributed_training_guide_tpu_torch.serve.router import (Replica,
                                                                   Router)
    twin = ServeEngine(tb, None, programs=loop.engine.programs, **ENGINE)
    fleet = Router([Replica("r0", loop.engine), Replica("r1", twin)])
    assert publish_trained_adapter(fleet, loop.state, slot=1) == 1
    pair = DisaggEngine(tb, None, programs=loop.engine.programs, **ENGINE)
    assert publish_trained_adapter(pair, loop.state, slot=1) == 1
    assert loop.engine.stats()["adapter_publishes"] == 6


def test_distill_lora_loop_descends_with_the_base_frozen(models):
    _, _, tb, _ = models
    trainer, engine, state = _lora_loop(tb, "merged")
    base0 = {p: t.clone() for p, t in named_leaves(state.params["base"])}
    loop = PostTrainingLoop(
        trainer, engine,
        TeacherScorer(tb, tb.init(tb.config, 7, device="cpu")),
        [[3 + (g * 7 + j) % 200 for j in range(3)] for g in range(12)],
        state=state, objective="distill_kl", max_new_tokens=10,
        temperature=1.0)
    losses = [m["loss"] for m in loop.run(4)]
    assert losses[-1] < losses[0], losses
    assert all(torch.equal(t, base0[p])
               for p, t in named_leaves(loop.state.params["base"]))
    with pytest.raises(ValueError, match="TeacherScorer"):
        PostTrainingLoop(trainer, engine,
                         ProgrammaticScorer(band_reward(8)), [[3]],
                         state=state, objective="distill_kl")
    with pytest.raises(ValueError, match="group"):
        PostTrainingLoop(trainer, engine,
                         ProgrammaticScorer(band_reward(8)), [[3], [4]],
                         state=state, baseline="group")


def test_cli_runs_and_refuses(tmp_path, capsys):
    assert main(["--iterations", "2", "--rollout-batch", "4",
                 "--max-new-tokens", "4", "--n-slots", "4", "--device",
                 "cpu", "--speculate", "ngram",
                 "--ledger", str(tmp_path / "led.jsonl")]) == 0
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["colocation_total_bytes"] > 0 and len(lines) == 3
    assert lines[0]["policy"].startswith("llama-debug+lora(r=8")
    for m in lines[1:]:
        assert set(m) == JAX_KEYS and m["published"]
        assert np.isfinite(m["loss"]) and m["rollout_tokens"] > 0
    assert main(["--iterations", "1", "--rollout-batch", "2", "--n-slots",
                 "2", "--max-new-tokens", "4", "--lora-rank", "0",
                 "--weight-dtype", "int8", "--objective", "distill_kl",
                 "--teacher-model", "llama-debug", "--device", "cpu"]) == 0
    with pytest.raises(ValueError, match="budget"):
        main(["--memory-budget-gb", "0.000001", "--device", "cpu"])
    with pytest.raises(SystemExit, match="divisible"):
        main(["--rollout-batch", "8", "--group-size", "3"])
    with pytest.raises(SystemExit, match="group-size"):
        main(["--baseline", "group"])
