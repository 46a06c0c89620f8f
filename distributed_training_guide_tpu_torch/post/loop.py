"""The on-policy post-training loop: rollout -> score -> update -> publish.

Counterpart of ``distributed_training_guide_tpu/post/loop.py``. One
iteration drives both runtimes of the package:

1. **Rollout**: the co-resident serve engine generates a batch of
   variable-length samples under the paged pool (K4 on the card;
   speculative decoding composes), reproducible per derived seed
   (``post/rollout.py``), ledgered as each sample completes.
2. **Score**: a pluggable scorer (``post/score.py``).
3. **Update**: the masked ragged post step (``train/step.py:
   make_post_step``): rollouts pack by ``group_sizes`` through the grouped
   GEMM (K5), prompt tokens masked, REINFORCE with a baseline or
   distillation KL behind the one ``post_loss``; LoRA (``lora_only``)
   keeps the update adapter-sized. The forward and backward run K1-K3.
4. **Publish**: the refreshed params land in the engine through
   ``ServeEngine.publish_params`` (the merged policy, copied leaf by leaf)
   or, in adapter mode, ``publish_adapter`` (the adapters into a pool slot,
   written in place). A NaN update never reaches the engine: the guard
   (``guard_policy="skip"``) leaves the state as it was and the loop GATES
   the publish on the step's ``notfinite`` flag; the boundary stays due,
   so the next finite step publishes.

``publish_every`` is the staleness knob; ``frozen=True`` runs rollout and
score only (the control loop).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from .rollout import RolloutLedger, generate_rollouts, pad_bucket
from .score import Scorer



def pack_rollouts(rollouts, scores, *, pad_to: int,
                  vocab_size: Optional[int] = None,
                  with_teacher: bool = False) -> dict:
    """Pack B ragged rollouts into the post step's fixed-shape batch:
    ``tokens [B, pad_to]`` (prompt + continuation, zero pad),
    ``prompt_lens`` / ``total_lens`` (the loss mask's raw material:
    ``group_sizes = total - prompt`` in the step), ``rewards``,
    ``group_ids``, and under ``with_teacher`` the ``teacher_logprobs [B,
    pad_to, V]`` scattered at SOURCE positions (row p = the teacher's
    distribution for predicting token p + 1). Numpy arrays, but the
    teacher's rows stay on the teacher's device when they are tensors."""
    b = len(rollouts)
    tokens = np.zeros((b, pad_to), np.int32)
    prompt_lens = np.zeros((b,), np.int32)
    total_lens = np.zeros((b,), np.int32)
    rewards = np.zeros((b,), np.float32)
    group_ids = np.zeros((b,), np.int32)
    teacher = None
    if with_teacher:
        if vocab_size is None:
            raise ValueError("with_teacher packing needs vocab_size")
        first = next((s.teacher_logprobs for s in scores
                      if isinstance(s.teacher_logprobs, torch.Tensor)), None)
        teacher = (np.zeros((b, pad_to, vocab_size), np.float32)
                   if first is None else
                   torch.zeros((b, pad_to, vocab_size), dtype=torch.float32,
                               device=first.device))
    for i, (r, s) in enumerate(zip(rollouts, scores)):
        seq = list(r.prompt_ids) + list(r.generated_ids)
        if len(seq) > pad_to:
            raise ValueError(
                f"rollout {i} is {len(seq)} tokens but the packed batch "
                f"is {pad_to} wide — size pad_to to prompt+max_new")
        tokens[i, :len(seq)] = seq
        prompt_lens[i] = len(r.prompt_ids)
        total_lens[i] = len(seq)
        rewards[i] = s.reward
        group_ids[i] = r.group_id
        if with_teacher:
            if s.teacher_logprobs is None:
                raise ValueError(
                    f"rollout {i} has no teacher_logprobs — the "
                    f"distill_kl objective needs a teacher-providing "
                    f"scorer (TeacherScorer)")
            g = len(r.generated_ids)
            pl = len(r.prompt_ids)
            rows = s.teacher_logprobs
            if isinstance(teacher, torch.Tensor):
                rows = torch.as_tensor(rows).to(teacher.device)
            teacher[i, pl - 1:pl - 1 + g] = rows
    out = {"tokens": tokens, "prompt_lens": prompt_lens,
           "total_lens": total_lens, "rewards": rewards,
           "group_ids": group_ids}
    if with_teacher:
        out["teacher_logprobs"] = teacher
    return out


def _sync(engine) -> None:
    """Wait for the card, so a host-clock time covers the work."""
    dev = getattr(engine, "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


class PostTrainingLoop:
    """Drives rollout -> score -> update -> publish against a Trainer and a
    live serve engine that SHARE the policy.

    The caller builds the engine from the trainer state's MERGED params
    (``merged_params(trainer, state)``) so iteration 0's rollouts run the
    step-0 policy; after every update the loop merges (one merge function
    for LoRA bundles) and publishes. ``state`` is the TrainState the
    updates thread through; ``ledger`` makes rollout batches
    crash-recoverable. ``frozen=True`` disables update AND publish.
    """

    def __init__(self, trainer, engine, scorer: Scorer,
                 prompts: Sequence, *, state,
                 objective: str = "reinforce", baseline: str = "batch",
                 max_new_tokens: int = 16, temperature: float = 0.7,
                 top_k: int = 0, top_p: float = 1.0, base_seed: int = 0,
                 publish_every: int = 1, publish_mode: str = "merged",
                 ledger: Optional[RolloutLedger] = None,
                 group_ids=None, frozen: bool = False,
                 gmm_impl: str = "auto"):
        from ..train.step import make_post_step

        self.trainer = trainer
        self.engine = engine
        self.scorer = scorer
        self.prompts = [list(p) for p in prompts]
        self.state = state
        self.objective = objective
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k, self.top_p = top_k, top_p
        self.base_seed = base_seed
        self.publish_every = publish_every
        if publish_mode not in ("merged", "adapter"):
            raise ValueError(f"publish_mode must be 'merged' or "
                             f"'adapter', got {publish_mode!r}")
        if publish_mode == "adapter" and not frozen:
            # at construction, not at the first publish boundary: adapter
            # mode needs a LoRA-shaped state AND a pooled engine
            adapter_payload(state.params)
            if getattr(engine, "adapter_pool", None) is None:
                raise ValueError(
                    "publish_mode='adapter' needs an engine built with "
                    "max_adapters= (an adapter pool to insert into)")
        self.publish_mode = publish_mode
        # the tenant's pool slot, allocated by the first boundary publish
        # and republished in place after it. Iteration 0 rolls out on
        # adapter 0 (the base), the merged policy's equal because LoRA's B
        # starts at zero
        self.adapter_slot: Optional[int] = None
        self.ledger = ledger
        self.group_ids = group_ids
        self.frozen = frozen
        self._needs_teacher = objective == "distill_kl"
        if self._needs_teacher and not scorer.provides_teacher_logprobs:
            raise ValueError(
                f"objective='distill_kl' needs a scorer that provides "
                f"teacher logprobs (TeacherScorer); "
                f"{type(scorer).__name__} does not")
        if baseline == "group":
            gids = list(group_ids) if group_ids is not None else []
            if not gids or max(gids.count(g) for g in set(gids)) < 2:
                raise ValueError(
                    "baseline='group' needs group_ids with at least one "
                    "group of >= 2 rollouts: singleton groups (the "
                    "default group_id=index) make every advantage "
                    "(r - mean_g)/std_g exactly zero, so the loop would "
                    "train nothing while looking busy — repeat each "
                    "prompt group-size times and tag the copies")
        self.pad_to = pad_bucket(max(len(p) for p in self.prompts)
                                 + max_new_tokens)
        self._merge = merge_fn(trainer.bundle)
        self.post_step = None if frozen else make_post_step(
            trainer, objective=objective, baseline=baseline,
            gmm_impl=gmm_impl)
        self.iteration = 0
        self.publishes = 0
        self.publishes_skipped = 0
        self._publish_due = False
        self.history: list = []

    def run_iteration(self) -> dict:
        """One rollout -> score -> update -> publish pass. Returns (and
        appends to ``history``) the iteration's metric dict, the JAX
        loop's keys."""
        i = self.iteration
        rollouts, rstats = generate_rollouts(
            self.engine, self.prompts, iteration=i,
            base_seed=self.base_seed, max_new_tokens=self.max_new_tokens,
            temperature=self.temperature, top_k=self.top_k,
            top_p=self.top_p, group_ids=self.group_ids,
            ledger=self.ledger,
            adapter_id=(self.adapter_slot or 0))
        scores = self.scorer.score(rollouts)
        metrics = {"iteration": i, **rstats,
                   "reward_mean": float(np.mean([s.reward
                                                 for s in scores])),
                   "publish_ms": 0.0, "published": False,
                   "publish_skipped_nonfinite": False,
                   "step_s": 0.0}
        if not self.frozen:
            batch = pack_rollouts(
                rollouts, scores, pad_to=self.pad_to,
                vocab_size=self.trainer.bundle.config.vocab_size,
                with_teacher=self._needs_teacher)
            t0 = time.perf_counter()
            self.state, m = self.post_step(self.state, batch)
            m = {k: float(v) for k, v in m.items()}
            metrics["step_s"] = round(time.perf_counter() - t0, 4)
            metrics.update(loss=m["loss"], grad_norm=m["grad_norm"],
                           post_tokens=m["post_tokens"],
                           post_logprob_mean=m["post_logprob_mean"])
            # a NaN / Inf update must not poison the publishing engine:
            # under guard_policy="skip" the step left the state as it was,
            # and gating here keeps the engine on the last GOOD policy. A
            # skipped boundary stays DUE: the next finite step publishes
            nonfinite = m.get("notfinite", 0.0) > 0.0
            if (self.publish_every
                    and (i + 1) % self.publish_every == 0):
                self._publish_due = True
            if nonfinite:
                if self._publish_due:
                    self.publishes_skipped += 1
                    metrics["publish_skipped_nonfinite"] = True
            elif self._publish_due:
                t0 = time.perf_counter()
                if self.publish_mode == "adapter":
                    # adapter-sized publish: insert (then republish in
                    # place) the trained factors as a pool tenant; base
                    # traffic keeps adapter 0
                    self.adapter_slot = self.engine.publish_adapter(
                        adapter_payload(self.state.params),
                        name="post-policy", slot=self.adapter_slot)
                else:
                    self.engine.publish_params(
                        self._merge(self.state.params))
                _sync(self.engine)
                metrics["publish_ms"] = round(
                    1000 * (time.perf_counter() - t0), 2)
                metrics["published"] = True
                self.publishes += 1
                self._publish_due = False
        self.iteration += 1
        self.history.append(metrics)
        return metrics

    def run(self, n_iterations: int) -> list:
        """``n_iterations`` full passes; returns their history."""
        for _ in range(n_iterations):
            self.run_iteration()
        return self.history[len(self.history) - n_iterations:]


def adapter_payload(params) -> dict:
    """The trained LoRA factors in the layout the serve plane's adapter
    pool ingests (``{target: {"a": [L, in, r], "b": [L, r, out]}}``: the
    ``params["lora"]`` subtree, no reshaping). Raises when the state has no
    LoRA subtree: a dense policy publishes merged weights
    (``publish_params``)."""
    if not isinstance(params, dict) or "lora" not in params:
        raise ValueError(
            "state.params has no 'lora' subtree — adapter publishing "
            "needs a lora_bundle-wrapped trainer (dense policies "
            "publish merged weights via publish_params)")
    return params["lora"]


def publish_trained_adapter(target, state, *, name=None, slot=None,
                            force: bool = False) -> int:
    """Publish a trainer state's LoRA adapter into a serving target's
    adapter pool (one slot's leaves, never the base). ``target`` is a
    ``ServeEngine``, a ``DisaggEngine`` or a fleet ``Router`` (the same
    ``publish_adapter`` on all three; the router's is fleet-wide and
    all-or-nothing). Returns the slot the tenant landed in (pass it back
    as ``slot=`` to republish in place)."""
    return target.publish_adapter(adapter_payload(state.params),
                                  name=name, slot=slot, force=force)


def merge_fn(bundle):
    """params -> engine-layout params for the PUBLISH path: the LoRA merge
    (``models/lora.py:jit_merge``, built once) for wrapped bundles, the
    identity otherwise; ``ModelPrograms.publish_params`` copies the
    incoming leaves itself. Engine CONSTRUCTION must not use the identity
    (``merged_params`` copies: the trainer updates its tensors in
    place)."""
    if getattr(bundle, "lora_base", None) is not None:
        from ..models.lora import jit_merge

        return jit_merge(bundle)
    return lambda params: params


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def merged_params(trainer, state):
    """The CURRENT policy in the serve engine's (base) layout, in tensors
    the ENGINE will own: what a co-resident engine is built from, so
    rollout 0 runs the initial policy and the trainer's in-place updates
    never reach it."""
    with torch.no_grad():
        return _clone(merge_fn(trainer.bundle)(state.params))


def qlora_base(base_params, *, family: str = "llama"):
    """The QLoRA frozen-base snap (arXiv:2305.14314): round the base
    params onto the serve plane's int8 grid (quantize -> dequantize of
    exactly the leaves ``serve/weights.py`` quantizes, block size and
    all) BEFORE wrapping with ``lora_bundle``. The ``lora_only`` trainer
    then computes gradients against the base an ``weight_dtype='int8'``
    engine dequantizes (block quantization is idempotent on a snapped
    base), and ``publish_params`` re-quantizes every merged publish. Norms
    and biases pass through."""
    from ..serve.weights import store_weights
    from ..train.precision import dequantize_blockwise

    snapped = store_weights(base_params, "int8", family=family)

    def snap(orig, s):
        if isinstance(orig, dict):
            return {k: snap(orig[k], s[k]) for k in orig}
        if hasattr(s, "q") and hasattr(s, "scale"):
            return dequantize_blockwise(s, dtype=orig.dtype)
        return s

    with torch.no_grad():
        return snap(base_params, snapped)
