"""Pluggable rollout scorers: programmatic rewards, reward-model
forwards, and teacher-logit distillation.

Counterpart of ``distributed_training_guide_tpu/post/score.py``. One
interface (``Scorer.score(rollouts) -> [Score]``) behind three reward
shapes:

- ``ProgrammaticScorer``: a host function of (prompt_ids, generated_ids),
  the synthetic-preference tasks (``match_reward``, ``band_reward``) and
  the shape rule-based rewards take (host code, copied).
- ``RewardModelScorer``: a model forward as the reward, the mean
  log-probability the scoring model assigns to the sampled continuation.
  The scoring model is a ``ModelPrograms`` (the live params of a resident
  engine, no second copy) or a (bundle, params) pair.
- ``TeacherScorer``: the teacher's full-vocab log-probs at every
  continuation position, for the ``distill_kl`` objective, and its mean
  token log-prob as the scalar reward.

The model scorers run the family's ``apply`` under ``torch.no_grad`` on
a batch padded to a power of two (``pad_bucket``), with an fp32
log-softmax; on the card that forward runs the flash-attention kernel
K1. The teacher's rows stay tensors on the model's device, so the
distillation batch is packed there (``post/loop.py:pack_rollouts``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .rollout import Rollout, pad_bucket


@dataclasses.dataclass
class Score:
    """One rollout's score: always a scalar reward; teacher scorers add
    per-continuation-token full-vocab log-probs [len(generated), V] (a
    tensor on the teacher's device, or an array)."""
    reward: float
    teacher_logprobs: Optional[object] = None


class Scorer:
    """Interface: ``score(rollouts)`` returns one ``Score`` per rollout,
    in order. ``provides_teacher_logprobs`` advertises whether the
    ``distill_kl`` objective can run on this scorer's output."""

    provides_teacher_logprobs = False

    def score(self, rollouts: Sequence[Rollout]) -> list:
        raise NotImplementedError


class ProgrammaticScorer(Scorer):
    """Reward = ``fn(prompt_ids, generated_ids) -> float``."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def score(self, rollouts):
        return [Score(reward=float(self.fn(r.prompt_ids, r.generated_ids)))
                for r in rollouts]


def match_reward(target_id: int):
    """Sparse synthetic preference: reward = fraction of generated tokens
    equal to ``target_id`` (~1/vocab at init: a hard exploration task;
    ``band_reward`` is the dense variant)."""
    def fn(prompt_ids, generated_ids):
        if not generated_ids:
            return 0.0
        return sum(1 for t in generated_ids if t == target_id) \
            / len(generated_ids)
    return fn


def band_reward(max_id: int):
    """The DENSE synthetic preference task: reward = fraction of generated
    tokens with id < ``max_id``. At a random init the rate is ~max_id /
    vocab, so every rollout carries signal and REINFORCE with a baseline
    moves the reward within a few iterations on a debug model; a loop that
    trains but never publishes plateaus (rollouts keep sampling the old
    policy)."""
    def fn(prompt_ids, generated_ids):
        if not generated_ids:
            return 0.0
        return sum(1 for t in generated_ids if t < max_id) \
            / len(generated_ids)
    return fn


class _ModelForward:
    """Shared machinery of the model-backed scorers: tokens -> per-position
    fp32 log-probs through the family's ``apply``, against a
    ModelPrograms' live params (or a raw bundle and params)."""

    def __init__(self, model, params=None):
        if params is None:      # a ModelPrograms: score the LIVE params
            # hold the programs object, not a snapshot of .params: a
            # publish rebinds ModelPrograms.params
            self._programs = model
            self.bundle = model.bundle
        else:
            self._programs = None
            self.bundle = model
            self._static_params = params
        self.config = self.bundle.config

    @property
    def params(self):
        return (self._programs.params if self._programs is not None
                else self._static_params)

    def _device(self) -> torch.device:
        from ..train.state import named_leaves

        leaf = next(t for _, t in named_leaves(self.params))
        return getattr(leaf, "q", leaf).device

    @torch.no_grad()
    def token_logprobs(self, rollouts):
        """Per-rollout (token_lp [g] numpy, full_lp [g, V] tensor): the
        scoring model's log-prob of each SAMPLED continuation token, and
        its full distribution at that token's source position."""
        lens = [len(r.prompt_ids) + len(r.generated_ids) for r in rollouts]
        s = pad_bucket(max(lens))
        tokens = np.zeros((len(rollouts), s), np.int64)
        for i, r in enumerate(rollouts):
            seq = list(r.prompt_ids) + list(r.generated_ids)
            tokens[i, :len(seq)] = seq
        dev = self._device()
        logits = self.bundle.apply(self.config, self.params,
                                   torch.as_tensor(tokens, device=dev))
        logp = torch.log_softmax(logits.float(), dim=-1)     # [B, S, V]
        out = []
        for i, r in enumerate(rollouts):
            pl, g = len(r.prompt_ids), len(r.generated_ids)
            # source position pl-1+j predicts generated token j
            rows = logp[i, pl - 1:pl - 1 + g]                # [g, V]
            ids = torch.as_tensor(list(r.generated_ids), dtype=torch.int64,
                                  device=dev)
            tok = (rows[torch.arange(g, device=dev), ids].cpu().numpy()
                   if g else np.zeros((0,), np.float32))
            out.append((tok, rows))
        return out


class RewardModelScorer(Scorer):
    """Sequence-level likelihood reward: the mean log-prob the scoring
    model assigns to the sampled continuation. ``model`` is a
    ``ModelPrograms`` (params shared with a resident engine) or a bundle
    with explicit ``params``."""

    def __init__(self, model, params=None):
        self._fwd = _ModelForward(model, params)

    def score(self, rollouts):
        return [Score(reward=float(tok.mean()) if len(tok) else 0.0)
                for tok, _ in self._fwd.token_logprobs(rollouts)]


class TeacherScorer(Scorer):
    """Distillation scoring: full-vocab teacher log-probs per continuation
    position (the ``distill_kl`` objective's data), plus the teacher's
    mean token log-prob as the scalar reward."""

    provides_teacher_logprobs = True

    def __init__(self, model, params=None):
        self._fwd = _ModelForward(model, params)

    def score(self, rollouts):
        return [Score(reward=float(tok.mean()) if len(tok) else 0.0,
                      teacher_logprobs=rows)
                for tok, rows in self._fwd.token_logprobs(rollouts)]
