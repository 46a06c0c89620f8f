"""Rollout generation: the trainer-driven side of the serve engine.

Counterpart of ``distributed_training_guide_tpu/post/rollout.py`` (host
code, copied). Every rollout carries a seed that is a pure function of
``(base_seed, iteration, sample index)``, and the engine samples token t
from a pure function of (seed, absolute position) (``serve/engine.py``:
the port keeps the JAX package's sampling contract, not its bits), so a
rollout's tokens are a pure function of (weights, prompt, seed): the same
seed and the same publish schedule give token-identical rollouts across
engine restarts, admission order, co-residents and speculation. Greedy
rollouts are token-identical to the JAX package's.

The **rollout ledger** is the crash-recovery half: each completed sample
appends one fsynced JSONL line as it finishes, so an engine killed
mid-batch loses only its in-flight sequences. On resume the loop reads
the ledger and generates ONLY the missing samples (each (iteration,
index) pair exactly once); with derived seeds the regenerated samples
are bitwise the ones the dead engine would have produced.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Optional

from ..serve.scheduler import Request


@dataclasses.dataclass
class Rollout:
    """One completed policy sample: the unit the scorer and the packed
    update step consume, and the unit the ledger records."""
    iteration: int
    index: int                      # sample index within the iteration
    prompt_ids: list
    generated_ids: list
    seed: int
    finish_reason: str
    group_id: int = 0               # prompt group (GRPO group baseline)

    def to_json(self) -> dict:
        return {"iteration": self.iteration, "index": self.index,
                "prompt_ids": list(map(int, self.prompt_ids)),
                "generated_ids": list(map(int, self.generated_ids)),
                "seed": int(self.seed),
                "finish_reason": self.finish_reason,
                "group_id": int(self.group_id)}

    @classmethod
    def from_json(cls, d: dict) -> "Rollout":
        return cls(iteration=d["iteration"], index=d["index"],
                   prompt_ids=d["prompt_ids"],
                   generated_ids=d["generated_ids"], seed=d["seed"],
                   finish_reason=d["finish_reason"],
                   group_id=d.get("group_id", 0))


def pad_bucket(n: int, lo: int = 16) -> int:
    """Power-of-two padded length — ONE helper for the packed update
    batch (post/loop.py) and the scorer forwards (post/score.py), so
    the two pads cannot silently diverge."""
    b = lo
    while b < n:
        b *= 2
    return b


def rollout_seed(base_seed: int, iteration: int, index: int) -> int:
    """Deterministic per-sample seed — a pure int function so the seed
    survives process restarts (no RNG state to lose). Mixed over distinct
    primes so (iteration, index) collisions need ~2^31 samples."""
    return (int(base_seed) * 1_000_003 + int(iteration) * 8_191
            + int(index) * 127 + 1) % (2 ** 31 - 1)


class RolloutLedger:
    """Crash-safe completed-rollout record (append-only JSONL).

    ``record`` appends + flushes + fsyncs ONE line per completed sample —
    the durability point is the sample, not the batch, so a crash loses
    at most in-flight sequences. ``completed(iteration)`` returns what
    already finished; a torn trailing line (crash mid-write) parses as
    garbage and is skipped, never fatal. The ledger is also the loop's
    restart cursor: ``last_iteration()`` tells a resumed loop where the
    schedule stood."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # incremental parse cache: ``completed`` runs once per loop
        # iteration, and re-parsing the WHOLE file each time is O(n^2)
        # over a long ledgered run — only bytes past ``_parsed_to`` are
        # read; a complete line is consumed once, ever
        self._parsed: list = []
        self._parsed_to = 0

    def record(self, rollout: Rollout) -> None:
        line = json.dumps(rollout.to_json(), separators=(",", ":"))
        with open(self.path, "a") as fp:
            fp.write(line + "\n")
            fp.flush()
            os.fsync(fp.fileno())

    def _lines(self) -> list:
        if not self.path.exists():
            return []
        size = os.path.getsize(self.path)
        if size < self._parsed_to:          # file replaced/truncated
            self._parsed, self._parsed_to = [], 0
        if size > self._parsed_to:
            with open(self.path, "rb") as fp:
                fp.seek(self._parsed_to)
                chunk = fp.read()
            # consume only COMPLETE lines; a torn trailing fragment (a
            # crash mid-write, no newline yet) stays unconsumed — if the
            # next record() glues onto it the merged line parses as
            # garbage and is skipped, never fatal (the missing sample
            # regenerates; later duplicates win in ``completed``)
            end = chunk.rfind(b"\n") + 1
            for raw in chunk[:end].splitlines():
                try:
                    self._parsed.append(json.loads(raw))
                except json.JSONDecodeError:
                    continue
            self._parsed_to += end
        return self._parsed

    def completed(self, iteration: int) -> dict:
        """index -> Rollout for every sample of ``iteration`` already on
        disk. Later duplicates win (there are none unless a caller
        replays history; exactly-once generation relies on this map, not
        on the file being duplicate-free)."""
        return {d["index"]: Rollout.from_json(d)
                for d in self._lines() if d["iteration"] == iteration}

    def last_iteration(self) -> int:
        """Highest iteration with any completed sample (-1 = empty)."""
        return max((d["iteration"] for d in self._lines()), default=-1)


def generate_rollouts(engine, prompts, *, iteration: int, base_seed: int,
                      max_new_tokens: int, temperature: float = 0.7,
                      top_k: int = 0, top_p: float = 1.0,
                      group_ids=None, eos_id: Optional[int] = None,
                      ledger: Optional[RolloutLedger] = None,
                      max_iterations: Optional[int] = 20000,
                      adapter_id: int = 0) -> tuple:
    """One rollout batch through the serve engine: submit every sample
    of ``iteration`` not already in the ledger, step the engine to
    completion, and return ``(rollouts in index order, stats)``.

    Samples record to the ledger AS THEY FINISH, so a crash between two
    ``engine.step()`` calls is recoverable by calling this again with a
    fresh engine (same weights — the publish schedule is the caller's
    contract) and the same ledger: completed indices are skipped, missing
    ones regenerate bitwise (derived seeds + position-keyed sampling).

    ``stats``: generated token count, wall seconds, tokens/s — the
    rollout-throughput numbers the bench rung records."""
    done = ledger.completed(iteration) if ledger is not None else {}
    resumed_idx = frozenset(done)
    pending: dict[int, int] = {}
    t0 = time.perf_counter()
    for idx, prompt in enumerate(prompts):
        if idx in done:
            continue
        rid = engine.submit(Request(
            prompt_ids=list(prompt), max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_id=eos_id, seed=rollout_seed(base_seed, iteration, idx),
            adapter_id=adapter_id))
        pending[rid] = idx
    iters = 0
    while pending:
        for res in engine.step():
            idx = pending.pop(res.request_id, None)
            if idx is None:
                continue            # a pre-crash stray finishing late
            rollout = Rollout(
                iteration=iteration, index=idx,
                prompt_ids=list(prompts[idx]),
                generated_ids=list(res.generated_ids),
                seed=rollout_seed(base_seed, iteration, idx),
                finish_reason=res.finish_reason,
                group_id=int(group_ids[idx]) if group_ids is not None
                else idx)
            if ledger is not None:
                ledger.record(rollout)
            done[idx] = rollout
        iters += 1
        if max_iterations is not None and iters > max_iterations:
            raise RuntimeError(
                f"rollout batch exceeded {max_iterations} engine "
                f"iterations with {len(pending)} samples unfinished — "
                f"scheduler stall, not load")
    wall = time.perf_counter() - t0
    rollouts = [done[i] for i in range(len(prompts))]
    # throughput counts only tokens THIS call generated — resumed
    # samples came off the ledger, and counting them would report a
    # resumed iteration at millions of tok/s (poisoning every bench
    # mean the number lands in)
    gen = sum(len(r.generated_ids) for i, r in enumerate(rollouts)
              if i not in resumed_idx)
    stats = {"rollout_tokens": gen,
             "rollout_wall_s": round(wall, 4),
             "rollout_tokens_per_s": round(gen / wall, 2) if wall else 0.0,
             # samples already on disk when this call started (generated
             # by a previous incarnation — the no-double-count meter)
             "resumed_from_ledger": len(resumed_idx)}
    return rollouts, stats
