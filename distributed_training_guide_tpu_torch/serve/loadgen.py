"""Open-loop load generation for the serving fleet: goodput under real
traffic shapes.

Counterpart of ``distributed_training_guide_tpu/serve/loadgen.py`` (host
Python, the same code; the same seed gives the same schedule). Requests
are issued on a wall-clock arrival schedule and the loop NEVER waits
on a completion to issue the next one, so the interesting regime
(arrivals outrunning service, queues growing, deadlines expiring) is
reachable.

The headline metric is **goodput**: requests completed within their
``deadline_s`` per second of wall time (DistServe, arXiv:2401.09670).
Alongside it: p50/p99 TTFT and per-token ITL tails, refusal and
spillover rates, deadline misses by reason.

Arrivals: Poisson (exponential gaps, deterministic per seed) and explicit
traces; ``DTG_FAULT_ARRIVAL_BURST`` multiplies the rate over a window.
Scenario profiles: chat turns sharing a system prompt, long prompt /
short answer, short prompt / long generation, and priority / deadline
mixes. The loop steps the engine (or the fleet router) inline in one
thread; ``serve/controller.py`` plugs in through ``controller=``.
CLI: ``python -m distributed_training_guide_tpu_torch.serve.loadgen``.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional

from ..utils import faults
from .scheduler import RefusalError, Request

#: finish_reasons that count as a COMPLETION (the request got its full
#: answer); everything else — deadline, resubmit_exhausted,
#: shrink_evicted — is a structured non-answer.
COMPLETED_REASONS = ("eos", "length")


# ---- arrival schedules -----------------------------------------------------
def poisson_arrivals(rate_rps: float, duration_s: float, *,
                     seed: int = 0) -> list[float]:
    """Arrival offsets (seconds from trace start) for a Poisson process
    at ``rate_rps`` over ``duration_s`` — exponential inter-arrival gaps
    from a private RNG, so the trace is a pure function of (rate,
    duration, seed, burst fault). The ``DTG_FAULT_ARRIVAL_BURST``
    window multiplies the instantaneous rate (each gap is drawn at the
    rate in effect at its start — window-edge granularity is one gap,
    plenty for drills)."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    rng = random.Random(seed)
    t, out = 0.0, []
    while True:
        rate = rate_rps * faults.arrival_burst(t)
        if rate <= 0:
            # a zero-rate window is a traffic blackout: skip to its end
            burst = faults.active_faults().arrival_burst
            t = burst[2] if burst is not None else duration_s
            if t >= duration_s:
                return out
            continue
        t += rng.expovariate(rate)
        if t >= duration_s:
            return out
        out.append(t)


def trace_arrivals(offsets) -> list[float]:
    """An explicit arrival trace: recorded production offsets, or a
    hand-built adversarial one. Sorted (open-loop submission needs
    monotone time), negatives rejected."""
    out = sorted(float(t) for t in offsets)
    if out and out[0] < 0:
        raise ValueError(f"arrival offsets must be >= 0, got {out[0]}")
    return out


# ---- scenario profiles -----------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Scenario:
    """One traffic profile: how a request from this class looks.
    ``prompt_len`` / ``max_new_tokens`` are inclusive (lo, hi) ranges
    sampled per request; ``shared_prefix`` is prepended VERBATIM to
    every prompt (the chat profile's system prompt — page-aligned
    lengths hit the prefix cache and the router's affinity key).
    ``priority``/``deadline_s`` ride straight onto the Request.
    ``adapter_ids``/``adapter_weights`` make the profile multi-tenant:
    each request draws its LoRA pool slot by weight (empty = all base
    traffic on adapter 0)."""

    name: str
    prompt_len: tuple[int, int]
    max_new_tokens: tuple[int, int]
    shared_prefix: tuple = ()
    priority: int = 0
    deadline_s: Optional[float] = None
    temperature: float = 0.0
    weight: float = 1.0
    adapter_ids: tuple = ()
    adapter_weights: tuple = ()

    def sample(self, rng: random.Random, vocab: int, index: int) -> Request:
        n_prompt = rng.randint(*self.prompt_len)
        n_gen = rng.randint(*self.max_new_tokens)
        prompt = list(self.shared_prefix) + [
            rng.randrange(1, vocab) for _ in range(n_prompt)]
        adapter = 0
        if self.adapter_ids:
            adapter = rng.choices(
                self.adapter_ids,
                weights=self.adapter_weights or None, k=1)[0]
        return Request(prompt_ids=prompt, max_new_tokens=n_gen,
                       temperature=self.temperature,
                       seed=index, priority=self.priority,
                       deadline_s=self.deadline_s,
                       adapter_id=int(adapter))


def default_scenarios(*, max_len: int, page_size: int, vocab: int,
                      deadline_s: Optional[float] = None,
                      seed: int = 0) -> list[Scenario]:
    """The four canonical profiles, sized to fit ``max_len`` (worst case
    prompt + generation always submits cleanly — refusals in a sweep
    should be BACKPRESSURE, not bad requests). ``deadline_s`` scales
    each profile's deadline (None disables deadlines entirely — pure
    latency measurement)."""
    rng = random.Random(seed ^ 0x5C0FFEE)
    budget = max(8, max_len)
    # system prompt: one full page, so every chat turn shares it through
    # the prefix cache and hashes to the same affinity target
    sys_prompt = tuple(rng.randrange(1, vocab)
                       for _ in range(min(page_size, budget // 4)))
    qtr = max(2, budget // 4)

    def dl(mult: float) -> Optional[float]:
        return None if deadline_s is None else round(deadline_s * mult, 3)

    return [
        Scenario("chat", prompt_len=(2, max(2, qtr - len(sys_prompt))),
                 max_new_tokens=(2, qtr), shared_prefix=sys_prompt,
                 priority=1, deadline_s=dl(1.0), weight=4.0),
        Scenario("long_prompt", prompt_len=(qtr, 2 * qtr),
                 max_new_tokens=(1, max(1, qtr // 2)),
                 deadline_s=dl(1.5), weight=2.0),
        Scenario("long_gen", prompt_len=(2, qtr),
                 max_new_tokens=(qtr, 2 * qtr),
                 deadline_s=dl(2.0), weight=2.0),
        # the priority mix: urgent interactive traffic with a tight
        # deadline, and background batch work the shed ladder may refuse
        Scenario("urgent", prompt_len=(2, qtr), max_new_tokens=(2, qtr),
                 priority=2, deadline_s=dl(0.5), weight=1.0),
        Scenario("batch", prompt_len=(2, qtr), max_new_tokens=(2, qtr),
                 priority=0, deadline_s=dl(4.0), weight=1.0),
    ]


def zipf_weights(n: int, s: float = 1.1) -> list[float]:
    """Normalized Zipf pmf over ranks 1..n (weight of rank k is
    1/k^s): the canonical multi-tenant popularity curve — a few hot
    adapters dominate, a long tail stays resident but rarely batched.
    S-LoRA and Punica both benchmark against exactly this shape."""
    if n < 1:
        raise ValueError(f"need n >= 1 adapters, got {n}")
    raw = [1.0 / (k ** s) for k in range(1, n + 1)]
    total = sum(raw)
    return [w / total for w in raw]


def adapter_mix_scenario(*, max_len: int, n_adapters: int,
                         zipf_s: float = 1.1, base_share: float = 0.2,
                         deadline_s: Optional[float] = None,
                         weight: float = 4.0,
                         name: str = "adapter_mix") -> Scenario:
    """The multi-tenant profile: every arrival (the Poisson schedule is
    unchanged — tenancy shapes WHICH adapter, not WHEN) draws a pool
    slot Zipf-weighted by slot rank, slot 1 hottest. ``base_share`` of
    the traffic stays on adapter 0 (the base model — real fleets serve
    both). Drive it against an engine whose pool has slots 1..n_adapters
    published; an unpublished slot refuses at submit, which is itself a
    measurable failure mode (refused_by_reason['unknown_adapter'])."""
    if not 0.0 <= base_share < 1.0:
        raise ValueError(f"base_share must be in [0, 1), got {base_share}")
    qtr = max(2, max(8, max_len) // 4)
    ids = list(range(1, n_adapters + 1))
    weights = [w * (1.0 - base_share) for w in zipf_weights(n_adapters,
                                                            zipf_s)]
    if base_share > 0:
        ids = [0] + ids
        weights = [base_share] + weights
    return Scenario(name, prompt_len=(2, qtr), max_new_tokens=(2, qtr),
                    deadline_s=deadline_s, weight=weight,
                    adapter_ids=tuple(ids),
                    adapter_weights=tuple(weights))


def build_schedule(arrivals: list[float], scenarios: list[Scenario], *,
                   vocab: int, seed: int = 0) \
        -> list[tuple[float, Request]]:
    """Zip an arrival schedule with scenario-sampled requests: each
    arrival draws a scenario by weight, then samples a request from it.
    Deterministic in (arrivals, scenarios, vocab, seed) — the SAME
    schedule replays against different fleet configurations, which is
    what makes A/B rungs honest."""
    rng = random.Random(seed)
    weights = [s.weight for s in scenarios]
    out = []
    for i, t in enumerate(arrivals):
        scenario = rng.choices(scenarios, weights=weights, k=1)[0]
        out.append((t, scenario.sample(rng, vocab, i)))
    return out


# ---- the open loop ----------------------------------------------------------
@dataclasses.dataclass
class LoadReport:
    """What one open-loop run measured. Counts are requests; the tails
    are seconds. ``goodput_rps`` is THE number: deadline-met completions
    per wall second (a request with no deadline counts as met when it
    completes)."""

    offered: int = 0
    submitted: int = 0
    refused: int = 0
    completed: int = 0
    deadline_met: int = 0
    deadline_missed: int = 0
    resubmit_exhausted: int = 0
    other_failed: int = 0
    wall_s: float = 0.0
    goodput_rps: float = 0.0
    offered_rps: float = 0.0
    ttft_p50_s: float = 0.0
    ttft_p99_s: float = 0.0
    itl_p50_s: float = 0.0
    itl_p99_s: float = 0.0
    # per-token tap accounting (run_open_loop stamps every token the
    # moment its stream first shows it): ``itl_samples`` counts the
    # measured inter-token gaps behind the ITL tails, and
    # ``token_burst_max`` is the largest single-tap token batch any one
    # request emitted — under a K-step decode horizon this reads K, and
    # the p99 ITL reads the K·step burst a per-request MEAN would hide
    itl_samples: int = 0
    token_burst_max: int = 0
    refusal_rate: float = 0.0
    refused_by_reason: dict = dataclasses.field(default_factory=dict)
    spillovers: int = 0
    timed_out: bool = False
    iterations: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) — no numpy dependency, and
    nearest-rank never invents a value that wasn't measured."""
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return float(ordered[idx])


def summarize(schedule, results, refusals, wall_s, *,
              engine_stats: Optional[dict] = None,
              timed_out: bool = False, iterations: int = 0,
              itl_gaps: Optional[list] = None,
              token_burst_max: int = 0) -> LoadReport:
    """Fold the loop's raw output into a LoadReport. ``results`` maps
    request id -> RequestResult, ``refusals`` is [(offset, reason)].
    TTFT reads the RequestResult accounting directly — measured from
    FIRST client submit even across resubmission hops (the router
    threads the original timestamp through). ITL comes from
    ``itl_gaps`` — the per-token tap timestamps run_open_loop records —
    when provided; the RequestResult per-request MEAN is only the
    fallback for callers with no tap stream. The distinction is the
    honest-ITL satellite: a fused K-step horizon leaves the mean
    untouched while every K-th gap is K·step — only per-token samples
    put that burst into p99."""
    rep = LoadReport(offered=len(schedule),
                     submitted=len(schedule) - len(refusals),
                     refused=len(refusals), wall_s=round(wall_s, 4),
                     timed_out=timed_out, iterations=iterations)
    ttfts, itls = [], []
    for res in results.values():
        if res.finish_reason in COMPLETED_REASONS:
            rep.completed += 1
        elif res.finish_reason == "deadline":
            rep.deadline_missed += 1
        elif res.finish_reason == "resubmit_exhausted":
            rep.resubmit_exhausted += 1
        else:
            rep.other_failed += 1
        if res.first_token_at:
            ttfts.append(res.ttft_s)
        if len(res.generated_ids) > 1 and res.first_token_at:
            itls.append(res.itl_s)
    # a completed request MET its deadline by construction: the engine
    # evicts past-deadline work at every iteration boundary, so nothing
    # finishes "eos"/"length" after its deadline passed
    rep.deadline_met = rep.completed
    for _, reason in refusals:
        rep.refused_by_reason[reason] = \
            rep.refused_by_reason.get(reason, 0) + 1
    if wall_s > 0:
        rep.goodput_rps = round(rep.deadline_met / wall_s, 3)
        rep.offered_rps = round(rep.offered / wall_s, 3)
    if rep.offered:
        rep.refusal_rate = round(rep.refused / rep.offered, 3)
    rep.ttft_p50_s = round(percentile(ttfts, 0.50), 4)
    rep.ttft_p99_s = round(percentile(ttfts, 0.99), 4)
    if itl_gaps is not None:
        itls = itl_gaps
        rep.itl_samples = len(itl_gaps)
    rep.itl_p50_s = round(percentile(itls, 0.50), 4)
    rep.itl_p99_s = round(percentile(itls, 0.99), 4)
    rep.token_burst_max = token_burst_max
    if engine_stats:
        rep.spillovers = engine_stats.get("spillovers", 0)
    return rep


def run_open_loop(engine, schedule: list[tuple[float, Request]], *,
                  controller=None, clock: Callable[[], float] = time.monotonic,
                  sleep: Callable[[float], None] = time.sleep,
                  max_idle_sleep_s: float = 0.002,
                  max_wall_s: Optional[float] = None,
                  max_iterations: int = 2_000_000) -> LoadReport:
    """Drive ``engine`` (a ServeEngine / DisaggEngine / Router) through
    ``schedule`` OPEN loop: every request is submitted the moment its
    arrival offset passes, whether or not anything finished — the fleet
    absorbs the backlog through its own queues, refusals, deadlines,
    and (when a ``controller`` is plugged in) elastic actuation.

    The loop never sleeps while the engine has work (a busy engine IS
    the pacing) and naps in ``max_idle_sleep_s`` slices while idle
    between arrivals. ``controller.step()`` runs every iteration —
    controllers rate-limit themselves. ``max_wall_s`` is the give-up
    bound: a run that exceeds it returns with ``timed_out=True`` rather
    than hanging a drill. ``clock``/``sleep`` are injectable so
    virtual-clock tests can drive the whole loop deterministically
    (pass the engine the same clock)."""
    schedule = sorted(schedule, key=lambda item: item[0])
    t0 = clock()
    results: dict[int, object] = {}
    refusals: list[tuple[float, str]] = []
    # per-token arrival stamps (the honest-ITL tap): one timestamp per
    # token per request, stamped the iteration its stream first shows
    # it — a K-token burst shares one stamp, so K−1 gaps read ~0 and
    # the gap before the burst reads the full horizon latency
    tok_times: dict[int, list] = {}
    token_burst_max = 0
    can_tap = hasattr(engine, "partial_tokens")
    next_i = 0
    iterations = 0
    timed_out = False
    while True:
        now = clock() - t0
        if max_wall_s is not None and now > max_wall_s:
            timed_out = True
            break
        while next_i < len(schedule) and schedule[next_i][0] <= now:
            offset, request = schedule[next_i]
            next_i += 1
            try:
                rid = engine.submit(request)
            except RefusalError as exc:
                refusals.append((offset, exc.reason))
                continue
            results[rid] = None      # placeholder: submitted, in flight
        if controller is not None:
            controller.step()
        if engine.has_work:
            stepped = engine.step()
            for res in stepped:
                results[res.request_id] = res
            if can_tap:
                t_tap = clock() - t0
                for rid, toks in engine.partial_tokens().items():
                    times = tok_times.setdefault(rid, [])
                    new = len(toks) - len(times)
                    if new > 0:
                        token_burst_max = max(token_burst_max, new)
                        times.extend([t_tap] * new)
                # a finished request leaves partial_tokens() the same
                # iteration it completes: stamp its final block here
                for res in stepped:
                    times = tok_times.setdefault(res.request_id, [])
                    new = len(res.generated_ids) - len(times)
                    if new > 0:
                        token_burst_max = max(token_burst_max, new)
                        times.extend([t_tap] * new)
        elif next_i >= len(schedule):
            break
        else:
            gap = schedule[next_i][0] - (clock() - t0)
            if gap > 0:
                sleep(min(gap, max_idle_sleep_s))
        iterations += 1
        if iterations >= max_iterations:
            timed_out = True
            break
    finished = {rid: res for rid, res in results.items() if res is not None}
    stats = engine.stats() if hasattr(engine, "stats") else None
    itl_gaps = None
    if can_tap:
        itl_gaps = []
        for times in tok_times.values():
            itl_gaps.extend(b - a for a, b in zip(times, times[1:]))
    return summarize(schedule, finished, refusals, clock() - t0,
                     engine_stats=stats, timed_out=timed_out,
                     iterations=iterations, itl_gaps=itl_gaps,
                     token_burst_max=token_burst_max)


def saturation_sweep(engine_factory, rates, *, duration_s: float,
                     scenarios: list[Scenario], vocab: int, seed: int = 0,
                     controller_factory=None,
                     max_wall_s: Optional[float] = None) -> list[dict]:
    """The saturation curve: one open-loop run per arrival rate, fresh
    engine each (no warm queue leaking between points), goodput and
    latency tails per point. Offered load climbs; the knee where
    goodput stops following it IS the fleet's capacity — the number a
    closed-loop bench structurally cannot produce."""
    out = []
    for rate in rates:
        engine = engine_factory()
        controller = (controller_factory(engine)
                      if controller_factory is not None else None)
        schedule = build_schedule(
            poisson_arrivals(rate, duration_s, seed=seed),
            scenarios, vocab=vocab, seed=seed)
        report = run_open_loop(engine, schedule, controller=controller,
                               max_wall_s=max_wall_s)
        close = getattr(engine, "close", None)
        if close is not None:
            close()
        out.append({"rate_rps": rate, **report.as_dict()})
    return out


# ---- CLI -------------------------------------------------------------------
def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        prog="python -m distributed_training_guide_tpu_torch.serve.loadgen",
        description="Open-loop load generator: drive a local fleet with "
                    "Poisson or trace arrivals and report goodput + tails")
    parser.add_argument("--model", default="llama-debug")
    parser.add_argument("--replicas", type=int, default=1)
    parser.add_argument("--rate", type=float, default=4.0,
                        help="Poisson arrival rate, requests/s")
    parser.add_argument("--duration", type=float, default=10.0,
                        help="trace length, seconds")
    parser.add_argument("--trace", default=None,
                        help="file of arrival offsets (one float per "
                             "line) replayed instead of Poisson")
    parser.add_argument("--deadline", type=float, default=None,
                        help="base deadline_s scaled per scenario "
                             "(default: no deadlines)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--page-size", type=int, default=16)
    parser.add_argument("--max-len", type=int, default=128)
    parser.add_argument("--max-queue", type=int, default=None)
    parser.add_argument("--adapters", type=int, default=0,
                        help="publish this many toy LoRA adapters and "
                             "add a Zipf-weighted multi-tenant profile "
                             "to the scenario mix")
    parser.add_argument("--adapter-rank", type=int, default=8)
    parser.add_argument("--zipf-s", type=float, default=1.1,
                        help="Zipf exponent for adapter popularity")
    parser.add_argument("--controller", action="store_true",
                        help="run the SLO controller over the fleet "
                             "(serve/controller.py defaults)")
    parser.add_argument("--max-wall", type=float, default=None,
                        help="give up after this many wall seconds")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the fleet runs (default cuda)")
    args = parser.parse_args(argv)

    import torch

    from ..models.registry import get_model
    from .router import local_fleet

    bundle = get_model(args.model, dtype=torch.float32)
    params = bundle.init(bundle.config, args.seed, device=args.device)
    adapter_kw = ({"max_adapters": args.adapters + 1,
                   "adapter_rank": args.adapter_rank}
                  if args.adapters > 0 else {})
    fleet = local_fleet(bundle, params, args.replicas, device=args.device,
                        n_slots=args.slots, page_size=args.page_size,
                        max_len=args.max_len, max_queue=args.max_queue,
                        **adapter_kw)
    if args.adapters > 0:
        from ..models.lora import lora_bundle

        lb = lora_bundle(bundle, rank=args.adapter_rank)
        for i in range(args.adapters):
            lp = lb.lora_init_adapters(lb.config, 1000 + i,
                                       device=args.device)
            fleet.publish_adapter(
                {t: {k: v * 0.02 for k, v in pair.items()}
                 for t, pair in lp.items()},
                name=f"tenant-{i + 1}")
    controller = None
    if args.controller:
        from .controller import Controller

        controller = Controller(fleet)
    vocab = int(bundle.config.vocab_size)
    scenarios = default_scenarios(max_len=args.max_len,
                                  page_size=args.page_size, vocab=vocab,
                                  deadline_s=args.deadline, seed=args.seed)
    if args.adapters > 0:
        scenarios.append(adapter_mix_scenario(
            max_len=args.max_len, n_adapters=args.adapters,
            zipf_s=args.zipf_s, deadline_s=args.deadline))
    if args.trace:
        with open(args.trace) as fp:
            arrivals = trace_arrivals(
                float(line) for line in fp if line.strip())
    else:
        arrivals = poisson_arrivals(args.rate, args.duration,
                                    seed=args.seed)
    schedule = build_schedule(arrivals, scenarios, vocab=vocab,
                              seed=args.seed)
    report = run_open_loop(fleet, schedule, controller=controller,
                           max_wall_s=args.max_wall)
    out = {"model": args.model, "replicas": args.replicas,
           "rate_rps": args.rate if not args.trace else None,
           **report.as_dict()}
    if controller is not None:
        out["controller"] = controller.stats()
    print(json.dumps(out))
    fleet.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
