"""Trace-driven open-loop load generation for cluster serving
(counterpart of ``repro.cluster.loadgen``, copied: it is numpy).

Open-loop means arrivals come from a clock, not from the server having
freed a slot — the only way to see real queueing behavior (p99 latency
under bursts) instead of the closed-loop mirage where load self-throttles.

The arrival process composes the two dominant structures of production
serving traffic:

  * **Diurnal modulation** — a sinusoidal rate envelope
    ``rate(t) = base * (1 + A * sin(2*pi*t/period))``;
  * **Bursts** — a 2-state Markov-modulated Poisson process (MMPP): a
    background/burst state pair with exponential holding times, the burst
    state multiplying the instantaneous rate.

Arrivals are drawn by Lewis-Shedler thinning against the envelope's peak
rate, so the nonhomogeneous process is exact, and the whole trace is a
pure function of ``TraceConfig`` (seeded ``np.random.default_rng``) —
replaying a trace is deterministic.

Each arrival carries a request class sampled from the configured mix:
prompt length, token budget, precision, accuracy class, and deadline
slack (None = bulk traffic), covering every routing dimension the
cluster front-end discriminates on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.engine import Request, RequestRejected
from repro_torch.telemetry.tracer import Event as TraceEvent


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One stratum of the traffic mix."""

    name: str
    weight: float = 1.0
    prompt_lens: Tuple[int, ...] = (4, 6, 8)
    max_new_tokens: int = 12
    precision: Optional[str] = None
    accuracy_slo: Optional[float] = None
    #: deadline = arrival time + slack; None = bulk (no deadline)
    deadline_slack_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs of the seeded arrival process (see module docstring)."""

    horizon_s: float = 30.0
    base_rate_rps: float = 1.0
    diurnal_amplitude: float = 0.5   # 0 = flat envelope
    diurnal_period_s: float = 20.0
    burst_multiplier: float = 3.0    # rate factor while the MMPP is ON
    burst_on_s: float = 2.0          # mean burst duration
    burst_off_s: float = 8.0         # mean gap between bursts
    classes: Tuple[RequestClass, ...] = (RequestClass("default"),)
    seed: int = 0

    def __post_init__(self):
        if not (0.0 <= self.diurnal_amplitude <= 1.0):
            raise ValueError("diurnal_amplitude must be in [0, 1]")
        if self.burst_multiplier < 1.0:
            raise ValueError("burst_multiplier must be >= 1")
        if not self.classes:
            raise ValueError("need at least one request class")


@dataclasses.dataclass
class Arrival:
    at_s: float
    cls: str
    request: Request


def _burst_intervals(cfg: TraceConfig, rng) -> List[Tuple[float, float]]:
    """Seeded MMPP ON intervals over the horizon."""
    out, t, on = [], 0.0, False
    while t < cfg.horizon_s:
        if on:
            dur = rng.exponential(cfg.burst_on_s)
            out.append((t, min(t + dur, cfg.horizon_s)))
        else:
            dur = rng.exponential(cfg.burst_off_s)
        t += dur
        on = not on
    return out


def generate(cfg: TraceConfig, vocab_size: int, *,
             start_uid: int = 0) -> List[Arrival]:
    """The full seeded trace: time-ordered ``Arrival`` rows."""
    rng = np.random.default_rng(cfg.seed)
    bursts = _burst_intervals(cfg, rng)

    def in_burst(t: float) -> bool:
        return any(a <= t < b for a, b in bursts)

    def rate(t: float) -> float:
        r = cfg.base_rate_rps * (
            1.0 + cfg.diurnal_amplitude
            * math.sin(2.0 * math.pi * t / cfg.diurnal_period_s))
        return r * (cfg.burst_multiplier if in_burst(t) else 1.0)

    peak = cfg.base_rate_rps * (1.0 + cfg.diurnal_amplitude) \
        * cfg.burst_multiplier
    weights = np.asarray([c.weight for c in cfg.classes], float)
    weights /= weights.sum()

    out: List[Arrival] = []
    t, uid = 0.0, start_uid
    while True:
        t += rng.exponential(1.0 / peak)   # Lewis-Shedler thinning
        if t >= cfg.horizon_s:
            break
        if rng.random() * peak > rate(t):
            continue
        cls = cfg.classes[int(rng.choice(len(cfg.classes), p=weights))]
        plen = int(cls.prompt_lens[int(rng.integers(len(cls.prompt_lens)))])
        req = Request(
            uid=uid,
            prompt=rng.integers(0, vocab_size, plen).astype(np.int32),
            max_new_tokens=cls.max_new_tokens,
            precision=cls.precision,
            accuracy_slo=cls.accuracy_slo,
            deadline_s=(t + cls.deadline_slack_s
                        if cls.deadline_slack_s is not None else None))
        out.append(Arrival(at_s=t, cls=cls.name, request=req))
        uid += 1
    return out


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Deterministic token-work clock model for ``replay``: after each
    scheduler step the simulated clock advances by the work the step
    actually performed (prefill tokens processed x ``t_prefill_token_s``
    plus decode tokens emitted x ``t_decode_token_s``), read off the
    target's cumulative counters.  This is what makes admission-latency
    effects *visible* in simulated time — a monolithic 4k-token prefill
    step costs 4k prefill-token units while every decode lane waits,
    whereas a chunked step costs one chunk.  Pure function of the trace
    and the schedule: no wall-clock noise."""

    t_prefill_token_s: float = 0.0
    t_decode_token_s: float = 0.0


def _work(target) -> Tuple[int, int]:
    """Cumulative (prefill_tokens, tokens_decoded) across the target's
    engines (a bare server, or anything exposing ``servers``)."""
    servers = getattr(target, "servers", None)
    if servers is None:
        servers = [target]
    elif hasattr(servers, "values"):
        servers = list(servers.values())
    pf = sum(getattr(s, "prefill_tokens", 0) for s in servers)
    dec = sum(getattr(s, "tokens_decoded", 0) for s in servers)
    return pf, dec


def replay(target, arrivals: Sequence[Arrival], clock, *,
           tick_s: float, dispatch_tokens: Optional[int] = None,
           max_steps: int = 100_000,
           carryover: Optional[Dict[int, float]] = None,
           cost: Optional[StepCost] = None,
           tracer=None
           ) -> Dict[str, object]:
    """Open-loop replay of a trace against a server or ``ClusterRouter``.

    ``clock`` must be the settable time source (``SimClock``) the target
    was built with; the replay advances it by ``tick_s`` per step, submits
    every arrival whose time has come, and steps the target — arrivals
    never wait for capacity (that is the point).  Returns per-request
    latency records (completion time - arrival time, finished requests
    only), per-request TTFT records (first-token commit time - arrival
    time, end-of-step semantics), the finished/rejected/expired partition,
    and the trace span.

    ``carryover`` maps uid -> original arrival time for requests already
    in flight on the target from an earlier replay window (e.g. traffic
    that survived a mid-trace die failure), so their latency is charged
    from their true arrival.

    ``cost`` (a ``StepCost``) additionally advances the clock after each
    step by that step's measured token work, making scheduling-induced
    queueing delay observable in simulated time; ``cost=None`` is the
    plain fixed-tick replay, unchanged.

    ``tracer`` (a ``telemetry.Tracer``) records each arrival as a
    system event (class + uid at the arrival instant), so a trace
    exported from a replay carries the offered load alongside the
    engine-side spans.  Pass the same tracer the target was built with.
    """
    pending = sorted(arrivals, key=lambda a: a.at_s)
    submit_t = dict(carryover or {})
    submit_t.update({a.request.uid: a.at_s for a in pending})
    latency: Dict[int, float] = {}
    ttft: Dict[int, float] = {}
    watch: Dict[int, Request] = {}  # submitted, first token not yet seen
    classes = {a.request.uid: a.cls for a in pending}
    finished = []
    rejected = []
    i = 0
    for _ in range(max_steps):
        clock.t += tick_s
        while i < len(pending) and pending[i].at_s <= clock.t:
            if tracer is not None and tracer.enabled:
                tracer.system_event(TraceEvent.ARRIVAL, pending[i].at_s,
                                    cls=pending[i].cls,
                                    uid=pending[i].request.uid)
            try:
                target.submit(pending[i].request)
                watch[pending[i].request.uid] = pending[i].request
            except RequestRejected:
                rejected.append(pending[i].request)
            i += 1
        if cost is not None:
            p0, d0 = _work(target)
        target.step(dispatch_tokens)
        if cost is not None:
            p1, d1 = _work(target)
            clock.t += cost.t_prefill_token_s * (p1 - p0) \
                + cost.t_decode_token_s * (d1 - d0)
        for uid in [u for u, r in watch.items() if r.output]:
            t0 = submit_t.get(uid)
            if t0 is not None:
                ttft[uid] = clock.t - t0
            del watch[uid]
        for req in _drain_finished(target):
            finished.append(req)
            watch.pop(req.uid, None)
            t0 = submit_t.get(req.uid)
            if t0 is not None:
                latency[req.uid] = clock.t - t0
        if i >= len(pending) and target.idle():
            break
    expired = [r for r in finished if r.expired]
    return dict(finished=finished, rejected=rejected, expired=expired,
                latency_s={u: latency[u] for u in sorted(latency)},
                ttft_s={u: ttft[u] for u in sorted(ttft)},
                classes=classes, span_s=clock.t,
                submitted=len(pending) - len(rejected))


def _drain_finished(target) -> List[Request]:
    if hasattr(target, "drain_finished"):   # ClusterRouter
        return target.drain_finished()
    out, target.finished = target.finished, []
    return out


def _finite(values) -> np.ndarray:
    v = np.asarray(sorted(values), float)
    return v[np.isfinite(v)] if v.size else v


def latency_stats(latency_s: Dict[int, float],
                  ttft_s: Optional[Dict[int, float]] = None
                  ) -> Dict[str, float]:
    """p50/p99/mean over a replay's end-to-end latency records; pass the
    replay's ``ttft_s`` records too and time-to-first-token percentiles
    are reported separately (admission latency is a different SLO than
    completion latency — a chunked-prefill engine improves the former
    without touching the latter).

    Edge cases are well-defined and NaN-free by contract: an empty record
    dict — an empty request list, or a trace where every request parked /
    expired before its first commit and so never produced a latency
    record — yields ``n == 0`` with every percentile 0.0 (read ``n``
    before trusting the zeros).  Non-finite values (NaN/inf, e.g. from a
    corrupted carryover stamp) are dropped from the percentiles; ``n``
    counts only the finite records that contributed."""
    v = _finite(latency_s.values())
    if not v.size:
        out = dict(n=0, p50_s=0.0, p99_s=0.0, mean_s=0.0, max_s=0.0)
    else:
        out = dict(n=int(v.size),
                   p50_s=float(np.percentile(v, 50)),
                   p99_s=float(np.percentile(v, 99)),
                   mean_s=float(v.mean()),
                   max_s=float(v.max()))
    if ttft_s is not None:
        w = _finite(ttft_s.values())
        if not w.size:
            out.update(n_ttft=0, p50_ttft_s=0.0, p99_ttft_s=0.0,
                       mean_ttft_s=0.0, max_ttft_s=0.0)
        else:
            out.update(n_ttft=int(w.size),
                       p50_ttft_s=float(np.percentile(w, 50)),
                       p99_ttft_s=float(np.percentile(w, 99)),
                       mean_ttft_s=float(w.mean()),
                       max_ttft_s=float(w.max()))
    return out
