"""Trace-derived workload profiles of the port (counterpart of
``repro.telemetry.profile``): a recorded serving trace into the tuner's
inputs.

``tune_chip`` needs ``WorkloadProfile``s: an operation mix, its
dependency structure and its **activity** (the share of time the unit is
busy, the paper's Fig. 4 axis).  This module reads them off a trace:

  * ``summarize_trace`` reduces a ``Tracer`` (or a JSONL log path) to the
    tuner's facts: per-phase lane activity from the step-level occupancy
    timelines, prefill/decode weights from the spans' token counts, the
    traffic's precision mix, energy, and fault/requeue counts;
  * ``profile_from_trace`` blends the prefill (streaming GEMM) and decode
    (dependence-heavy) op mixes by the measured phase weights into one
    ``core.autotune.WorkloadProfile`` at the measured activity;
  * ``phases_from_trace`` keeps the phases apart as ``core.chip.PhaseSpec``
    rows for ``tune_chip``.

The tuner stack is imported inside the functions, so the telemetry core
stays free of dependencies on the serving path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.telemetry.export import coerce_tracer
from repro_torch.telemetry.tracer import Event, Tracer

#: decode-shaped dependency mix (matches ``autotune.profile_from_config``):
#: serial token recurrence -> frequent short-distance accumulation
#: dependences, latency priced over area
_DECODE_MIX = dict(p_acc=0.45, p_mul=0.10, q_acc=0.3, q_mul=0.3,
                   w_area=0.3, w_delay=0.7)
#: prefill-shaped mix (= ``autotune.GEMM_STREAM``): interleaved
#: accumulation lanes, throughput priced
_PREFILL_MIX = dict(p_acc=0.05, p_mul=0.02, q_acc=0.9, q_mul=0.5,
                    w_area=1.0, w_delay=0.0)

#: activity floor handed to the tuner — a trace with idle tails can
#: average arbitrarily close to zero, but the energy model needs a
#: strictly positive busy fraction
MIN_ACTIVITY = 0.01


@dataclasses.dataclass(frozen=True)
class TraceSummary:
    """Tuner-relevant reduction of one recorded serving trace."""

    span_s: float               # wall of the trace (clock units)
    n_requests: int
    n_completed: int
    n_expired: int
    n_requeues: int             # continuation re-admissions (migrations)
    n_faults: int               # system-scope fault events
    prefill_tokens: int
    decode_tokens: int
    energy_j: float
    activity: float             # mean seated-lane occupancy over all steps
    prefill_activity: float     # mean prefill-lane occupancy
    decode_activity: float      # mean decode-lane occupancy
    bucket_hit_rate: float      # padded == exact admissions / admissions
    stall_frac: float           # mean sampled decode_stall_frac
    precision_mix: Dict[str, float]   # token share per request precision
    phase_weights: Dict[str, float]   # FLOP share: {"prefill": , "decode": }

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens


def _mean(rows: List[Tuple[float, str, float]], default: float = 0.0
          ) -> float:
    if not rows:
        return default
    return sum(v for _, _, v in rows) / len(rows)


def summarize_trace(source: Union[Tracer, str],
                    default_precision: str = "sp") -> TraceSummary:
    """Reduce a tracer (or JSONL log path) to a ``TraceSummary``.

    Activity comes from the ``occupancy`` / ``prefill_occupancy`` /
    ``decode_occupancy`` step timelines the engine samples; requests whose
    ``precision`` attr is unset count toward ``default_precision``.
    """
    tr = coerce_tracer(source)
    roots = tr.roots()
    t0 = min([s.start_s for s in tr.spans], default=0.0)
    t1 = max([s.end_s if s.end_s is not None else s.start_s
              for s in tr.spans], default=0.0)
    pf = sum(s.prefill_tokens for s in tr.spans)
    dec = sum(s.decode_tokens for s in tr.spans)
    tokens_of: Dict[int, int] = {}
    requeues = 0
    for s in tr.spans:
        tokens_of[s.uid] = tokens_of.get(s.uid, 0) + s.prefill_tokens \
            + s.decode_tokens
        requeues += sum(1 for e in s.events if e[0] == Event.REQUEUE)
    mix: Dict[str, float] = {}
    for uid, root in roots.items():
        prec = root.attrs.get("precision") or default_precision
        mix[prec] = mix.get(prec, 0.0) + tokens_of.get(uid, 0)
    total_mix = sum(mix.values())
    if total_mix > 0:
        mix = {k: v / total_mix for k, v in mix.items()}
    total = pf + dec
    weights = {"prefill": pf / total if total else 0.0,
               "decode": dec / total if total else 0.0}
    return TraceSummary(
        span_s=t1 - t0,
        n_requests=len(roots),
        n_completed=sum(1 for r in roots.values() if r.status == "ok"),
        n_expired=sum(1 for r in roots.values() if r.status == "expired"),
        n_requeues=requeues,
        n_faults=sum(1 for e in tr.system_events if e[0] == Event.FAULT),
        prefill_tokens=pf, decode_tokens=dec,
        energy_j=tr.total_energy_j(),
        activity=_mean(tr.metrics.get("occupancy", [])),
        prefill_activity=_mean(tr.metrics.get("prefill_occupancy", [])),
        decode_activity=_mean(tr.metrics.get("decode_occupancy", [])),
        bucket_hit_rate=_mean(tr.metrics.get("bucket_hit", []),
                              default=1.0),
        stall_frac=_mean(tr.metrics.get("decode_stall_frac", [])),
        precision_mix=mix, phase_weights=weights)


def _clip_activity(a: float) -> float:
    return min(max(a, MIN_ACTIVITY), 1.0)


def profile_from_trace(source: Union[Tracer, str], name: str = "trace",
                       adaptive_bb: bool = True):
    """One blended ``autotune.WorkloadProfile`` from a recorded trace.

    The op mix interpolates between the prefill (streaming GEMM) and
    decode (dependence-heavy) shapes by the trace's measured FLOP phase
    weights; ``activity`` is the measured mean lane occupancy — the knob
    ``profile_from_config`` otherwise hand-sets.  (Distinct from
    ``autotune.profile_from_trace``, which consumes a traced dependency
    profile from ``core.trace``; this one consumes a *serving* trace.)
    """
    from repro_torch.core.autotune import WorkloadProfile
    s = summarize_trace(source)
    w_dec = s.phase_weights["decode"]
    blend = {k: (1.0 - w_dec) * _PREFILL_MIX[k] + w_dec * _DECODE_MIX[k]
             for k in _DECODE_MIX}
    return WorkloadProfile(name, activity=_clip_activity(s.activity),
                           adaptive_bb=adaptive_bb, **blend)


def phases_from_trace(source: Union[Tracer, str], name: str = "trace",
                      precision: str = "sp", designs=None,
                      accuracy_slo: Optional[float] = None,
                      formats=None) -> List["object"]:
    """Measured-traffic ``PhaseSpec`` rows for ``tune_chip``: one prefill
    and one decode phase with FLOP shares and activities taken from the
    trace (phases with zero measured FLOPs are dropped)."""
    from repro_torch.core.autotune import WorkloadProfile
    from repro_torch.core.chip import PhaseSpec
    s = summarize_trace(source)
    phases = []
    shapes = (("prefill", _PREFILL_MIX, s.prefill_activity),
              ("decode", _DECODE_MIX, s.decode_activity))
    for phase, mixdef, act in shapes:
        frac = s.phase_weights[phase]
        if frac <= 0.0:
            continue
        profile = WorkloadProfile(f"{name}:{phase}",
                                  activity=_clip_activity(act), **mixdef)
        phases.append(PhaseSpec(f"{name}:{phase}", profile,
                                precision=precision, flops_fraction=frac,
                                designs=designs, accuracy_slo=accuracy_slo,
                                formats=formats))
    return phases
