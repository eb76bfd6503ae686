"""Shared objective / constraint API for DSE, autotuning, and figures
(counterpart of ``repro.core.objective``, copied: it is numpy only).

Every consumer of a sweep — the Fig. 3/4 Pareto extractions, the Table I/II
best-design helpers, and the workload-aware autotuner — used to carry its own
ad-hoc ``argbest`` arithmetic.  This module centralizes them:

  * an ``Objective`` is a monomial score over metric columns
    (``prod_k metric_k ** exp_k``), maximized or minimized;
  * a ``Constraint`` is an interval on one metric column;
  * ``argbest(metrics, objective, constraints)`` is the single vectorized
    selector everything routes through.

The two paper objectives are provided as constants whose score arithmetic is
expression-identical to the legacy ``SweepResult.argbest_*`` helpers (so the
refactor is bitwise-neutral), and the Fig. 3/4 Pareto axes are published here
so frontier extraction and scalar selection cannot drift apart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence, Tuple

import numpy as np

MetricCols = Mapping[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class Objective:
    """Monomial objective ``prod(metric ** exponent)`` over metric columns."""

    name: str
    terms: Tuple[Tuple[str, float], ...]  # ((metric_key, exponent), ...)
    sense: str = "min"  # 'min' | 'max'

    def __post_init__(self):
        if self.sense not in ("min", "max"):
            raise ValueError(f"sense {self.sense!r}")
        if not self.terms:
            raise ValueError("objective needs at least one term")

    def score(self, metrics: MetricCols) -> np.ndarray:
        """Vectorized score column; later argmin/argmax'd per ``sense``."""
        key0, exp0 = self.terms[0]
        s = np.asarray(metrics[key0]) ** exp0 if exp0 != 1.0 \
            else np.asarray(metrics[key0])
        for key, exp in self.terms[1:]:
            col = np.asarray(metrics[key])
            s = s * (col if exp == 1.0 else col ** exp)
        return s

    def argbest(self, metrics: MetricCols,
                feasible: np.ndarray | None = None) -> int:
        s = self.score(metrics)
        if feasible is not None:
            if not feasible.any():
                raise ValueError(
                    f"objective {self.name!r}: no feasible points")
            fill = math.inf if self.sense == "min" else -math.inf
            s = np.where(feasible, s, fill)
        return int(np.argmin(s) if self.sense == "min" else np.argmax(s))


@dataclasses.dataclass(frozen=True)
class Constraint:
    """Interval constraint ``lo <= metric <= hi`` on one metric column."""

    metric: str
    lo: float = -math.inf
    hi: float = math.inf

    def mask(self, metrics: MetricCols) -> np.ndarray:
        col = np.asarray(metrics[self.metric])
        return (col >= self.lo) & (col <= self.hi)


def feasible_mask(metrics: MetricCols,
                  constraints: Sequence[Constraint]) -> np.ndarray | None:
    """AND of all constraint masks; None when unconstrained."""
    mask = None
    for c in constraints:
        m = c.mask(metrics)
        mask = m if mask is None else (mask & m)
    return mask


def argbest(metrics: MetricCols, objective: Objective,
            constraints: Sequence[Constraint] = ()) -> int:
    """Index of the best point under ``objective`` among feasible points."""
    return objective.argbest(metrics, feasible_mask(metrics, constraints))


# ---------------------------------------------------------------------------
# The paper's two workload objectives (Table I / Fig. 3 / Fig. 4)
# ---------------------------------------------------------------------------
def throughput_objective(weight_area: float = 1.0) -> Objective:
    """Maximize ``gflops_per_w * gflops_per_mm2 ** weight_area`` —
    the legacy ``argbest_throughput`` score, expression-identical."""
    return Objective("throughput",
                     (("gflops_per_w", 1.0), ("gflops_per_mm2", weight_area)),
                     sense="max")


THROUGHPUT = throughput_objective()
#: minimize energy x average-delay product (EDP on the paper's delay metric)
LATENCY = Objective("latency",
                    (("e_per_flop_pj", 1.0), ("avg_delay_ns", 1.0)),
                    sense="min")

# Pareto axes, as (metric, sense) pairs.  Fig. 3: maximize both
# efficiencies; Fig. 4: minimize energy/FLOP and average benchmarked delay.
ParetoAxes = Tuple[Tuple[str, str], Tuple[str, str]]
THROUGHPUT_AXES: ParetoAxes = (("gflops_per_w", "max"),
                               ("gflops_per_mm2", "max"))
LATENCY_AXES: ParetoAxes = (("e_per_flop_pj", "min"),
                            ("avg_delay_ns", "min"))


def axis_costs(metrics: MetricCols, axes: ParetoAxes
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Minimization-form cost columns for a pair of Pareto axes."""
    out = []
    for key, sense in axes:
        col = np.asarray(metrics[key])
        out.append(-col if sense == "max" else col)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Accuracy constraints (the numerics AccuracyModel hook)
# ---------------------------------------------------------------------------
#: metric column carrying each sweep point's emulated-numerics error — the
#: RMS normwise relative error of the point's (format, accumulation-style)
#: pair on the AccuracyModel's sampled dot-product workload.  Attached by
#: the autotuner when tuning with ``formats=`` / ``accuracy_slo=``.
ACCURACY_METRIC = "rel_err"


def accuracy_constraint(slo: float) -> Constraint:
    """Feasibility ceiling on the numerics error: ``rel_err <= slo``.

    ``slo`` is the workload's accuracy SLO as a normwise relative error
    (e.g. ``1e-6`` admits only FP32-or-wider operand formats on typical
    reductions; ``1e-2`` opens the sub-SP transprecision tiers).  Points
    whose format/style pair misses the ceiling are infeasible, exactly like
    an area or TDP budget — accuracy is just another ``Constraint`` row.
    """
    if not (slo > 0):
        raise ValueError(f"accuracy_slo must be positive, got {slo!r}")
    return Constraint(ACCURACY_METRIC, hi=slo)


def workload_objective(name: str, w_area: float, w_delay: float) -> Objective:
    """The autotuner's scalarization: minimize effective energy/FLOP times
    area- and delay-sensitivity powers.

    ``e_eff_pj`` is the workload-conditioned column attached by
    ``repro_torch.core.autotune`` (stall-aware energy per FLOP at the profile's
    activity under its body-bias policy); ``avg_delay_ns`` is the sweep's
    per-op effective delay, computed on the profile's own dependency
    mixture.  ``w_area=1, w_delay=0`` recovers a throughput-style optimum
    (silicon is shared across many units, stalls hidden by interleaving);
    ``w_area=0, w_delay=1`` recovers the paper's latency optimum (EDP on the
    workload's own mixture).
    """
    terms = [("e_eff_pj", 1.0)]
    if w_area:
        terms.append(("area_mm2", w_area))
    if w_delay:
        terms.append(("avg_delay_ns", w_delay))
    return Objective(name, tuple(terms), sense="min")
