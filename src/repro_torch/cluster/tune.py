"""``tune_cluster``: co-design the chip mix and fleet sizing for a
workload mix under total area/TDP budgets (counterpart of
``repro.cluster.tune``).

The two-level generalization of ``tune_chip``:

  1. **Per-class die tuning** — each ``ChipClass`` (a workload class worth
     specializing a die for: its phases, per-die budgets, accuracy class)
     is tuned with ``tune_chip`` through the *shared*
     ``SweepExecutableCache``, so the electrical sweeps compile once per
     grid shape across every class.
  2. **Fleet sizing** — a greedy local search (``core.localsearch``,
     the reusable engine that the launch hillclimb's loop grew into)
     climbs the per-class replica-count vector under the cluster budgets.
     The objective is lexicographic:
     ``(classes covered, balanced throughput, -power)`` — cover every
     traffic class first, then maximize the service-balanced throughput
     ``min_c capacity_c / share_c`` (the cluster-level analogue of
     ``chip._fleet_counts``'s per-die sizing), then shed watts.

With one class and ``max_chips=1`` the search degenerates to a single
die whose spec is exactly the ``tune_chip`` result — the golden the tests
pin.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.spec import ClusterSpec
from repro_torch.core import autotune as at
from repro_torch.core.chip import ChipTuneResult, PhaseSpec, tune_chip
from repro_torch.core.localsearch import SearchResult, hillclimb


@dataclasses.dataclass(frozen=True)
class ChipClass:
    """One die specialization worth fabricating: the workload phases it is
    tuned for, its per-die budgets, and its share of cluster FLOP demand
    (shares are normalized over the classes passed to ``tune_cluster``)."""

    name: str
    phases: Tuple[PhaseSpec, ...]
    workload_share: float = 1.0
    area_budget_mm2: float = math.inf
    tdp_budget_mw: float = math.inf
    accuracy_slo: Optional[float] = None

    def __post_init__(self):
        if not self.phases:
            raise ValueError(f"chip class {self.name!r} needs >= 1 phase")
        if self.workload_share <= 0:
            raise ValueError(
                f"chip class {self.name!r}: workload_share must be > 0")


@dataclasses.dataclass
class ClusterTuneResult:
    spec: ClusterSpec
    counts: Dict[str, int]
    per_class: Dict[str, ChipTuneResult]
    search: SearchResult
    report: Dict[str, object]

    def as_dict(self) -> Dict[str, object]:
        return dict(cluster=self.spec.as_dict(), counts=dict(self.counts),
                    report=self.report)


def _score_factory(classes: Sequence[ChipClass],
                   dies: Sequence[ChipTuneResult],
                   shares: np.ndarray,
                   area_budget_mm2: float, tdp_budget_mw: float,
                   max_chips: int):
    areas = np.asarray([t.spec.area_mm2 for t in dies])
    peaks = np.asarray([t.spec.peak_power_mw for t in dies])
    avgs = np.asarray([t.spec.avg_power_mw for t in dies])
    caps = np.asarray([t.spec.gflops_effective for t in dies])

    def score(counts: Tuple[int, ...]):
        n = np.asarray(counts)
        total = int(n.sum())
        if total < 1 or total > max_chips or (n < 0).any():
            return None
        if math.isfinite(area_budget_mm2) \
                and float(n @ areas) > area_budget_mm2 * (1 + 1e-12):
            return None
        if math.isfinite(tdp_budget_mw) \
                and float(n @ peaks) > tdp_budget_mw * (1 + 1e-12):
            return None
        coverage = int((n > 0).sum())
        capacity = n * caps
        balanced = float((capacity / shares).min())
        return (coverage, balanced, -float(n @ avgs))

    return score


def _neighbors(counts: Tuple[int, ...]):
    for i in range(len(counts)):
        for d in (+1, -1):
            c = list(counts)
            c[i] += d
            if c[i] >= 0:
                yield tuple(c)


def tune_cluster(classes: Sequence[ChipClass], *,
                 area_budget_mm2: float = math.inf,
                 tdp_budget_mw: float = math.inf,
                 max_chips: int = 8,
                 params=None,
                 vdd_grid: np.ndarray = at.TUNE_VDD_GRID,
                 vbb_grid: np.ndarray = at.TUNE_VBB_GRID,
                 cache=at.DEFAULT_CACHE,
                 max_iters: int = 64,
                 name: str = "cluster",
                 device=None) -> ClusterTuneResult:
    """Co-design the die mix and replica counts for a traffic mix.

    Every class's die is tuned with ``tune_chip`` (shared sweep cache);
    the replica-count vector is then hillclimbed under the cluster-level
    area/TDP budgets and ``max_chips``.  Returns the budget-validated
    ``ClusterSpec`` (die names ``<class>/die<i>``), the counts, the
    per-class tunes, and the full search trajectory.

    The sweeps (and a missing calibration) run on ``device``: the card
    unless the caller passes ``device='cpu'``; the fleet sizing is host
    arithmetic.
    """
    classes = list(classes)
    if not classes:
        raise ValueError("tune_cluster needs at least one chip class")
    names = [c.name for c in classes]
    if len(names) != len(set(names)):
        raise ValueError(f"duplicate chip class names: {names}")
    dies: List[ChipTuneResult] = [
        tune_chip(c.phases,
                  area_budget_mm2=c.area_budget_mm2,
                  tdp_budget_mw=c.tdp_budget_mw,
                  params=params, vdd_grid=vdd_grid, vbb_grid=vbb_grid,
                  cache=cache, accuracy_slo=c.accuracy_slo, name=c.name,
                  device=device)
        for c in classes
    ]
    shares = np.asarray([c.workload_share for c in classes], float)
    shares /= shares.sum()
    score = _score_factory(classes, dies, shares, area_budget_mm2,
                           tdp_budget_mw, max_chips)

    # anchor: one die of the heaviest class (always the cheapest feasible
    # coverage-1 state to verify; budgets that cannot even fit it are a
    # genuine infeasibility and hillclimb raises)
    init = [0] * len(classes)
    init[int(np.argmax(shares))] = 1
    search = hillclimb(tuple(init), _neighbors, score, max_iters=max_iters)
    counts = {c.name: int(k) for c, k in zip(classes, search.best)}

    chips = []
    for c, die, k in zip(classes, dies, search.best):
        for i in range(k):
            chips.append(dataclasses.replace(die.spec,
                                             name=f"{c.name}/die{i}"))
    spec = ClusterSpec(name, tuple(chips),
                       area_budget_mm2=area_budget_mm2,
                       tdp_budget_mw=tdp_budget_mw)
    coverage, balanced, neg_power = search.best_score
    report = dict(
        cluster=spec.as_dict(),
        counts=counts,
        workload_shares={c.name: float(s)
                         for c, s in zip(classes, shares)},
        classes_covered=coverage,
        balanced_throughput_gflops=balanced,
        avg_power_mw=-neg_power,
        search=dict(evaluations=search.evaluations,
                    iterations=search.iterations,
                    converged=search.converged),
        per_class={c.name: d.report for c, d in zip(classes, dies)},
        cache_stats=dict(cache.stats) if cache is not None else {})
    return ClusterTuneResult(spec=spec, counts=counts,
                             per_class={c.name: d
                                        for c, d in zip(classes, dies)},
                             search=search, report=report)
