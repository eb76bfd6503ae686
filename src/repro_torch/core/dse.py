"""FPGen design-space exploration and Pareto frontiers (paper Fig. 3 / 4).
Counterpart of ``repro.core.dse``: numpy on top of the ported batched
model and latency simulator, which run on ``device``.

Enumerates the microarchitectural space (style x pipeline partition x Booth
radix x reduction tree) crossed with the electrical space (V_DD, V_BB), and
extracts Pareto-optimal sets under the two workload objectives the paper
optimizes for:

  * throughput: (GFLOPS/W, GFLOPS/mm^2)    -> Fig. 3
  * latency:    (energy/FLOP, average benchmarked delay)  -> Fig. 4
    where average delay = cycle * (1 + average latency penalty) on the
    calibrated SPEC-like mixture, matching the paper's metric.

The sweep is structure-of-arrays and batched: ``sweep_arrays`` evaluates
the whole (design x V_DD x V_BB) tensor in one ``predict_batch`` dispatch and
one batched latency-penalty call, returning a ``SweepResult``.  The legacy
``DsePoint``-list API (``sweep`` / ``throughput_pareto`` / ...) is kept as a
thin adapter on top; the original per-point loop survives as ``sweep_loop``
for equivalence tests.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Sequence, Union

import numpy as np

from repro_torch.core import objective as obj
from repro_torch.core.energy_model import (SweepExecutableCache, TechParams,
                                     calibrate, predict_batch, predict_grid)
from repro_torch.core.fpu_arch import BOOTH_RADICES, TREES, FPUDesign
from repro_torch.core.latency_sim import (SpecMix, average_latency_penalty,
                                    calibrated_spec_mix, penalties_for_waits)


# ---------------------------------------------------------------------------
# Enumeration
# ---------------------------------------------------------------------------
def _enumerate(precision: str, styles: Sequence[str],
               fma_stages: Sequence[int],
               cma_partitions: Sequence[tuple],
               fwd_options: Sequence[bool]) -> List[FPUDesign]:
    out: List[FPUDesign] = []
    for style in styles:
        for booth, tree in itertools.product(BOOTH_RADICES, TREES):
            for fwd in fwd_options:
                nf = "" if fwd else "_nf"
                if style == "fma":
                    for stages in fma_stages:
                        out.append(FPUDesign(
                            precision, "fma", stages=stages,
                            mul_stages=max(stages - 2, 1), add_stages=0,
                            booth=booth, tree=tree, forwarding=fwd,
                            name=f"{precision}_fma_s{stages}_b{booth}"
                                 f"_{tree}{nf}"))
                else:
                    for mul_s, add_s in cma_partitions:
                        out.append(FPUDesign(
                            precision, "cma", stages=mul_s + add_s + 1,
                            mul_stages=mul_s, add_stages=add_s,
                            booth=booth, tree=tree, forwarding=fwd,
                            name=f"{precision}_cma_m{mul_s}a{add_s}"
                                 f"_b{booth}_{tree}{nf}"))
    return out


def enumerate_structures(precision: str,
                         styles: Sequence[str] = ("fma", "cma"),
                         ) -> List[FPUDesign]:
    """All structural design points for one precision (the Fig. 3/4 space)."""
    return _enumerate(precision, styles, range(3, 8),
                      tuple(itertools.product((2, 3), (1, 2, 3))), (True,))


def enumerate_structures_full(precision: str,
                              styles: Sequence[str] = ("fma", "cma"),
                              ) -> List[FPUDesign]:
    """The expanded autotuner enumeration: a strict superset of
    ``enumerate_structures`` with wider pipeline partitions (FMA 2-9 stages,
    CMA up to 4+4) and no-forwarding variants — ~4x the default structural
    space, affordable since a batched sweep point costs next to nothing
    (and ``SweepExecutableCache`` reuses per-shape buffers)."""
    return _enumerate(precision, styles, range(2, 10),
                      tuple(itertools.product((1, 2, 3, 4), (1, 2, 3, 4))),
                      (True, False))


DEFAULT_VDD_GRID = np.round(np.arange(0.50, 1.151, 0.05), 3)
DEFAULT_VBB_GRID = np.round(np.arange(0.0, 1.21, 0.3), 2)


@dataclasses.dataclass
class DsePoint:
    design: FPUDesign
    vdd: float
    vbb: float
    metrics: dict

    @property
    def key(self) -> str:
        return f"{self.design.name}@{self.vdd:.2f}V/bb{self.vbb:.1f}"


# ---------------------------------------------------------------------------
# Structure-of-arrays sweep
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SweepResult:
    """Structure-of-arrays sweep: one row per valid (design, vdd, vbb) cell.

    Rows are ordered design-major, then vdd, then vbb — identical to the
    iteration order of the legacy per-point loop.  ``designs`` holds the
    unique structural designs; ``design_index[i]`` maps row i into it.
    """

    designs: List[FPUDesign]
    design_index: np.ndarray  # (n,) int
    vdd: np.ndarray  # (n,) float64
    vbb: np.ndarray  # (n,) float64
    metrics: Dict[str, np.ndarray]  # each (n,) float64

    def __len__(self) -> int:
        return int(self.vdd.size)

    @property
    def n_points(self) -> int:
        return len(self)

    def design_of(self, i: int) -> FPUDesign:
        return self.designs[int(self.design_index[i])]

    def point(self, i: int) -> DsePoint:
        i = int(i)
        return DsePoint(self.design_of(i), float(self.vdd[i]),
                        float(self.vbb[i]),
                        {k: float(v[i]) for k, v in self.metrics.items()})

    def to_points(self) -> List[DsePoint]:
        """Legacy list-of-DsePoint adapter (metric dicts of floats)."""
        names = list(self.metrics)
        cols = [self.metrics[k] for k in names]
        return [DsePoint(self.designs[di], float(v), float(b),
                         {k: float(c[i]) for k, c in zip(names, cols)})
                for i, (di, v, b) in enumerate(
                    zip(self.design_index, self.vdd, self.vbb))]

    def select(self, mask: np.ndarray) -> "SweepResult":
        """Row subset (boolean mask or index array), designs list shared."""
        return SweepResult(self.designs, self.design_index[mask],
                           self.vdd[mask], self.vbb[mask],
                           {k: v[mask] for k, v in self.metrics.items()})

    # -- vectorized objective extraction ----------------------------------
    # All selection routes through core.objective so the tuner,
    # benchmarks, and figures share one objective/constraint definition.
    def pareto_mask_for(self, axes: obj.ParetoAxes) -> np.ndarray:
        xs, ys = obj.axis_costs(self.metrics, axes)
        return pareto_mask(xs, ys)

    def throughput_pareto_mask(self) -> np.ndarray:
        return self.pareto_mask_for(obj.THROUGHPUT_AXES)

    def latency_pareto_mask(self) -> np.ndarray:
        return self.pareto_mask_for(obj.LATENCY_AXES)

    def argbest(self, objective: obj.Objective,
                constraints: Sequence[obj.Constraint] = ()) -> int:
        return obj.argbest(self.metrics, objective, constraints)

    def argbest_throughput(self, weight_area: float = 1.0) -> int:
        return self.argbest(obj.throughput_objective(weight_area))

    def argbest_latency(self) -> int:
        return self.argbest(obj.LATENCY)


def sweep_arrays(designs: Iterable[FPUDesign],
                 params: TechParams | None = None,
                 vdd_grid: np.ndarray = DEFAULT_VDD_GRID,
                 vbb_grid: np.ndarray = DEFAULT_VBB_GRID,
                 util: float = 1.0,
                 mix: SpecMix | None = None,
                 with_latency: bool = False,
                 backend: str = "torch",
                 anchored: bool = False,
                 cache: SweepExecutableCache | None = None,
                 device=None) -> SweepResult:
    """Evaluate every (structure x voltage) point in one batched dispatch.

    ``anchored=True`` applies the per-fabricated-design silicon corrections
    (exact at the Table I operating points).  ``cache`` reuses per-shape
    device buffers across same-shape sweeps of the torch backend.
    ``device`` is where the torch backend, the latency simulator and
    ``calibrate`` run (the card unless ``device='cpu'``).
    """
    designs = list(designs)
    params = params or calibrate(device=device)
    vdd_grid = np.asarray(vdd_grid, np.float64).ravel()
    vbb_grid = np.asarray(vbb_grid, np.float64).ravel()
    tensor = predict_batch(designs, params, vdd_grid, vbb_grid, util=util,
                           backend=backend, anchored=anchored, cache=cache,
                           device=device)
    valid = (tensor["freq_ghz"] > 0) & np.isfinite(tensor["p_total_mw"])
    if valid.all():
        # fast path (the common case): C-order flatten is element-wise
        # identical to nonzero + fancy indexing but copy-free
        nd, nv, nb = valid.shape
        didx = np.repeat(np.arange(nd), nv * nb)
        vi = np.tile(np.repeat(np.arange(nv), nb), nd)
        bi = np.tile(np.arange(nb), nd * nv)
        metrics = {k: np.ascontiguousarray(v).reshape(-1)
                   for k, v in tensor.items()}
    else:
        didx, vi, bi = np.nonzero(valid)  # C-order: design-major, vdd, vbb
        metrics = {k: v[didx, vi, bi] for k, v in tensor.items()}
    res = SweepResult(designs, didx, vdd_grid[vi], vbb_grid[bi], metrics)
    if with_latency:
        mix = mix or calibrated_spec_mix(device=device)
        pairs = [(d.accum_latency_cycles, d.mul_dep_latency_cycles)
                 for d in designs]
        pen = penalties_for_waits(pairs, mix, device=device)[didx]
        metrics["avg_latency_penalty"] = pen
        metrics["avg_delay_ns"] = metrics["cycle_ns"] * (1.0 + pen)
        metrics["e_per_flop_pj"] = metrics["p_total_mw"] / (
            2.0 * metrics["freq_ghz"] * util) / 1e3 * 1e3
    return res


def sweep(designs: Iterable[FPUDesign],
          params: TechParams | None = None,
          vdd_grid: np.ndarray = DEFAULT_VDD_GRID,
          vbb_grid: np.ndarray = DEFAULT_VBB_GRID,
          util: float = 1.0,
          mix: SpecMix | None = None,
          with_latency: bool = False, device=None) -> List[DsePoint]:
    """Legacy API: batched sweep, adapted back to a list of DsePoints."""
    return sweep_arrays(designs, params, vdd_grid, vbb_grid, util=util,
                        mix=mix, with_latency=with_latency,
                        device=device).to_points()


def sweep_loop(designs: Iterable[FPUDesign],
               params: TechParams | None = None,
               vdd_grid: np.ndarray = DEFAULT_VDD_GRID,
               vbb_grid: np.ndarray = DEFAULT_VBB_GRID,
               util: float = 1.0,
               mix: SpecMix | None = None,
               with_latency: bool = False, device=None) -> List[DsePoint]:
    """The original per-point Python loop, kept as the reference
    implementation for equivalence tests (the latency simulator runs on
    ``device``)."""
    params = params or calibrate(device=device)
    pts: List[DsePoint] = []
    penalty_cache = {}
    for d in designs:
        if with_latency:
            mix = mix or calibrated_spec_mix(device=device)
            pkey = (d.accum_latency_cycles, d.mul_dep_latency_cycles)
            if pkey not in penalty_cache:
                penalty_cache[pkey] = average_latency_penalty(d, mix,
                                                              device=device)
            penalty = penalty_cache[pkey]
        vv, bb = np.meshgrid(vdd_grid, vbb_grid, indexing="ij")
        grid = predict_grid(d, params, vv, bb, util=util)
        for i in range(vv.shape[0]):
            for j in range(vv.shape[1]):
                m = {k: float(v[i, j]) for k, v in grid.items()}
                if m["freq_ghz"] <= 0 or not np.isfinite(m["p_total_mw"]):
                    continue
                if with_latency:
                    m["avg_latency_penalty"] = penalty
                    m["avg_delay_ns"] = m["cycle_ns"] * (1.0 + penalty)
                    m["e_per_flop_pj"] = m["p_total_mw"] / (
                        2.0 * m["freq_ghz"] * util) / 1e3 * 1e3
                pts.append(DsePoint(d, float(vv[i, j]), float(bb[i, j]), m))
    return pts


# ---------------------------------------------------------------------------
# Pareto extraction
# ---------------------------------------------------------------------------
def pareto_mask(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Boolean mask of points Pareto-optimal under (minimize x, minimize y).

    A point is kept iff no other point weakly dominates it with at least one
    strict inequality (x_j <= x_i and y_j <= y_i with one of them strict).
    Tie policy (explicit, exact — no epsilon): exact duplicates of a frontier
    point are ALL kept; a point tying a frontier point in only one coordinate
    while being strictly worse in the other is dominated and dropped.  The
    mask is therefore invariant under permutation of the input.

    Fully vectorized: one lexsort + cumulative minima, no Python loop.
    """
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    n = xs.size
    if n == 0:
        return np.zeros(0, bool)
    order = np.lexsort((ys, xs))  # x ascending, y ascending within ties
    xs_s, ys_s = xs[order], ys[order]
    # index of the first row of each equal-x group
    new_x = np.empty(n, bool)
    new_x[0] = True
    new_x[1:] = xs_s[1:] != xs_s[:-1]
    group_start = np.maximum.accumulate(np.where(new_x, np.arange(n), 0))
    # best y among all strictly-smaller x (running min up to previous group)
    cummin_y = np.minimum.accumulate(ys_s)
    prev_best_y = np.where(group_start > 0,
                           cummin_y[np.maximum(group_start - 1, 0)], np.inf)
    # keep: minimal y within its x-group AND strictly better than every
    # smaller-x point's y
    keep_sorted = (ys_s == ys_s[group_start]) & (ys_s < prev_best_y)
    mask = np.zeros(n, bool)
    mask[order[keep_sorted]] = True
    return mask


PointsOrResult = Union[Sequence[DsePoint], SweepResult]


def throughput_pareto(points: PointsOrResult):
    """Pareto set maximizing (GFLOPS/W, GFLOPS/mm^2) — Fig. 3 axes.

    Accepts a legacy DsePoint list (returns a filtered list) or a
    SweepResult (returns a filtered SweepResult).
    """
    if isinstance(points, SweepResult):
        return points.select(points.throughput_pareto_mask())
    xs = -np.array([p.metrics["gflops_per_w"] for p in points])
    ys = -np.array([p.metrics["gflops_per_mm2"] for p in points])
    mask = pareto_mask(xs, ys)
    return [p for p, m in zip(points, mask) if m]


def latency_pareto(points: PointsOrResult):
    """Pareto set minimizing (energy/FLOP, average delay) — Fig. 4 axes."""
    if isinstance(points, SweepResult):
        return points.select(points.latency_pareto_mask())
    xs = np.array([p.metrics["e_per_flop_pj"] for p in points])
    ys = np.array([p.metrics["avg_delay_ns"] for p in points])
    mask = pareto_mask(xs, ys)
    return [p for p, m in zip(points, mask) if m]


def best_throughput_design(precision: str, params: TechParams | None = None,
                           weight_area: float = 1.0, device=None) -> DsePoint:
    """argmax of the geometric mean of the two throughput efficiencies."""
    res = sweep_arrays(enumerate_structures(precision), params,
                       device=device)
    return res.point(res.argbest_throughput(weight_area))


def best_latency_design(precision: str, params: TechParams | None = None,
                        device=None) -> DsePoint:
    """argmin of energy x average-delay product (EDP on the paper's metric)."""
    res = sweep_arrays(enumerate_structures(precision), params,
                       with_latency=True, device=device)
    return res.point(res.argbest_latency())
