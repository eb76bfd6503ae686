"""Chip-level API for heterogeneous FPU fleets — the FPMax thesis at die scale
(counterpart of ``repro.core.chip``).

The paper's core argument is that one die should carry *different* FPU
microarchitectures for latency- vs throughput-bound work (Table I fabricates
four).  This module is the single consumer-facing surface for that idea:

  * a ``ChipUnit`` is one tuned unit type on the die — an ``FPUDesign`` at an
    electrical operating point (V_DD, V_BB), replicated ``count`` times, with
    its metric row from the sweep that selected it;
  * a ``ChipSpec`` is an area/power-budgeted mix of units per die;
  * a ``ChipPolicy`` is the facade the rest of the codebase asks
    "which unit, which numerics, what energy" — per execution phase
    (train / prefill / decode), routed through ``core.objective``;
  * ``tune_chip()`` searches unit mixes over the vectorized ``SweepResult``
    grids (reusing the autotuner's ``SweepExecutableCache``) under die-area
    and TDP constraints, sizes the fleet, and reports chip-level GFLOPS/W
    with adaptive body bias per unit.

``default_policy(precision).unit_for_phase`` / ``numerics_for_phase`` /
``select_fpu`` / ``step_energy_telemetry`` answer what the JAX package's
deprecated ``precision_policy`` shim asks, which the port does not carry;
``tune_chip`` with a 2-unit budget degenerates to exactly the Table I
throughput/latency split the autotuner picks per workload.

The sweeps behind ``tune_chip``, ``default_chip`` and the calibration run on
``device`` (the card unless the caller passes ``device='cpu'``); routing,
health and energy bookkeeping are host-side numpy, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import autotune as at
from repro_torch.core import objective as obj
from repro_torch.core.body_bias import energy_per_op
from repro_torch.core.dse import best_latency_design, best_throughput_design
from repro_torch.core.energy_model import TechParams, calibrate, predict
from repro_torch.core.formats import BF16, FloatFormat
from repro_torch.core.fpu_arch import FABRICATED, TABLE_I, FPUDesign

#: canonical execution phases of a model workload (configs shape kinds)
PHASES = ("train", "prefill", "decode")

#: phase substrings that classify as latency-bound (everything else is
#: throughput-bound) — the split ``policy_for_shape`` always drew
_LATENCY_TAGS = ("decode", "long", "latency", "chain")


def workload_class(phase: str) -> str:
    """'throughput' | 'latency' classification of a phase / shape-kind name."""
    p = phase.lower()
    return "latency" if any(t in p for t in _LATENCY_TAGS) else "throughput"


def kernel_style_for(design: FPUDesign) -> str:
    """Emulation accumulation style modeling a unit's FMAC semantics
    (delegates to the canonical mapping in ``numerics``)."""
    from repro_torch.numerics import accum_style_for
    return accum_style_for(design.style, design.forwarding)


# ---------------------------------------------------------------------------
# Numerics policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    """What the model layers actually consume for one routed unit."""

    fmt: FloatFormat  # operand format for emulated matmuls
    accum_style: str  # 'fused' | 'cascade' | 'cascade_fwd' (kernels/fma_emu)
    fpu_design: FPUDesign  # the FPGen unit this policy models
    compute_dtype: str = "bfloat16"  # native dtype for full-scale runs
    emulate: bool = False  # route model matmuls through kernels/fma_emu

    @property
    def kernel_style(self) -> str:
        return self.accum_style


# ---------------------------------------------------------------------------
# Chip description
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChipUnit:
    """One unit type on the die: a tuned design at an electrical point.

    ``metrics`` is the metric row of the sweep point that selected the unit
    (per-instance values); ``count`` replicates it.  ``phases`` are the
    execution phases routed to this unit; ``activity`` is the busy fraction
    the unit was tuned for (the Fig. 4 axis).
    """

    name: str
    design: FPUDesign
    vdd: float
    vbb: float
    count: int = 1
    phases: Tuple[str, ...] = ()
    activity: float = 1.0
    metrics: Mapping[str, float] = dataclasses.field(default_factory=dict)
    #: tuned operand format (a ``FloatFormat``) when the unit came out of a
    #: format-joint tune; None = the precision class's native format.
    fmt: Optional[FloatFormat] = None

    @property
    def key(self) -> str:
        return f"{self.design.name}@{self.vdd:.3f}V/bb{self.vbb:.2f}"

    @property
    def operand_format(self) -> FloatFormat:
        """The format this unit's datapath computes in."""
        if self.fmt is not None:
            return self.fmt
        from repro_torch.numerics import native_format
        return native_format(self.design.precision)

    def rel_err(self, accuracy_model=None) -> float:
        """The unit's numerics error (RMS normwise relative error of its
        format x accumulation style on the oracle workload) — the number
        accuracy-class admission routing compares against a request's SLO.
        Prefers the ``rel_err`` metric a format-joint tune recorded;
        otherwise consults the ``AccuracyModel``."""
        if "rel_err" in self.metrics:
            return float(self.metrics["rel_err"])
        from repro_torch.numerics import DEFAULT_ACCURACY_MODEL
        model = accuracy_model or DEFAULT_ACCURACY_MODEL
        return model.rel_err(self.operand_format,
                             kernel_style_for(self.design))

    def metric(self, key: str) -> float:
        """Metric column with derivations for rows from latency-free sweeps."""
        m = self.metrics
        if key in m:
            return float(m[key])
        if key == "avg_latency_penalty":
            return 0.0
        if key == "avg_delay_ns":
            return float(m["cycle_ns"]) * (1.0 + self.metric(
                "avg_latency_penalty"))
        if key in ("e_per_flop_pj", "e_eff_pj"):
            # mW / (2 GHz) = pJ/FLOP at 100% activity
            return float(m["p_total_mw"]) / (2.0 * float(m["freq_ghz"]))
        raise KeyError(f"unit {self.name!r} has no metric {key!r}")

    @property
    def e_per_flop_pj(self) -> float:
        """Workload-effective pJ/FLOP (``e_eff_pj`` when tuned, else the
        100%-activity energy)."""
        return self.metric("e_eff_pj")

    def energy_j(self, flops: float) -> float:
        """Joules attributed to ``flops`` executed on this unit (the bulk
        form the serving engine charges at dispatch boundaries)."""
        return flops * self.e_per_flop_pj * 1e-12

    @property
    def gflops_effective(self) -> float:
        """Delivered GFLOPS per instance: stalls and idle time included."""
        pen = self.metric("avg_latency_penalty")
        return 2.0 * self.metric("freq_ghz") / (1.0 + pen) * self.activity

    @property
    def area_mm2(self) -> float:
        return self.count * self.metric("area_mm2")

    @property
    def peak_power_mw(self) -> float:
        return self.count * self.metric("p_total_mw")

    @property
    def avg_power_mw(self) -> float:
        """Fleet average power: pJ/FLOP x delivered GFLOP/s = mW."""
        return self.count * self.e_per_flop_pj * self.gflops_effective

    def numerics(self, fmt: Optional[FloatFormat] = None,
                 emulate: bool = False) -> NumericsPolicy:
        """Emulation policy of this unit.  ``fmt=None`` uses the unit's
        tuned operand format (falling back to bf16, the pre-transprecision
        model-layer default, for format-agnostic units)."""
        if fmt is None:
            fmt = self.fmt if self.fmt is not None else BF16
        return NumericsPolicy(fmt=fmt, accum_style=kernel_style_for(
            self.design), fpu_design=self.design, emulate=emulate)

    def as_dict(self) -> Dict[str, object]:
        out = dict(unit=self.name, design=self.design.name, vdd=self.vdd,
                   vbb=self.vbb, count=self.count, phases=list(self.phases),
                   activity=self.activity,
                   area_mm2=self.area_mm2,
                   gflops_effective=self.count * self.gflops_effective,
                   e_eff_pj=self.e_per_flop_pj,
                   avg_power_mw=self.avg_power_mw,
                   peak_power_mw=self.peak_power_mw)
        if self.fmt is not None:
            out["fmt"] = self.fmt.name
            if "rel_err" in self.metrics:
                out["rel_err"] = float(self.metrics["rel_err"])
        return out


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """An area/power-budgeted mix of FPU unit types on one die."""

    name: str
    units: Tuple[ChipUnit, ...]
    area_budget_mm2: float = math.inf
    tdp_budget_mw: float = math.inf

    def __post_init__(self):
        names = [u.name for u in self.units]
        if not self.units:
            raise ValueError("a chip needs at least one unit")
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate unit names: {names}")
        if self.area_mm2 > self.area_budget_mm2 * (1 + 1e-12):
            raise ValueError(
                f"chip {self.name!r} infeasible: area {self.area_mm2:.4f}mm2 "
                f"> budget {self.area_budget_mm2:.4f}mm2")
        if self.peak_power_mw > self.tdp_budget_mw * (1 + 1e-12):
            raise ValueError(
                f"chip {self.name!r} infeasible: peak power "
                f"{self.peak_power_mw:.1f}mW > TDP {self.tdp_budget_mw:.1f}mW")

    def unit(self, name: str) -> ChipUnit:
        for u in self.units:
            if u.name == name:
                return u
        raise KeyError(f"chip {self.name!r} has no unit {name!r}; "
                       f"have {[u.name for u in self.units]}")

    @property
    def area_mm2(self) -> float:
        return sum(u.area_mm2 for u in self.units)

    @property
    def peak_power_mw(self) -> float:
        return sum(u.peak_power_mw for u in self.units)

    @property
    def avg_power_mw(self) -> float:
        return sum(u.avg_power_mw for u in self.units)

    @property
    def gflops_effective(self) -> float:
        return sum(u.count * u.gflops_effective for u in self.units)

    @property
    def gflops_per_w(self) -> float:
        """Chip-level efficiency at the units' tuned activities (adaptive
        body bias per unit is already inside each unit's ``e_eff_pj``)."""
        return self.gflops_effective / (self.avg_power_mw * 1e-3)

    def as_dict(self) -> Dict[str, object]:
        return dict(name=self.name,
                    units=[u.as_dict() for u in self.units],
                    area_mm2=self.area_mm2,
                    area_budget_mm2=self.area_budget_mm2,
                    peak_power_mw=self.peak_power_mw,
                    tdp_budget_mw=self.tdp_budget_mw,
                    avg_power_mw=self.avg_power_mw,
                    gflops_effective=self.gflops_effective,
                    gflops_per_w=self.gflops_per_w)


# ---------------------------------------------------------------------------
# Per-unit energy telemetry (the old step_energy_telemetry, unit-scoped)
# ---------------------------------------------------------------------------
def unit_energy_telemetry(design: FPUDesign, params: TechParams, *,
                          achieved_flops: float, step_time_s: float,
                          peak_flops: float, adaptive_bb: bool = True,
                          vdd: Optional[float] = None,
                          vbb_active: float = 1.2,
                          vbb_idle: float = 0.45) -> Dict[str, float]:
    """Per-step energy report for one unit at one operating point.

    utilization = achieved/peak FLOP rate (from the roofline pass); the
    body-bias policy turns that into J/step and GFLOPS/W exactly as the
    paper's Fig. 4 analysis does for partially-utilized FPUs.
    """
    vdd = design.vdd if vdd is None else vdd
    util = max(min(achieved_flops / step_time_s / peak_flops, 1.0), 1e-4)
    e = energy_per_op(design, params, vdd=vdd, vbb_active=vbb_active,
                      vbb_idle=(min(vbb_idle, vbb_active) if adaptive_bb
                                else None), util=util)
    joules = e["e_total_pj"] * 1e-12 * achieved_flops
    return dict(utilization=util, pj_per_flop=e["e_total_pj"],
                joules_per_step=joules,
                gflops_per_w=1.0 / (e["e_total_pj"] * 1e-3),
                policy="adaptive_bb" if adaptive_bb else "static_bb")


# ---------------------------------------------------------------------------
# Fleet partitioning (serving-engine slot assignment)
# ---------------------------------------------------------------------------
def partition_slots(n_slots: int, units: Sequence[ChipUnit]
                    ) -> Dict[str, Tuple[int, ...]]:
    """Split ``n_slots`` serving slots across ``units`` proportional to
    their instance counts (largest-remainder rounding, every fleet gets at
    least one slot).  Returns unit name -> contiguous slot-id tuple."""
    if not units:
        raise ValueError("partition_slots needs at least one unit")
    if n_slots < len(units):
        raise ValueError(
            f"{n_slots} slot(s) cannot cover {len(units)} fleet(s): "
            f"{[u.name for u in units]} — raise the engine slot count or "
            f"serve fewer precisions/classes")
    counts = np.asarray([max(1, u.count) for u in units], float)
    share = counts / counts.sum() * n_slots
    alloc = np.maximum(1, np.floor(share).astype(int))
    while alloc.sum() > n_slots:  # the 1-floors can overshoot tiny n_slots
        alloc[int(np.argmax(alloc))] -= 1
    order = np.argsort(-(share - np.floor(share)))
    i = 0
    while alloc.sum() < n_slots:
        alloc[order[i % len(units)]] += 1
        i += 1
    fleets: Dict[str, Tuple[int, ...]] = {}
    nxt = 0
    for u, c in zip(units, alloc):
        fleets[u.name] = tuple(range(nxt, nxt + int(c)))
        nxt += int(c)
    return fleets


# ---------------------------------------------------------------------------
# Unit health (the serving resilience layer's view of the die)
# ---------------------------------------------------------------------------
#: leakage share assumed when a unit's metric row carries no ``p_leak_mw``
#: (synthetic test units) — the paper's near-threshold regime where leakage
#: is a large minority of total power
_LEAK_SHARE_FALLBACK = 0.3


@dataclasses.dataclass(frozen=True)
class UnitHealth:
    """Runtime health of one ``ChipUnit`` (units themselves are frozen
    design-time objects; health is ``ChipPolicy`` state).

    ``status``: ``'healthy'`` | ``'throttled'`` (freq derated by
    ``freq_scale``, energy repriced) | ``'quarantined'`` (numerics
    corruption detected: not routable, may recover) | ``'dead'`` (unit
    lost: not routable).  ``since_s`` is the serving-clock time the state
    was entered (recovery-latency bookkeeping).
    """

    HEALTHY = "healthy"
    THROTTLED = "throttled"
    QUARANTINED = "quarantined"
    DEAD = "dead"
    STATUSES = (HEALTHY, THROTTLED, QUARANTINED, DEAD)

    status: str = HEALTHY
    freq_scale: float = 1.0  # effective frequency / nominal (throttle derate)
    reason: str = ""
    since_s: float = 0.0

    def __post_init__(self):
        if self.status not in self.STATUSES:
            raise ValueError(f"unknown health status {self.status!r}; "
                             f"have {self.STATUSES}")
        if not 0.0 < self.freq_scale <= 1.0:
            raise ValueError(f"freq_scale must be in (0, 1], "
                             f"got {self.freq_scale}")

    @property
    def in_service(self) -> bool:
        """Routable: healthy or throttled (degraded, still serving)."""
        return self.status in (self.HEALTHY, self.THROTTLED)


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------
#: objective used to break routing ties per workload class
_CLASS_OBJECTIVES = {"throughput": obj.THROUGHPUT, "latency": obj.LATENCY}


class ChipPolicy:
    """The one way the codebase asks "which unit, which numerics, what
    energy" for an execution phase of a workload.

    Routing: exact phase-tag match first; otherwise units of the phase's
    workload class compete under the class objective
    (``objective.THROUGHPUT`` / ``objective.LATENCY``) over their metric
    rows — selection stays in the shared objective API, never ad-hoc
    arithmetic.
    """

    def __init__(self, spec: ChipSpec, params: Optional[TechParams] = None,
                 device=None):
        self._spec = spec
        self._params = params
        self._device = device  # where a missing calibration is fitted
        self._route: Dict[Tuple[str, Optional[str], Optional[float]],
                          ChipUnit] = {}
        self._health: Dict[str, UnitHealth] = {}
        #: bumped on every health / membership change — consumers holding
        #: derived routing state (the serving engine's fleet plan) compare
        #: against it instead of re-deriving per request
        self.health_version = 0

    @property
    def params(self) -> TechParams:
        if self._params is None:
            self._params = calibrate(device=self._device)
        return self._params

    @property
    def spec(self) -> ChipSpec:
        return self._spec

    @spec.setter
    def spec(self, new_spec: ChipSpec) -> None:
        """Fleet membership change: the bounded route cache MUST go with it
        (a stale entry would route to a unit no longer on the die)."""
        self._spec = new_spec
        names = {u.name for u in new_spec.units}
        self._health = {k: v for k, v in self._health.items() if k in names}
        self._invalidate_routes()

    def replace_spec(self, new_spec: ChipSpec) -> None:
        self.spec = new_spec

    def _invalidate_routes(self) -> None:
        self._route.clear()
        self.health_version += 1

    # -- health ------------------------------------------------------------
    def unit_health(self, name: str) -> UnitHealth:
        self.spec.unit(name)  # raises on unknown unit
        return self._health.get(name, UnitHealth())

    def set_health(self, name: str, status: str, *, freq_scale: float = 1.0,
                   reason: str = "", now: float = 0.0) -> UnitHealth:
        """Mark a unit's runtime health (the ``HealthMonitor`` writes here).
        Any change invalidates the bounded route cache — a stale entry
        would keep routing traffic to a dead unit."""
        self.spec.unit(name)  # raises on unknown unit
        h = UnitHealth(status=status, freq_scale=freq_scale, reason=reason,
                       since_s=now)
        prev = self._health.get(name)
        self._health[name] = h
        if prev is None or prev.status != h.status \
                or prev.freq_scale != h.freq_scale:
            self._invalidate_routes()
        return h

    def clear_health(self, name: Optional[str] = None) -> None:
        """Restore a unit (or all units) to healthy."""
        if name is None:
            changed = bool(self._health)
            self._health.clear()
        else:
            changed = self._health.pop(name, None) is not None
        if changed:
            self._invalidate_routes()

    def in_service(self, name: str) -> bool:
        return self.unit_health(name).in_service

    def in_service_units(self) -> Tuple[ChipUnit, ...]:
        return tuple(u for u in self.spec.units if self.in_service(u.name))

    def unit_time_scale(self, name: str) -> float:
        """Dispatch-time inflation of a unit: 1/freq_scale while throttled,
        inf when not in service (nothing completes on it)."""
        h = self.unit_health(name)
        if not h.in_service:
            return math.inf
        return 1.0 / h.freq_scale

    def unit_energy_scale(self, name: str) -> float:
        """Energy-per-FLOP repricing of a unit under its current health.

        A thermal/electrical throttle lowers frequency at (to first order)
        unchanged voltage: dynamic energy per op is constant, but leakage
        *power* is constant too, so leakage energy per op grows as
        1/freq_scale.  scale = dyn_share + leak_share / freq_scale, with
        the shares read off the unit's tuned metric row."""
        h = self.unit_health(name)
        if h.freq_scale >= 1.0:
            return 1.0
        m = self.spec.unit(name).metrics
        if "p_leak_mw" in m and float(m.get("p_total_mw", 0.0)) > 0.0:
            leak = float(m["p_leak_mw"]) / float(m["p_total_mw"])
        else:
            leak = _LEAK_SHARE_FALLBACK
        return (1.0 - leak) + leak / h.freq_scale

    def unit_energy_j(self, unit: ChipUnit, flops: float) -> float:
        """Joules for ``flops`` on ``unit`` at its *current* health (the
        health-aware form of ``ChipUnit.energy_j``)."""
        return unit.energy_j(flops) * self.unit_energy_scale(unit.name)

    def health_report(self) -> Dict[str, Dict[str, object]]:
        return {u.name: dict(status=self.unit_health(u.name).status,
                             freq_scale=self.unit_health(u.name).freq_scale,
                             reason=self.unit_health(u.name).reason,
                             in_service=self.in_service(u.name),
                             energy_scale=self.unit_energy_scale(u.name))
                for u in self.spec.units}

    # -- routing -----------------------------------------------------------
    def _unit_class(self, u: ChipUnit) -> str:
        tags = (u.name,) + u.phases
        return "latency" if any(workload_class(t) == "latency"
                                for t in tags) else "throughput"

    def unit_for_phase(self, phase: str,
                       precision: Optional[str] = None,
                       accuracy_slo: Optional[float] = None) -> ChipUnit:
        """Route an execution phase (or shape kind / shape name) to a unit.

        ``accuracy_slo`` restricts the candidate pool to units whose
        numerics error (``ChipUnit.rel_err``) meets the ceiling — the
        accuracy-class analogue of the precision filter.  When no unit on
        the die meets the SLO the most accurate one is routed (serving
        degrades to best-effort accuracy rather than rejecting traffic).

        Routing is **health-aware**: units not in service (dead /
        quarantined) never route; throttled units only route when no
        healthy unit survives the precision/accuracy filters (degrade,
        don't drop).  With every unit out of service there is nothing to
        degrade to — ``faults.UnitFault`` is raised.
        """
        key = (phase, precision, accuracy_slo)
        hit = self._route.get(key)
        if hit is not None:
            return hit
        alive = [u for u in self.spec.units if self.in_service(u.name)]
        if not alive:
            from repro_torch.faults import UnitFault
            raise UnitFault(
                f"chip {self.spec.name!r}: no unit in service "
                f"(health: { {u.name: self.unit_health(u.name).status for u in self.spec.units} })")
        pool = [u for u in alive
                if precision is None or u.design.precision == precision]
        pool = pool or alive
        healthy = [u for u in pool
                   if self.unit_health(u.name).status == UnitHealth.HEALTHY]
        pool = healthy or pool
        if accuracy_slo is not None:
            ok = [u for u in pool if u.rel_err() <= accuracy_slo]
            pool = ok or [min(pool, key=lambda u: u.rel_err())]
        exact = [u for u in pool if u.name == phase or phase in u.phases]
        cls = workload_class(phase)
        cand = exact or [u for u in pool if self._unit_class(u) == cls] or pool
        if len(cand) == 1:
            unit = cand[0]
        else:
            objective = _CLASS_OBJECTIVES[cls]
            cols = {k for k, _ in objective.terms}
            metrics = {k: np.asarray([u.metric(k) for u in cand])
                       for k in cols}
            unit = cand[obj.argbest(metrics, objective)]
        # phase/precision come from small closed sets, but accuracy_slo is
        # a caller-supplied float: cap the memo so arbitrary per-request
        # SLO values cannot grow the route cache without bound
        if len(self._route) < 4096:
            self._route[key] = unit
        return unit

    def admission_unit(self, precision: Optional[str] = None,
                       deadline_class: Optional[str] = None,
                       accuracy_slo: Optional[float] = None) -> ChipUnit:
        """Admission-time routing for one serving request: which decode
        fleet serves it.

        ``precision`` picks the SP vs DP fleet; ``deadline_class`` picks the
        microarchitecture class within it — ``None`` / ``'interactive'``
        (deadline-bound traffic) routes to the latency-class decode unit,
        ``'bulk'`` (no deadline, batch traffic) to the throughput-class
        unit of the same precision, the energy-proportional split the
        multi-format routing literature argues for.  ``accuracy_slo``
        routes by the request's *accuracy class* instead of (or on top of)
        its precision string: only units whose format meets the SLO
        compete, so loose-SLO traffic lands on the cheap sub-SP fleets and
        tight-SLO traffic keeps the wide-format units.
        """
        if deadline_class in (None, "interactive"):
            return self.unit_for_phase("decode", precision=precision,
                                       accuracy_slo=accuracy_slo)
        if deadline_class != "bulk":
            raise ValueError("deadline_class must be None, 'interactive' or "
                             f"'bulk', got {deadline_class!r}")
        # 'bulk' carries no latency tag -> throughput-class competition
        return self.unit_for_phase("bulk", precision=precision,
                                   accuracy_slo=accuracy_slo)

    def decode_fleet_units(self, precisions: Optional[Sequence[str]] = None,
                           deadline_routing: bool = False,
                           accuracy_slos: Sequence[Optional[float]] = (None,)
                           ) -> Tuple[ChipUnit, ...]:
        """The distinct units admission can route decode traffic to — one
        serving fleet per unit.  ``precisions`` defaults to every precision
        fabricated on the chip; ``deadline_routing`` adds the
        throughput-class ('bulk') fleets; ``accuracy_slos`` lists the
        accuracy classes admission will serve (each may resolve to a
        different format's unit)."""
        if precisions is None:
            precisions = sorted({u.design.precision for u in self.spec.units})
        classes = (None, "bulk") if deadline_routing else (None,)
        units: List[ChipUnit] = []
        seen = set()
        for p in precisions:
            for c in classes:
                for slo in (tuple(accuracy_slos) or (None,)):
                    u = self.admission_unit(precision=p, deadline_class=c,
                                            accuracy_slo=slo)
                    if u.name not in seen:
                        seen.add(u.name)
                        units.append(u)
        return tuple(units)

    def slot_fleets(self, n_slots: int,
                    precisions: Optional[Sequence[str]] = None,
                    deadline_routing: bool = False,
                    accuracy_slos: Sequence[Optional[float]] = (None,)
                    ) -> Dict[str, Tuple[int, ...]]:
        """Partition a serving engine's ``n_slots`` decode slots into
        per-unit fleets (unit name -> slot ids), sized proportional to each
        unit's instance count on the die."""
        return partition_slots(
            n_slots, self.decode_fleet_units(precisions=precisions,
                                             deadline_routing=deadline_routing,
                                             accuracy_slos=accuracy_slos))

    def select_fpu(self, workload: str, precision: Optional[str] = None
                   ) -> FPUDesign:
        """Design for a workload class ('throughput' | 'latency')."""
        if workload not in ("throughput", "latency"):
            raise ValueError(
                f"workload must be throughput|latency, got {workload!r}")
        return self.unit_for_phase(workload, precision=precision).design

    # -- numerics ----------------------------------------------------------
    def numerics_for_phase(self, phase: str,
                           fmt: Optional[FloatFormat] = BF16,
                           precision: Optional[str] = None,
                           accuracy_slo: Optional[float] = None,
                           emulate: bool = False) -> NumericsPolicy:
        """Policy of the unit routed for ``phase``.  ``fmt=None`` uses the
        routed unit's tuned operand format (bf16 fallback); the explicit
        bf16 default keeps the pre-transprecision behavior for positional
        callers."""
        return self.unit_for_phase(phase, precision=precision,
                                   accuracy_slo=accuracy_slo).numerics(
            fmt=fmt, emulate=emulate)

    # -- energy ------------------------------------------------------------
    def energy_per_flop_pj(self, phase: str,
                           precision: Optional[str] = None) -> float:
        return self.unit_for_phase(phase, precision=precision).e_per_flop_pj

    def request_energy_j(self, phase: str, flops: float,
                         precision: Optional[str] = None) -> float:
        """Energy attributed to ``flops`` executed on the routed unit."""
        return flops * self.energy_per_flop_pj(phase, precision) * 1e-12

    def step_energy_telemetry(self, phase: str, *, achieved_flops: float,
                              step_time_s: float, peak_flops: float,
                              adaptive_bb: bool = True,
                              precision: Optional[str] = None
                              ) -> Dict[str, object]:
        """Per-step telemetry on the routed unit, tagged with the unit."""
        u = self.unit_for_phase(phase, precision=precision)
        tele = unit_energy_telemetry(
            u.design, self.params, achieved_flops=achieved_flops,
            step_time_s=step_time_s, peak_flops=peak_flops,
            adaptive_bb=adaptive_bb, vdd=u.vdd, vbb_active=u.vbb)
        tele["unit"] = u.name
        tele["design"] = u.design.name
        tele["chip"] = self.spec.name
        return tele

    @staticmethod
    def aggregate_telemetry(reports: Sequence[Mapping[str, object]]
                            ) -> Dict[str, object]:
        """Chip-level rollup of per-step / per-request telemetry dicts."""
        per_unit: Dict[str, float] = {}
        total = 0.0
        for r in reports:
            j = float(r.get("joules_per_step", r.get("energy_j", 0.0)))
            unit = str(r.get("unit", "?"))
            per_unit[unit] = per_unit.get(unit, 0.0) + j
            total += j
        return dict(total_j=total, per_unit_j=per_unit, n_reports=len(reports))


# ---------------------------------------------------------------------------
# Stock chips + the (recalibration-safe) default policy cache
# ---------------------------------------------------------------------------
def default_chip(precision: str = "sp",
                 params: Optional[TechParams] = None,
                 device=None) -> ChipSpec:
    """The compatibility 2-unit die: the DSE throughput and latency optima
    for one precision — exactly the designs the legacy ``select_fpu``
    entry point handed out per workload class.  The sweeps run on
    ``device``."""
    params = params or calibrate(device=device)
    tp = best_throughput_design(precision, params, device=device)
    lat = best_latency_design(precision, params, device=device)
    units = (
        ChipUnit(f"{precision}_throughput", tp.design, tp.vdd, tp.vbb,
                 phases=("train", "prefill"), metrics=dict(tp.metrics)),
        ChipUnit(f"{precision}_latency", lat.design, lat.vdd, lat.vbb,
                 phases=("decode", "long"), metrics=dict(lat.metrics)),
    )
    return ChipSpec(f"default_{precision}", units)


def fabricated_chip(precision: Optional[str] = None,
                    params: Optional[TechParams] = None,
                    device=None) -> ChipSpec:
    """A die of the fabricated FPMax units at their Table I operating
    points (silicon-anchored metrics) — FMA units serve throughput phases,
    CMA units latency phases.  Without ``params`` the calibration runs on
    ``device``."""
    params = params or calibrate(device=device)
    units = []
    for name, d in FABRICATED.items():
        if precision is not None and d.precision != precision:
            continue
        m = TABLE_I[name]
        row = predict(d, params, vdd=m.vdd, vbb=m.vbb, anchored=True)
        phases = ("train", "prefill") if d.style == "fma" \
            else ("decode", "long")
        units.append(ChipUnit(name, d, m.vdd, m.vbb, phases=phases,
                              metrics=row))
    return ChipSpec(f"fpmax_{precision or 'sp_dp'}", tuple(units))


#: ChipPolicy instances keyed by (precision, resolved TechParams).  The
#: params are resolved *before* keying — unlike the old ``select_fpu``
#: ``lru_cache`` on an ``Optional[TechParams]`` default, a recalibration
#: (new TechParams values) can never be shadowed by a stale None entry.
_DEFAULT_POLICIES: Dict[Tuple[str, TechParams], ChipPolicy] = {}


def default_policy(precision: str = "sp",
                   params: Optional[TechParams] = None,
                   device=None) -> ChipPolicy:
    params = params or calibrate(device=device)
    key = (precision, params)
    pol = _DEFAULT_POLICIES.get(key)
    if pol is None:
        pol = ChipPolicy(default_chip(precision, params, device=device),
                         params, device=device)
        _DEFAULT_POLICIES[key] = pol
    return pol


def clear_policy_cache() -> None:
    _DEFAULT_POLICIES.clear()


# ---------------------------------------------------------------------------
# Chip tuning
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """One execution phase of the chip workload to provision a unit for.

    ``accuracy_slo`` (normwise-relative-error ceiling) and ``formats``
    (candidate operand formats) turn the phase's tune into a joint
    structure x electrical x format search (see ``autotune``): a loose SLO
    lets a throughput phase downshift to a sub-SP transprecision format, a
    tight one pins the wide format.  Both default to the chip-level
    arguments of ``tune_chip``; ``None`` everywhere = the format-agnostic
    legacy search.
    """

    name: str
    profile: at.WorkloadProfile
    precision: str = "sp"
    flops_fraction: float = 1.0  # share of chip FLOPs issued in this phase
    designs: Optional[Tuple[FPUDesign, ...]] = None  # default: full enum
    anchored: bool = False
    constraints: Tuple[obj.Constraint, ...] = ()
    accuracy_slo: Optional[float] = None
    formats: Optional[Tuple[FloatFormat, ...]] = None


def phases_from_config(arch: str,
                       shapes: Sequence[str] = ("train_4k", "decode_32k"),
                       results_dir: Optional[str] = "results",
                       activity: Optional[Dict[str, float]] = None
                       ) -> List[PhaseSpec]:
    """Config-derived chip workload: one phase per workload shape, FLOP
    shares from the roofline model-FLOP estimate, activities from measured
    dry-run utilizations where available (``results_dir``)."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.roofline.analysis import model_flops_estimate
    cfg = get_config(arch)
    weights = {s: model_flops_estimate(cfg, SHAPES[s]) for s in shapes}
    total = sum(weights.values())
    out = []
    for s in shapes:
        act = (activity or {}).get(s)
        profile = at.profile_from_config(arch, s, activity=act,
                                         results_dir=results_dir)
        out.append(PhaseSpec(s, profile, precision=cfg.numerics_precision,
                             flops_fraction=weights[s] / total))
    return out


@dataclasses.dataclass
class ChipTuneResult:
    spec: ChipSpec
    policy: ChipPolicy
    phases: List[PhaseSpec]
    tunes: List[at.TuneResult]
    report: Dict[str, object]

    def as_dict(self) -> Dict[str, object]:
        return dict(chip=self.spec.as_dict(), report=self.report)


def _fleet_counts(phases: Sequence[PhaseSpec], tunes: Sequence[at.TuneResult],
                  area_budget_mm2: float, tdp_budget_mw: float) -> List[int]:
    """Service-balanced fleet sizing: instances per unit proportional to the
    phase's FLOP share over the unit's delivered GFLOPS, scaled to the
    tightest budget.  Unbudgeted chips get one instance per unit."""
    demand = []
    for ph, t in zip(phases, tunes):
        pen = t.metrics.get("avg_latency_penalty", 0.0)
        g_eff = 2.0 * t.metrics["freq_ghz"] / (1.0 + pen) \
            * ph.profile.activity
        demand.append(ph.flops_fraction / g_eff)
    scales = []
    if math.isfinite(area_budget_mm2):
        scales.append(area_budget_mm2 / sum(
            d * t.metrics["area_mm2"] for d, t in zip(demand, tunes)))
    if math.isfinite(tdp_budget_mw):
        scales.append(tdp_budget_mw / sum(
            d * t.metrics["p_total_mw"] for d, t in zip(demand, tunes)))
    if not scales:
        return [1] * len(phases)
    s = min(scales)
    counts = [max(1, int(s * d)) for d in demand]
    # forcing >=1 instance of every unit can overshoot a tight budget;
    # shed instances from the largest shrinkable contributor until it fits
    # (all-singleton overshoot is a genuine infeasibility — ChipSpec raises)
    areas = [t.metrics["area_mm2"] for t in tunes]
    powers = [t.metrics["p_total_mw"] for t in tunes]
    while True:
        over_area = math.isfinite(area_budget_mm2) and sum(
            c * a for c, a in zip(counts, areas)) > area_budget_mm2
        over_tdp = math.isfinite(tdp_budget_mw) and sum(
            c * p for c, p in zip(counts, powers)) > tdp_budget_mw
        if not (over_area or over_tdp):
            return counts
        cost = areas if over_area else powers
        shrinkable = [i for i in range(len(counts)) if counts[i] > 1]
        if not shrinkable:
            return counts
        counts[max(shrinkable, key=lambda i: counts[i] * cost[i])] -= 1


def tune_chip(phases: Sequence[PhaseSpec], *,
              area_budget_mm2: float = math.inf,
              tdp_budget_mw: float = math.inf,
              params: Optional[TechParams] = None,
              vdd_grid: np.ndarray = at.TUNE_VDD_GRID,
              vbb_grid: np.ndarray = at.TUNE_VBB_GRID,
              cache=at.DEFAULT_CACHE,
              accuracy_slo: Optional[float] = None,
              accuracy_model=None,
              name: str = "chip",
              device=None) -> ChipTuneResult:
    """Tune a heterogeneous unit mix for a multi-phase workload.

    Per phase, the workload autotuner searches the full vectorized
    (design x V_DD x V_BB) grid on ``device`` through the shared
    ``SweepExecutableCache`` (one set of device buffers per grid shape per
    process), with per-unit budget
    feasibility folded in as ``objective.Constraint`` rows.  The fleet is
    then sized service-balanced under the die-area and TDP budgets.  With
    two phases and open budgets this degenerates to exactly the Table I
    throughput/latency split ``autotune`` picks per workload.

    ``accuracy_slo`` is the chip-level default accuracy ceiling applied to
    every phase that does not set its own (``PhaseSpec.accuracy_slo``
    wins); any phase with an SLO or an explicit ``formats`` candidate set
    searches jointly over structure x electrical point x operand format and
    its unit carries the tuned ``fmt``.  With no SLO anywhere the search is
    the format-agnostic path, output-identical to ``autotune`` without
    formats.
    """
    phases = list(phases)
    if not phases:
        raise ValueError("tune_chip needs at least one phase")
    params = params or calibrate(device=device)
    budget_cons: Tuple[obj.Constraint, ...] = ()
    if math.isfinite(area_budget_mm2):
        budget_cons += (obj.Constraint("area_mm2", hi=area_budget_mm2),)
    if math.isfinite(tdp_budget_mw):
        budget_cons += (obj.Constraint("p_total_mw", hi=tdp_budget_mw),)
    tunes = [
        at.autotune(ph.profile, precision=ph.precision,
                    designs=ph.designs, params=params,
                    vdd_grid=vdd_grid, vbb_grid=vbb_grid,
                    anchored=ph.anchored,
                    constraints=ph.constraints + budget_cons, cache=cache,
                    formats=ph.formats,
                    accuracy_slo=(ph.accuracy_slo if ph.accuracy_slo
                                  is not None else accuracy_slo),
                    accuracy_model=accuracy_model, device=device)
        for ph in phases
    ]
    counts = _fleet_counts(phases, tunes, area_budget_mm2, tdp_budget_mw)
    units = tuple(
        ChipUnit(ph.name, t.design, t.vdd, t.vbb, count=c,
                 phases=(ph.name, ph.profile.name),
                 activity=ph.profile.activity, metrics=dict(t.metrics),
                 fmt=t.fmt)
        for ph, t, c in zip(phases, tunes, counts))
    spec = ChipSpec(name, units, area_budget_mm2=area_budget_mm2,
                    tdp_budget_mw=tdp_budget_mw)
    policy = ChipPolicy(spec, params, device=device)
    per_unit = []
    for ph, t, u in zip(phases, tunes, units):
        static_pj = at.static_bb_energy(t)
        row = u.as_dict()
        row.update(flops_share=ph.flops_fraction,
                   static_bb_e_pj=static_pj,
                   adaptive_bb_saving=static_pj / t.metrics["e_eff_pj"],
                   n_points=t.n_points, objective=t.objective_name)
        slo = ph.accuracy_slo if ph.accuracy_slo is not None else accuracy_slo
        if slo is not None:
            row["accuracy_slo"] = slo
        per_unit.append(row)
    report = dict(
        chip=spec.as_dict(), units=per_unit,
        distinct_designs=len({u.design.name for u in units}),
        cache_stats=dict(cache.stats) if cache is not None else {})
    return ChipTuneResult(spec, policy, phases, tunes, report)
