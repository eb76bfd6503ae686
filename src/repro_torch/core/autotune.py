"""Workload-aware FPU autotuner over ``SweepResult`` (the paper's core claim).
Counterpart of ``repro.core.autotune``.

FPMax's thesis is that there is no single best FPU: per-workload tuning of
the FPGen parameters (pipeline partition, Booth radix, tree topology) plus
the UTBB FDSOI electrical knobs (V_DD, V_BB) yields very different optima for
latency- vs throughput-bound workloads (Table I), and body-bias adaptation
recovers ~2x energy at low activity (Fig. 4).  This module closes the loop
the ROADMAP names: it takes an operation-mix/activity profile — hand-written,
extracted from a traced call (``core.trace``), or derived from a model config
(``configs``) — and searches the *full* expanded structural grid
(``enumerate_structures_full``) crossed with a finer electrical grid for the
energy-optimal design + operating point under that profile.

Pipeline (all vectorized, one sweep dispatch + one penalty dispatch, both on
the card unless ``device='cpu'``):

  1. ``sweep_arrays`` evaluates the (design x V_DD x V_BB) tensor through a
     ``SweepExecutableCache`` — entries are keyed by grid *shape* only (the
     SP and DP enumerations share one), so same-shape tunes reuse one set of
     device buffers;
  2. the profile's dependency mixture conditions the latency columns
     (``avg_latency_penalty`` / ``avg_delay_ns``) on *this* workload;
  3. ``attach_workload_metrics`` adds ``e_eff_pj``: stall-aware energy per
     FLOP at the profile's activity, with adaptive-body-bias idle leakage
     derived in closed form (``leak_bb_scale``) — no second model dispatch;
  4. ``core.objective.workload_objective`` scalarizes and ``argbest``
     selects, under optional metric constraints.

With ``formats=`` / ``accuracy_slo=`` the search runs jointly over FPU
structure x electrical point x operand format: every structure is
re-instantiated per format, all of them go through one sweep, and the
exact-rational ``AccuracyModel`` (host-side) scores each (format,
accumulation style) pair for the ``rel_err`` constraint.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import objective as obj
from repro_torch.core.body_bias import energy_per_flop, leak_bb_scale
from repro_torch.core.dse import (SweepResult, enumerate_structures_full,
                                  sweep_arrays)
from repro_torch.core.energy_model import (SweepExecutableCache, TechParams,
                                           calibrate)
from repro_torch.core.fpu_arch import FPUDesign
from repro_torch.core.latency_sim import SpecMix
from repro_torch.core.trace import OpProfile, summarize

# Finer electrical grid than the Fig. 3/4 figures use: a batched sweep
# point costs next to nothing.
TUNE_VDD_GRID = np.round(np.arange(0.50, 1.151, 0.025), 3)
TUNE_VBB_GRID = np.round(np.arange(0.0, 1.21, 0.15), 2)

#: process-wide sweep cache; every autotune() call shares it by default
DEFAULT_CACHE = SweepExecutableCache()


# ---------------------------------------------------------------------------
# Workload profiles
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Operation-mix + activity description of one workload.

    ``p_acc``/``p_mul``/``q_acc``/``q_mul`` parameterize the dependency
    mixture fed to the latency simulator (see ``SpecMix``): fractions of ops
    with accumulation / multiplication dependences and the geometric tails
    of their dependence distances (q=0 -> all distance 1, mean distance is
    1/(1-q)).  ``activity`` is the fraction of wall-clock the unit is busy
    (the Fig. 4 axis); ``adaptive_bb`` drops the forward body bias during
    idle phases.  ``w_area``/``w_delay`` are the scalarization exponents of
    ``objective.workload_objective`` — throughput workloads price silicon
    area (many units per die), latency workloads price per-op delay.
    """

    name: str
    p_acc: float
    p_mul: float
    q_acc: float = 0.0
    q_mul: float = 0.3
    activity: float = 1.0
    adaptive_bb: bool = True
    w_area: float = 1.0
    w_delay: float = 0.0
    n_ops: int = 20_000
    seed: int = 0

    def mix(self) -> SpecMix:
        return SpecMix(self.p_acc, self.p_mul, self.q_acc, self.q_mul,
                       n_ops=self.n_ops, seed=self.seed)

    def objective(self) -> obj.Objective:
        return obj.workload_objective(f"workload:{self.name}",
                                      self.w_area, self.w_delay)


#: GEMM-like streaming mix: accumulation lanes are interleaved across output
#: elements, so dependences are rare and distant; stalls are hidden and the
#: optimum is throughput-shaped (area priced, delay not).
GEMM_STREAM = WorkloadProfile("gemm_stream", p_acc=0.05, p_mul=0.02,
                              q_acc=0.9, q_mul=0.5, activity=1.0,
                              w_area=1.0, w_delay=0.0)

#: Dependent-chain mix: a scalar/recurrent accumulation (distance-1 acc
#: dependences dominate) — the latency-critical case CMA forwarding targets.
DEPENDENT_CHAIN = WorkloadProfile("dependent_chain", p_acc=0.85, p_mul=0.10,
                                  q_acc=0.0, q_mul=0.3, activity=1.0,
                                  w_area=0.0, w_delay=1.0)

#: The GEMM mix at 10% activity — the paper's Fig. 4 low-utilization corner
#: where adaptive body bias recovers ~2x energy/op.
GEMM_LOW_ACTIVITY = dataclasses.replace(GEMM_STREAM,
                                        name="gemm_low_activity",
                                        activity=0.10)

PROFILES: Dict[str, WorkloadProfile] = {
    p.name: p for p in (GEMM_STREAM, DEPENDENT_CHAIN, GEMM_LOW_ACTIVITY)
}


def profile_from_trace(name: str, profiles: List[OpProfile],
                       activity: float = 1.0, interleave: int = 1,
                       adaptive_bb: bool = True) -> WorkloadProfile:
    """Build a profile from a traced dependency profile (``trace.py``).

    ``interleave`` is the number of independent accumulation lanes
    round-robined on one unit (software pipelining / multiple output
    elements in flight): it stretches dependence distances to ~interleave
    (geometric tail ``1 - 1/interleave``) and proportionally de-weights the
    delay term of the objective, since stalls overlap with other lanes.
    """
    s = summarize(profiles)
    dep = float(np.clip(s["chain_flop_frac"], 0.0, 0.95))
    interleave = max(int(interleave), 1)
    w_delay = dep / interleave
    return WorkloadProfile(
        name, p_acc=dep, p_mul=0.05, q_acc=1.0 - 1.0 / interleave,
        q_mul=0.3, activity=activity, adaptive_bb=adaptive_bb,
        w_area=1.0 - w_delay, w_delay=w_delay)


def profile_from_config(arch: str, shape: str = "train_4k",
                        activity: float | None = None,
                        results_dir: str | None = "results"
                        ) -> WorkloadProfile:
    """Profile for a model config + workload shape (``configs``).

    The activity level is resolved in priority order: an explicit
    ``activity`` argument; the *measured* roofline utilization of the
    (arch, shape) cell from the dry-run artifacts under ``results_dir``
    (``roofline.analysis.measured_utilization``, which reads the JSON
    artifacts only); and finally the documented heuristic constants
    (train/prefill 0.8, decode 0.15).

    The mix mapping: train/prefill shapes are GEMM-dominated with deep
    interleaving (throughput-shaped); decode shapes are small-batch with
    short dependent chains and low matrix-unit activity (latency-leaning,
    leakage-dominated) — the split the paper draws between its throughput
    and latency FPUs.
    """
    from repro_torch.configs.base import SHAPES, get_config
    get_config(arch)  # validate the arch id
    kind = SHAPES[shape].kind
    if activity is None and results_dir is not None:
        from repro_torch.roofline.analysis import measured_utilization
        meas = measured_utilization(arch, shape, results_dir)
        if meas is not None:
            activity = float(np.clip(meas, 0.01, 1.0))
    if kind in ("train", "prefill"):
        act = 0.8 if activity is None else activity
        return dataclasses.replace(GEMM_STREAM, name=f"{arch}:{shape}",
                                   activity=act)
    act = 0.15 if activity is None else activity
    return WorkloadProfile(f"{arch}:{shape}", p_acc=0.45, p_mul=0.10,
                           q_acc=0.3, q_mul=0.3, activity=act,
                           w_area=0.3, w_delay=0.7)


# ---------------------------------------------------------------------------
# Workload-conditioned metrics
# ---------------------------------------------------------------------------
def attach_workload_metrics(res: SweepResult, profile: WorkloadProfile,
                            params: TechParams,
                            vbb_idle: float = 0.0) -> SweepResult:
    """Add ``e_eff_pj`` (stall-aware pJ/FLOP at the profile's activity).

    Requires a sweep computed ``with_latency=True`` on the profile's own
    mixture so ``avg_latency_penalty``/``avg_delay_ns`` are already
    workload-conditioned.  Idle leakage under adaptive BB is the active
    leakage rescaled by the closed-form ``leak_bb_scale`` ratio, so no extra
    model dispatch is needed.
    """
    pen = res.metrics["avg_latency_penalty"]
    idle = None
    if profile.adaptive_bb:
        idle = res.metrics["p_leak_mw"] * leak_bb_scale(params, res.vbb,
                                                        vbb_idle)
    res.metrics["e_eff_pj"] = energy_per_flop(
        res.metrics["e_op_pj"], res.metrics["p_leak_mw"],
        res.metrics["freq_ghz"], profile.activity,
        p_leak_idle_mw=idle, penalty=pen)
    return res


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TuneResult:
    profile: WorkloadProfile
    design: FPUDesign
    vdd: float
    vbb: float
    metrics: Dict[str, float]  # full metric row at the chosen point
    index: int
    n_points: int
    objective_name: str
    cache_stats: Dict[str, int]
    #: operand format chosen by a format-joint tune (``formats=`` /
    #: ``accuracy_slo=``); None on format-agnostic tunes, whose datapath is
    #: the precision class's native format.
    fmt: object = None

    @property
    def key(self) -> str:
        return f"{self.design.name}@{self.vdd:.3f}V/bb{self.vbb:.2f}"

    @property
    def format(self):
        """The tuned operand format (class-native when format-agnostic)."""
        if self.fmt is not None:
            return self.fmt
        from repro_torch.numerics import native_format
        return native_format(self.design.precision)

    def as_dict(self) -> Dict[str, object]:
        out = dict(profile=self.profile.name, design=self.design.name,
                   vdd=self.vdd, vbb=self.vbb, n_points=self.n_points,
                   objective=self.objective_name,
                   e_eff_pj=self.metrics["e_eff_pj"],
                   gflops_per_w=self.metrics["gflops_per_w"],
                   gflops_per_mm2=self.metrics["gflops_per_mm2"],
                   avg_delay_ns=self.metrics["avg_delay_ns"],
                   freq_ghz=self.metrics["freq_ghz"])
        if self.fmt is not None:
            out["fmt"] = self.fmt.name
            if obj.ACCURACY_METRIC in self.metrics:
                out[obj.ACCURACY_METRIC] = self.metrics[obj.ACCURACY_METRIC]
        return out


def autotune(profile: WorkloadProfile,
             precision: str = "sp",
             designs: Sequence[FPUDesign] | None = None,
             params: TechParams | None = None,
             vdd_grid: np.ndarray = TUNE_VDD_GRID,
             vbb_grid: np.ndarray = TUNE_VBB_GRID,
             anchored: bool = False,
             constraints: Sequence[obj.Constraint] = (),
             cache: SweepExecutableCache | None = DEFAULT_CACHE,
             vbb_idle: float = 0.0,
             formats: Sequence[object] | None = None,
             accuracy_slo: float | None = None,
             accuracy_model=None,
             device=None) -> TuneResult:
    """Search design x (V_DD, V_BB) [x format] for the profile's optimum.

    ``designs`` defaults to the full expanded enumeration for ``precision``;
    pass e.g. the four fabricated units (with ``anchored=True``) to tune
    over silicon-exact numbers.  Warm same-shape calls reuse the cache's
    device buffers and the penalty cache.  The sweep and the latency
    simulator run on ``device`` (the card unless ``device='cpu'``).

    With ``formats`` (candidate operand formats — names or
    ``FloatFormat``s) and/or ``accuracy_slo`` (normwise-relative-error
    ceiling, see ``objective.accuracy_constraint``) the search runs
    *jointly* over FPU structure x electrical point x format: every
    candidate structure is re-instantiated per format via
    ``FPUDesign.with_format`` and an ``rel_err`` column from the
    exact-rational ``AccuracyModel`` gates feasibility.  ``accuracy_slo``
    without ``formats`` searches the registry ladder of the precision
    class.  With neither argument the format-agnostic path runs unchanged.
    """
    params = params or calibrate(device=device)
    designs = list(designs) if designs is not None \
        else enumerate_structures_full(precision)
    if formats is None and accuracy_slo is None:
        res = sweep_arrays(designs, params, vdd_grid, vbb_grid,
                           mix=profile.mix(), with_latency=True,
                           anchored=anchored, cache=cache, device=device)
        attach_workload_metrics(res, profile, params, vbb_idle=vbb_idle)
        objective = profile.objective()
        i = res.argbest(objective, constraints)
        return TuneResult(
            profile=profile, design=res.design_of(i),
            vdd=float(res.vdd[i]), vbb=float(res.vbb[i]),
            metrics={k: float(v[i]) for k, v in res.metrics.items()},
            index=i, n_points=len(res), objective_name=objective.name,
            cache_stats=dict(cache.stats) if cache is not None else {})

    from repro_torch import numerics as rn
    cand = tuple(rn.get_format(f) for f in formats) if formats is not None \
        else rn.REGISTRY.formats_for(precision)
    if not cand:
        raise ValueError("formats candidate set is empty")
    amodel = accuracy_model or rn.DEFAULT_ACCURACY_MODEL
    all_designs: List[FPUDesign] = []
    fmt_of_design: List[object] = []
    for f in cand:
        all_designs.extend(d.with_format(f) for d in designs)
        fmt_of_design.extend([f] * len(designs))
    res = sweep_arrays(all_designs, params, vdd_grid, vbb_grid,
                       mix=profile.mix(), with_latency=True,
                       anchored=anchored, cache=cache, device=device)
    attach_workload_metrics(res, profile, params, vbb_idle=vbb_idle)
    # per-point numerics error: the (format, accumulation-style) pair's
    # oracle score (cached inside the model — one exact-rational run per
    # distinct pair, shared across all electrical points)
    per_design_err = np.asarray([
        amodel.rel_err(f, rn.accum_style_for(d.style, d.forwarding))
        for d, f in zip(all_designs, fmt_of_design)])
    res.metrics[obj.ACCURACY_METRIC] = per_design_err[res.design_index]
    cons = tuple(constraints)
    if accuracy_slo is not None:
        cons += (obj.accuracy_constraint(accuracy_slo),)
    objective = profile.objective()
    i = res.argbest(objective, cons)
    return TuneResult(
        profile=profile, design=res.design_of(i),
        vdd=float(res.vdd[i]), vbb=float(res.vbb[i]),
        metrics={k: float(v[i]) for k, v in res.metrics.items()},
        index=i, n_points=len(res), objective_name=objective.name,
        cache_stats=dict(cache.stats) if cache is not None else {},
        fmt=fmt_of_design[int(res.design_index[i])])


def static_bb_energy(result: TuneResult) -> float:
    """pJ/FLOP at the tuned point if body bias were held *static* during
    idle phases (the Fig. 4 counterfactual: same design, same (V_DD, V_BB),
    leakage stays at the active level over all of wall-clock)."""
    m = result.metrics
    return float(energy_per_flop(m["e_op_pj"], m["p_leak_mw"],
                                 m["freq_ghz"], result.profile.activity,
                                 penalty=m["avg_latency_penalty"]))


def autotune_for_config(arch: str, shape: str = "train_4k",
                        **kw) -> TuneResult:
    """Tune for a model config: profile + precision derived from the config."""
    from repro_torch.configs.base import get_config
    profile = profile_from_config(arch, shape)
    precision = get_config(arch).numerics_precision
    return autotune(profile, precision=precision, **kw)


def tune_split(precision: str = "sp",
               throughput_profile: WorkloadProfile = GEMM_STREAM,
               latency_profile: WorkloadProfile = DEPENDENT_CHAIN,
               **kw) -> Tuple[TuneResult, TuneResult]:
    """The paper's Table I experiment: tune the same space for a
    throughput-heavy and a latency-critical mix; the optima differ."""
    return (autotune(throughput_profile, precision=precision, **kw),
            autotune(latency_profile, precision=precision, **kw))
