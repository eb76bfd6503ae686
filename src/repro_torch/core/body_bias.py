"""Body-bias energy policies (paper Fig. 4 and the 20% / 3x->1.5x claims).
Counterpart of ``repro.core.body_bias`` (numpy on ``predict``).

UTBB FDSOI exposes a wide-range body-bias knob: forward bias (FBB) lowers V_t
(faster, leakier), zero/reverse bias raises V_t (slower, much less leakage).
The paper's two results:

  1. At 100% activity, using FBB + a lower V_DD at iso-frequency cuts power
     ~13% and energy ~20% vs the no-BB design point.
  2. At 10% activity, keeping the 100%-activity (V_DD, V_t) makes leakage
     dominate: energy/op rises ~3x.  *Adaptively* raising V_t (lowering the
     FBB) during low-utilization periods brings this back to ~1.5x.

Utilization here is the fraction of cycles the unit is busy — in the
framework this is fed from the *roofline-measured* utilization of each
(arch x shape) workload, so telemetry can report J/step under each policy.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.energy_model import TechParams, calibrate, predict
from repro_torch.core.fpu_arch import FPUDesign


def iso_frequency_vdd(design: FPUDesign, params: TechParams,
                      f_target_ghz: float, vbb: float,
                      lo: float = 0.4, hi: float = 1.3) -> float:
    """Bisect V_DD so the design hits f_target at the given body bias."""
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        f = predict(design, params, vdd=mid, vbb=vbb)["freq_ghz"]
        if f < f_target_ghz:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def energy_per_flop(e_op_pj, p_leak_active_mw, freq_ghz, util,
                    p_leak_idle_mw=None, penalty=0.0):
    """Array-native pJ/FLOP at an activity level — the one activity/leakage
    accounting shared by ``energy_per_op``, the Fig. 4 curves, and the
    workload autotuner (all arguments broadcast).

    The unit is busy a fraction ``util`` of wall-clock; dynamic energy
    accrues per op, leakage accrues over wall-clock.  ``p_leak_idle_mw``
    models adaptive BB: during idle periods V_t is raised (bias removed) —
    UTBB FDSOI body bias slews fast enough to track phase-level activity
    (paper §Measurement).  ``penalty`` is the average stall cycles per op on
    the workload's dependency mixture: stalls stretch the busy phase at
    *active* leakage, i.e. the effective issue rate drops to
    ``freq / (1 + penalty)``.
    """
    e_dyn = np.asarray(e_op_pj, np.float64) / 2.0  # per FLOP (2 FLOP/FMAC)
    p_act = np.asarray(p_leak_active_mw, np.float64)
    p_idle = p_act if p_leak_idle_mw is None \
        else np.asarray(p_leak_idle_mw, np.float64)
    f_eff = np.asarray(freq_ghz, np.float64) / (1.0 + np.asarray(penalty))
    # wall-clock per FLOP = 1 / (2 f_eff util); active fraction util
    e_leak = (p_act * util + p_idle * (1.0 - util)) / (
        2.0 * f_eff * util)  # mW / GHz = pJ
    return e_dyn + e_leak


def leak_bb_scale(params: TechParams, vbb_from, vbb_to):
    """Leakage multiplier for a body-bias move at fixed V_DD.

    In the electrical model leakage depends on V_BB only through
    V_t = vt0 - k_bb * vbb and the subthreshold slope:
    p_leak ∝ 10^(-V_t / s_leak_dec), so the ratio is closed-form — the
    autotuner uses it to derive idle-leakage columns for a whole sweep
    without a second batched dispatch.  Anchored per-design leak corrections
    are multiplicative and cancel in the ratio.
    """
    return 10.0 ** (params.k_bb * (np.asarray(vbb_to, np.float64)
                                   - np.asarray(vbb_from, np.float64))
                    / params.s_leak_dec)


def energy_per_op(design: FPUDesign, params: TechParams, *,
                  vdd: float, vbb_active: float, vbb_idle: float | None,
                  util: float) -> Dict[str, float]:
    """pJ/FLOP at a utilization level (scalar, single design/point).

    Thin wrapper over ``energy_per_flop`` — see there for the model.
    """
    p = predict(design, params, vdd=vdd, vbb=vbb_active)
    f = p["freq_ghz"]
    e_dyn = p["e_op_pj"] / 2.0  # per FLOP (2 FLOP per FMAC op)
    leak_active_mw = p["p_leak_mw"]
    if vbb_idle is None:
        leak_idle_mw = leak_active_mw
    else:
        leak_idle_mw = predict(design, params, vdd=vdd, vbb=vbb_idle)[
            "p_leak_mw"]
    e_total = float(energy_per_flop(p["e_op_pj"], leak_active_mw, f, util,
                                    p_leak_idle_mw=leak_idle_mw))
    return dict(e_dyn_pj=e_dyn, e_leak_pj=e_total - e_dyn,
                e_total_pj=e_total, freq_ghz=f)


def bb_study(design: FPUDesign, params: TechParams | None = None,
             util_low: float = 0.10, vdd: float | None = None,
             vbb_idle: float = 0.45, device=None) -> Dict[str, float]:
    """Reproduce the paper's three body-bias claims for one design.

    The 3x / 1.5x low-utilization numbers are quoted by the paper on the
    Fig. 4 energy-efficient operating points (low V_DD), so callers pass the
    energy-optimal vdd rather than the nominal one.  vbb_idle models the
    *partial* FBB removal achievable at phase-level adaptation granularity.
    ``device`` is where ``calibrate`` runs when ``params`` is not given.
    """
    params = params or calibrate(device=device)
    vdd_bb, vbb = (design.vdd if vdd is None else vdd), 1.2
    f_nominal = predict(design, params, vdd=vdd_bb, vbb=vbb)["freq_ghz"]
    # no-BB design must raise V_DD to hit the same frequency
    vdd_nobb = iso_frequency_vdd(design, params, f_nominal, vbb=0.0)

    e_bb = energy_per_op(design, params, vdd=vdd_bb, vbb_active=vbb,
                         vbb_idle=None, util=1.0)
    e_nobb = energy_per_op(design, params, vdd=vdd_nobb, vbb_active=0.0,
                           vbb_idle=None, util=1.0)
    # low utilization: static BB keeps (vdd, vbb); adaptive drops FBB to 0
    e_low_static = energy_per_op(design, params, vdd=vdd_bb, vbb_active=vbb,
                                 vbb_idle=None, util=util_low)
    e_low_adapt = energy_per_op(design, params, vdd=vdd_bb, vbb_active=vbb,
                                vbb_idle=vbb_idle, util=util_low)
    return dict(
        vdd_bb=vdd_bb, vdd_nobb=vdd_nobb, freq_ghz=f_nominal,
        e_full_bb_pj=e_bb["e_total_pj"],
        e_full_nobb_pj=e_nobb["e_total_pj"],
        bb_energy_saving=1.0 - e_bb["e_total_pj"] / e_nobb["e_total_pj"],
        low_util_static_ratio=e_low_static["e_total_pj"] / e_bb["e_total_pj"],
        low_util_adaptive_ratio=e_low_adapt["e_total_pj"] / e_bb["e_total_pj"],
    )


def energy_vs_utilization(design: FPUDesign, params: TechParams | None = None,
                          utils: np.ndarray | None = None, device=None):
    """Fig.4-style curves: energy/op vs utilization, static vs adaptive BB.

    Array-native: the model is evaluated once per body-bias point and the
    whole utilization axis is computed by broadcasting (the electrical state
    does not depend on utilization; only the leakage-vs-wallclock accounting
    does), so the curve resolution is free.  ``device`` is where
    ``calibrate`` runs when ``params`` is not given.
    """
    params = params or calibrate(device=device)
    utils = np.asarray(utils if utils is not None
                       else np.geomspace(0.01, 1.0, 25), np.float64)
    p = predict(design, params, vdd=design.vdd, vbb=1.2)
    p_idle = predict(design, params, vdd=design.vdd, vbb=0.0)
    static = energy_per_flop(p["e_op_pj"], p["p_leak_mw"], p["freq_ghz"],
                             utils)
    adaptive = energy_per_flop(p["e_op_pj"], p["p_leak_mw"], p["freq_ghz"],
                               utils, p_leak_idle_mw=p_idle["p_leak_mw"])
    return utils, static, adaptive
