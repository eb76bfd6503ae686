"""Analytical energy / delay / area model for FPGen designs, calibrated to
the FPMax silicon (Table I).  Counterpart of ``repro.core.energy_model``.

The model is feature-based: each design maps to structural features
(multiplier array, datapath adders/shifters, pipeline registers, bypass) with
*fitted* component coefficients, and an electrical layer (alpha-power delay,
body-biased threshold, subthreshold leakage) with *fitted-but-priored*
technology constants.  Rationale: the paper gives four silicon points; a
hand-chosen gate-level cap breakdown cannot be identified from 16 observables,
so component ratios are fitted while physics stays in a plausible 28nm FDSOI
range via log-normal priors (V_t0 ~ 0.35V LVT, k_bb ~ 85mV/V, FO4 ~ 14ps,
alpha ~ 1.4, subthreshold-swing decade ~ 0.1V).

Two usage modes:
  * global fit (honest): predictions from the fitted model; residuals vs
    Table I are reported by ``calibration_report``.
  * anchored: per-fabricated-design multiplicative corrections make the four
    silicon points exact, and the DSE explores their structural/voltage
    neighborhood (how the paper presents Fig. 3/4).

Where the JAX package runs ``jax.jit``/``vmap`` in float64, the port runs one
broadcast torch evaluation on float64 tensors (``backend="torch"``, on the
card unless ``device="cpu"``); the numpy twins stay numpy, so
``backend="numpy"``, ``predict`` and ``predict_grid`` are bitwise the
reference's.  ``calibrate`` fits in float32 with torch autograd and Adam
written out as the reference writes it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.fpu_arch import FABRICATED, TABLE_I, FPUDesign

# ---------------------------------------------------------------------------
# Structural features (static per design)
# ---------------------------------------------------------------------------
_WIRE = {"wallace": 1.3, "zm": 1.0, "array": 0.85}
_TREE_LVL_FO4 = {"wallace": 3.7, "zm": 2.8, "array": 2.2}


def design_features(d: FPUDesign) -> Dict[str, float]:
    """Raw structural features in relative cap units (pre-coefficient)."""
    w = d.sig_bits
    n = d.n_partial_products
    f = {}
    # multiplier: booth encoders/muxes + PP reduction tree (+3x adder)
    f["mul"] = (0.9 * n * w + (2.5 * w if d.booth == 3 else 0.0)
                + (n - 2) * w * _WIRE[d.tree])
    # datapath (CPA, align, norm, round); CMA has a standalone FP adder
    if d.style == "fma":
        f["dp_fma"] = (0.6 * 2 * w * math.log2(2 * w)
                       + 0.5 * 3 * w * math.log2(3 * w)
                       + 0.5 * 2 * w * math.log2(2 * w) + 1.2 * w)
        f["dp_cma"] = 0.0
        path_w = 5.0 * w
    else:
        f["dp_fma"] = 0.0
        f["dp_cma"] = (0.6 * 2 * w * math.log2(2 * w) + 1.2 * w  # mul CPA+rnd
                       + 2.2 * (w + 4) * math.log2(w + 4))  # standalone adder
        path_w = 3.4 * w
    f["regs"] = d.stages * path_w
    f["bypass"] = (1.5 * w) if d.forwarding else 0.0
    return f


def logic_depth_fo4(d: FPUDesign) -> float:
    """End-to-end unpipelined critical path, FO4 units."""
    if d.style == "fma":
        return _fma_depth(d)
    mul_d, add_d = _cma_path_depths(d)
    return mul_d + add_d


def _booth_tree_depth(d: FPUDesign) -> float:
    w = d.sig_bits
    booth_d = 5.0 + (0.6 * 1.5 * math.log2(w) if d.booth == 3 else 0.0)
    tree_d = d.tree_depth_levels * _TREE_LVL_FO4[d.tree]
    return booth_d + tree_d


def _fma_depth(d: FPUDesign) -> float:
    w = d.sig_bits
    align_d = 1.0 * math.log2(3 * w)
    cpa_d = 1.2 * math.log2(2 * w) + 2
    norm_d = 1.2 * math.log2(2 * w) + 2
    return max(_booth_tree_depth(d), align_d) + cpa_d + norm_d + 3.0


def _cma_path_depths(d: FPUDesign) -> Tuple[float, float]:
    w = d.sig_bits
    mul_d = _booth_tree_depth(d) + (1.2 * math.log2(2 * w) + 2) + 2.0
    add_d = (1.0 * math.log2(w + 4) + (1.2 * math.log2(w + 4) + 2)
             + (1.2 * math.log2(w) + 2) + 3.0)
    return mul_d, add_d


def stage_depth_fo4(d: FPUDesign) -> float:
    """Critical per-stage logic depth after retiming.

    FMA: the monolithic path retimes across all stages.  CMA: the multiply
    and add pipelines retime independently — the cycle is set by the worse
    path/stage ratio (an m3a1 CMA cannot hide a full FP add in one stage).
    """
    if d.style == "fma":
        return _fma_depth(d) / d.stages
    mul_d, add_d = _cma_path_depths(d)
    return max(mul_d / d.mul_stages, add_d / d.add_stages, 4.0)


_FEATURE_KEYS = ("mul", "dp_fma", "dp_cma", "regs", "bypass")


def _feature_vector(d: FPUDesign) -> Tuple[float, ...]:
    f = design_features(d)
    return tuple(f[k] for k in _FEATURE_KEYS)


# ---------------------------------------------------------------------------
# Technology + component parameters
# ---------------------------------------------------------------------------
# (name, init, prior_sigma_logspace)  sigma=None -> unconstrained scale param
_PARAM_SPEC = (
    # effective FO4 incl. synthesis sizing relaxation (energy-optimized
    # designs run far fewer gate-delays/ns than speed-optimized); free scale.
    ("tau_fo4_ns", 0.040, None),
    ("alpha", 1.40, 0.10),         # alpha-power exponent
    ("vt0", 0.35, 0.10),           # LVT Vt at zero BB
    ("k_bb", 0.085, 0.15),         # BB coefficient V/V
    ("s_leak_dec", 0.10, 0.15),    # V per decade of leakage
    ("s_cap", 3.0e-3, None),       # cap unit -> pJ/V^2
    ("s_leak", 10.0, None),        # leakage scale
    ("s_area", 1.0e-5, None),      # cap unit -> mm^2
    ("c_mul", 1.0, 0.7),           # component coefficients (weakly priored)
    ("c_dp_fma", 1.0, 0.7),
    ("c_dp_cma", 1.0, 0.7),
    ("c_regs", 1.0, 0.7),
    ("c_speed_cma", 1.0, 0.5),     # per-style synthesis sizing (freq) knobs
    ("c_speed_fma", 1.0, 0.5),
)
_PARAM_NAMES = tuple(s[0] for s in _PARAM_SPEC)


@dataclasses.dataclass(frozen=True)
class TechParams:
    values: Tuple[float, ...]

    def __getattr__(self, key):
        try:
            return self.values[_PARAM_NAMES.index(key)]
        except ValueError:
            raise AttributeError(key)

    def as_array(self) -> np.ndarray:
        return np.asarray(self.values)

    def __repr__(self):
        return "TechParams(" + ", ".join(
            f"{n}={v:.4g}" for n, v in zip(_PARAM_NAMES, self.values)) + ")"


_CLK_OVH_FO4 = 3.0
_IMBALANCE = 1.10


def _cap_total(pvec, feats):
    """Switched capacitance of each design: feats (..., 5) -> (...)."""
    coeffs = torch.stack([pvec[8], pvec[9], pvec[10], pvec[11],
                          torch.ones_like(pvec[0])])
    return torch.sum(coeffs * feats, dim=-1)


def _cap_total_np(pvec, feats) -> float:
    """NumPy twin of ``_cap_total`` (single design): the one coefficient
    layout shared by the scalar predictor and the format-scaling hook."""
    coeffs = np.array([pvec[8], pvec[9], pvec[10], pvec[11], 1.0])
    return float(np.sum(coeffs * np.asarray(feats)))


def _predict_core(pvec, feats, stage_depth, is_cma, vdd, vbb, util=1.0):
    """Broadcast electrical model on tensors.  pvec: parameters in
    _PARAM_SPEC order; feats (..., 5); stage_depth, is_cma, vdd and vbb
    broadcast against feats' leading shape (the batched twin of the
    reference's vmapped ``_predict_core``)."""
    tau, alpha, vt0, k_bb, s_dec, s_cap, s_leak, s_area = pvec[:8].unbind()
    speed = torch.where(is_cma, pvec[12], pvec[13])
    cap = _cap_total(pvec, feats)
    vt = vt0 - k_bb * vbb
    num = vdd / torch.clamp(vdd - vt, min=1e-3) ** alpha
    den = 1.0 / (1.0 - vt0) ** alpha
    dscale = num / den
    cycle_ns = tau / speed * (stage_depth * _IMBALANCE
                              + _CLK_OVH_FO4) * dscale
    freq_ghz = 1.0 / cycle_ns
    # faster sizing costs capacitance: cap_eff = cap * speed^0.5
    cap_eff = cap * speed ** 0.5
    e_op_pj = s_cap * cap_eff * vdd * vdd
    p_dyn_mw = e_op_pj * freq_ghz * util
    p_leak_mw = s_leak * (cap_eff * 1e-4) * vdd * torch.pow(10.0, -vt / s_dec)
    area_mm2 = s_area * cap_eff
    return dict(cycle_ns=cycle_ns, freq_ghz=freq_ghz, e_op_pj=e_op_pj,
                p_dyn_mw=p_dyn_mw, p_leak_mw=p_leak_mw,
                p_total_mw=p_dyn_mw + p_leak_mw, area_mm2=area_mm2)


def _predict_np(pvec, feats, stage_depth, is_cma, vdd, vbb, util=1.0):
    """NumPy twin of _predict_core (vectorized over vdd/vbb grids).

    Kept formula-identical; tests assert agreement with the torch version.
    """
    tau, alpha, vt0, k_bb, s_dec, s_cap, s_leak, s_area = pvec[:8]
    speed = pvec[12] if is_cma else pvec[13]
    cap = _cap_total_np(pvec, feats)
    vdd = np.asarray(vdd, np.float64)
    vbb = np.asarray(vbb, np.float64)
    vt = vt0 - k_bb * vbb
    num = vdd / np.maximum(vdd - vt, 1e-3) ** alpha
    den = 1.0 / (1.0 - vt0) ** alpha
    dscale = num / den
    cycle_ns = tau / speed * (stage_depth * _IMBALANCE
                              + _CLK_OVH_FO4) * dscale
    freq_ghz = 1.0 / cycle_ns
    cap_eff = cap * speed ** 0.5
    e_op_pj = s_cap * cap_eff * vdd * vdd
    p_dyn_mw = e_op_pj * freq_ghz * util
    p_leak_mw = s_leak * (cap_eff * 1e-4) * vdd * 10.0 ** (-vt / s_dec)
    area_mm2 = s_area * cap_eff * np.ones_like(vdd)
    return dict(cycle_ns=cycle_ns, freq_ghz=freq_ghz, e_op_pj=e_op_pj,
                p_dyn_mw=p_dyn_mw, p_leak_mw=p_leak_mw,
                p_total_mw=p_dyn_mw + p_leak_mw, area_mm2=area_mm2)


def predict_grid(d: FPUDesign, params: TechParams, vdd, vbb,
                 util: float = 1.0) -> Dict[str, np.ndarray]:
    """Vectorized metrics over broadcastable vdd/vbb arrays (numpy)."""
    out = _predict_np(params.as_array(), _feature_vector(d),
                      stage_depth_fo4(d),
                      d.style == "cma", vdd, vbb, util)
    gflops = 2.0 * out["freq_ghz"] * util
    out["gflops"] = gflops
    out["gflops_per_w"] = gflops / (out["p_total_mw"] * 1e-3)
    out["gflops_per_mm2"] = gflops / out["area_mm2"]
    return out


def predict(d: FPUDesign, params: TechParams, *, util: float = 1.0,
            vdd: float | None = None, vbb: float | None = None,
            anchored: bool = False) -> Dict[str, float]:
    """Full metric set for one design at one operating point."""
    vdd = d.vdd if vdd is None else vdd
    vbb = d.vbb if vbb is None else vbb
    out = _predict_np(params.as_array(), _feature_vector(d),
                      stage_depth_fo4(d),
                      d.style == "cma", vdd, vbb, util)
    out = {k: float(v) for k, v in out.items()}
    if anchored:
        corr = _anchor_corrections(params).get(d.name)
        if corr is not None:
            out["freq_ghz"] *= corr["freq"]
            out["cycle_ns"] /= corr["freq"]
            out["area_mm2"] *= corr["area"]
            out["p_leak_mw"] *= corr["leak"]
            out["p_dyn_mw"] *= corr["dyn"]
            out["e_op_pj"] *= corr["dyn"]
            out["p_total_mw"] = out["p_dyn_mw"] + out["p_leak_mw"]
    gflops = 2.0 * out["freq_ghz"] * util
    out["gflops"] = gflops
    out["gflops_per_w"] = gflops / (out["p_total_mw"] * 1e-3)
    out["gflops_per_mm2"] = gflops / out["area_mm2"]
    return out


# ---------------------------------------------------------------------------
# Transprecision format scaling (the numerics registry hook)
# ---------------------------------------------------------------------------
def format_scale_factors(fmt, style: str = "fma",
                         params: "TechParams | None" = None,
                         precision: str | None = None,
                         device=None) -> Dict[str, float]:
    """Energy/area/delay scaling of a datapath sized for ``fmt`` relative to
    its host precision class (sp for <= 32-bit formats, dp above).

    Computed from the *same* calibrated structural feature model the sweeps
    use — a canonical fabricated structure of the class is re-evaluated with
    its significand narrowed via ``FPUDesign.with_format`` — so the
    registry's per-format scales can never drift from what an actual
    format-aware tune measures.  Returns ``energy`` (e_op ratio), ``area``
    (cap/area ratio) and ``delay`` (unpipelined critical-path ratio), all
    <= 1 for sub-native formats.  ``device`` is where ``calibrate`` runs
    when ``params`` is not given.
    """
    precision = precision or ("dp" if fmt.bits > 32 else "sp")
    base = FABRICATED[f"{precision}_{style}"]
    narrowed = base.with_format(fmt)
    if narrowed is base:
        return dict(energy=1.0, area=1.0, delay=1.0)
    params = params or calibrate(device=device)
    pvec = params.as_array()
    ratio = _cap_total_np(pvec, _feature_vector(narrowed)) \
        / _cap_total_np(pvec, _feature_vector(base))
    return dict(energy=ratio, area=ratio,
                delay=logic_depth_fo4(narrowed) / logic_depth_fo4(base))


# ---------------------------------------------------------------------------
# Batched (structure-of-arrays) prediction — the DSE hot path
# ---------------------------------------------------------------------------
_CORE_KEYS = ("cycle_ns", "freq_ghz", "e_op_pj", "p_dyn_mw", "p_leak_mw",
              "p_total_mw", "area_mm2")
_DERIVED_KEYS = ("gflops", "gflops_per_w", "gflops_per_mm2")
METRIC_KEYS = _CORE_KEYS + _DERIVED_KEYS


def feature_matrix(designs: Sequence[FPUDesign]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Structure-of-arrays design description: (features (n, 5),
    stage depths (n,), is_cma (n,)) for a batch of designs."""
    feats = np.asarray([_feature_vector(d) for d in designs], np.float64)
    depths = np.asarray([stage_depth_fo4(d) for d in designs], np.float64)
    is_cma = np.asarray([d.style == "cma" for d in designs], bool)
    return feats, depths, is_cma


class _DeviceInputs:
    """The batched model's inputs as two device tensors: every float64
    input packed into one, so a sweep costs one host-to-device copy of the
    floats and one of ``is_cma``."""

    def __init__(self, nd: int, nv: int, nb: int, dev: torch.device):
        self.nd, self.nv, self.nb = nd, nv, nb
        self.device = dev
        self.floats = torch.empty(len(_PARAM_SPEC) + nd * 6 + nv + nb,
                                  dtype=torch.float64, device=dev)
        self.is_cma = torch.empty(nd, dtype=torch.bool, device=dev)

    def load(self, pvec, feats, depths, is_cma, vdd, vbb):
        packed = np.concatenate([pvec, feats.ravel(), depths, vdd, vbb])
        self.floats.copy_(torch.from_numpy(packed.astype(np.float64)))
        self.is_cma.copy_(torch.from_numpy(np.ascontiguousarray(is_cma)))
        nd, nv, n_p = self.nd, self.nv, len(_PARAM_SPEC)
        pv, f, dp, vv, bb = self.floats.split(
            [n_p, nd * 5, nd, nv, self.nb])
        return pv, f.view(nd, 5), dp, vv, bb


def _predict_batch_torch(inputs: _DeviceInputs, pvec, feats, depths, is_cma,
                         vdd, vbb, util) -> Dict[str, np.ndarray]:
    """(n_designs, n_vdd, n_vbb) metric tensor in one broadcast evaluation
    on ``inputs.device``; one device-to-host copy of all seven columns."""
    pv, f, dp, vv, bb = inputs.load(pvec, feats, depths, is_cma, vdd, vbb)
    out = _predict_core(pv, f[:, None, None, :], dp[:, None, None],
                        inputs.is_cma[:, None, None], vv[None, :, None],
                        bb[None, None, :], util)
    shape = (inputs.nd, inputs.nv, inputs.nb)
    host = torch.stack([out[k].expand(shape) for k in _CORE_KEYS]).cpu()
    return dict(zip(_CORE_KEYS, host.numpy()))


def _predict_np_batch(pvec, feats, depths, is_cma, vdd, vbb, util):
    """NumPy twin of the batched path; bitwise-identical to per-design
    ``_predict_np`` (used where exact parity with the legacy per-point
    loop matters, e.g. equivalence tests)."""
    tau, alpha, vt0, k_bb, s_dec, s_cap, s_leak, s_area = pvec[:8]
    speed = np.where(is_cma, pvec[12], pvec[13])[:, None, None]
    coeffs = np.array([pvec[8], pvec[9], pvec[10], pvec[11], 1.0])
    cap = np.sum(coeffs[None, :] * feats, axis=1)[:, None, None]
    depths = depths[:, None, None]
    vdd = np.asarray(vdd, np.float64)[None, :, None]
    vbb = np.asarray(vbb, np.float64)[None, None, :]
    vt = vt0 - k_bb * vbb
    num = vdd / np.maximum(vdd - vt, 1e-3) ** alpha
    den = 1.0 / (1.0 - vt0) ** alpha
    dscale = num / den
    cycle_ns = tau / speed * (depths * _IMBALANCE + _CLK_OVH_FO4) * dscale
    freq_ghz = 1.0 / cycle_ns
    cap_eff = cap * speed ** 0.5
    e_op_pj = s_cap * cap_eff * vdd * vdd
    p_dyn_mw = e_op_pj * freq_ghz * util
    p_leak_mw = s_leak * (cap_eff * 1e-4) * vdd * 10.0 ** (-vt / s_dec)
    area_mm2 = s_area * cap_eff * np.ones_like(cycle_ns)
    out = dict(cycle_ns=cycle_ns, freq_ghz=freq_ghz, e_op_pj=e_op_pj,
               p_dyn_mw=p_dyn_mw, p_leak_mw=p_leak_mw,
               p_total_mw=p_dyn_mw + p_leak_mw, area_mm2=area_mm2)
    shape = np.broadcast_shapes(*(v.shape for v in out.values()))
    return {k: np.broadcast_to(v, shape).copy() for k, v in out.items()}


def _attach_derived(out: Dict[str, np.ndarray], util: float
                    ) -> Dict[str, np.ndarray]:
    # canonical key order, as the reference returns it
    out = {k: out[k] for k in METRIC_KEYS if k in out}
    gflops = 2.0 * out["freq_ghz"] * util
    out["gflops"] = gflops
    out["gflops_per_w"] = gflops / (out["p_total_mw"] * 1e-3)
    out["gflops_per_mm2"] = gflops / out["area_mm2"]
    return out


def _anchor_factor_arrays(designs: Sequence[FPUDesign], params: TechParams
                          ) -> Dict[str, np.ndarray]:
    """Per-design multiplicative silicon corrections (identity for
    non-fabricated designs), as arrays aligned with ``designs``."""
    corr = _anchor_corrections(params)
    fac = {k: np.ones(len(designs)) for k in ("freq", "area", "leak", "dyn")}
    for i, d in enumerate(designs):
        c = corr.get(d.name)
        if c is not None:
            for k in fac:
                fac[k][i] = c[k]
    return fac


def _apply_anchor(out: Dict[str, np.ndarray], fac: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
    shape = (-1,) + (1,) * (out["freq_ghz"].ndim - 1)
    freq, area = fac["freq"].reshape(shape), fac["area"].reshape(shape)
    leak, dyn = fac["leak"].reshape(shape), fac["dyn"].reshape(shape)
    out["freq_ghz"] = out["freq_ghz"] * freq
    out["cycle_ns"] = out["cycle_ns"] / freq
    out["area_mm2"] = out["area_mm2"] * area
    out["p_leak_mw"] = out["p_leak_mw"] * leak
    out["p_dyn_mw"] = out["p_dyn_mw"] * dyn
    out["e_op_pj"] = out["e_op_pj"] * dyn
    out["p_total_mw"] = out["p_dyn_mw"] + out["p_leak_mw"]
    return out


class SweepExecutableCache:
    """Per-shape device buffers of the batched ``predict_batch``.

    The JAX package keeps one AOT-compiled executable per grid shape; the
    port has nothing to compile, so each entry holds what a sweep of that
    shape reuses: the packed device input buffers.  The key is *only* the
    shape ``(n_designs, n_vdd, n_vbb)`` — parameters, util and grid values
    are loaded per call — so re-tuning, recalibration and equal-sized
    design spaces (the SP and DP full enumerations, both 288 structures)
    all reuse one entry.  ``hits``/``misses``/``executables`` count as the
    reference's do (the autotuner reports them); an entry built for another
    device is rebuilt, and counts as a miss.
    """

    def __init__(self):
        self._exec: Dict[Tuple[int, int, int], _DeviceInputs] = {}
        self.hits = 0
        self.misses = 0

    def clear(self) -> None:
        self._exec.clear()
        self.hits = 0
        self.misses = 0

    @property
    def stats(self) -> Dict[str, int]:
        return dict(hits=self.hits, misses=self.misses,
                    executables=len(self._exec))

    def predict(self, pvec: np.ndarray, feats: np.ndarray,
                depths: np.ndarray, is_cma: np.ndarray,
                vdd: np.ndarray, vbb: np.ndarray, util: float,
                device=None) -> Dict[str, np.ndarray]:
        dev = resolve_device(device)
        key = (feats.shape[0], vdd.size, vbb.size)
        inputs = self._exec.get(key)
        if inputs is None or inputs.device != dev:
            inputs = _DeviceInputs(*key, dev)
            self._exec[key] = inputs
            self.misses += 1
        else:
            self.hits += 1
        return _predict_batch_torch(inputs, pvec, feats, depths, is_cma,
                                    vdd, vbb, util)


def predict_batch(designs: Sequence[FPUDesign], params: TechParams,
                  vdd_grid, vbb_grid, util: float = 1.0,
                  anchored: bool = False, backend: str = "torch",
                  cache: "SweepExecutableCache | None" = None,
                  device=None) -> Dict[str, np.ndarray]:
    """Full metric tensor over (n_designs x n_vdd x n_vbb) in one dispatch.

    ``backend='torch'`` evaluates the whole batch as one broadcast float64
    torch computation on ``device`` (the card unless ``device='cpu'``);
    ``backend='numpy'`` uses the broadcasting twin that is bitwise-identical
    to the legacy per-design ``predict_grid`` path.  Returns float64 arrays
    keyed by METRIC_KEYS.  Passing a ``SweepExecutableCache`` reuses its
    per-shape device buffers.
    """
    if backend == "jax":
        raise ValueError("backend 'jax' is the JAX package's; the port's "
                         "batched backend is 'torch' (or 'numpy')")
    if backend not in ("torch", "numpy"):
        raise ValueError(f"backend {backend!r}")
    designs = list(designs)
    feats, depths, is_cma = feature_matrix(designs)
    vdd = np.asarray(vdd_grid, np.float64).ravel()
    vbb = np.asarray(vbb_grid, np.float64).ravel()
    pvec = params.as_array()
    if backend == "torch":
        if cache is not None:
            out = cache.predict(pvec, feats, depths, is_cma, vdd, vbb, util,
                                device=device)
        else:
            inputs = _DeviceInputs(len(designs), vdd.size, vbb.size,
                                   resolve_device(device))
            out = _predict_batch_torch(inputs, pvec, feats, depths, is_cma,
                                       vdd, vbb, util)
    else:
        out = _predict_np_batch(pvec, feats, depths, is_cma, vdd, vbb, util)
    if anchored:
        out = _apply_anchor(out, _anchor_factor_arrays(designs, params))
    return _attach_derived(out, util)


def predict_points(designs: Sequence[FPUDesign], params: TechParams,
                   vdd=None, vbb=None, util: float = 1.0,
                   anchored: bool = False, device=None
                   ) -> Dict[str, np.ndarray]:
    """Metrics for each design at its own operating point, batched.

    ``vdd``/``vbb`` are (n_designs,) vectors (default: each design's own
    voltage attributes).  Returns float64 arrays of shape (n_designs,),
    computed in one torch evaluation on ``device``.
    """
    dev = resolve_device(device)
    designs = list(designs)
    feats, depths, is_cma = feature_matrix(designs)
    vdd = np.asarray([d.vdd for d in designs] if vdd is None else vdd,
                     np.float64)
    vbb = np.asarray([d.vbb for d in designs] if vbb is None else vbb,
                     np.float64)
    n = len(designs)
    vdd, vbb = np.broadcast_to(vdd, (n,)), np.broadcast_to(vbb, (n,))

    def f64(a):
        return torch.from_numpy(np.array(a, np.float64)).to(dev)

    out = _predict_core(f64(params.as_array()), f64(feats), f64(depths),
                        torch.from_numpy(is_cma).to(dev), f64(vdd), f64(vbb),
                        util)
    host = torch.stack([out[k].expand(n) for k in _CORE_KEYS]).cpu()
    out = dict(zip(_CORE_KEYS, host.numpy()))
    if anchored:
        out = _apply_anchor(out, _anchor_factor_arrays(designs, params))
    return _attach_derived(out, util)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------
def _make_static_inputs():
    structs, obs = [], []
    for name, d in FABRICATED.items():
        m = TABLE_I[name]
        structs.append((_feature_vector(d), stage_depth_fo4(d),
                        d.style == "cma", m.vdd, m.vbb))
        obs.append((m.freq_ghz, m.leak_mw, m.power_mw, m.area_mm2))
    return tuple(structs), tuple(obs)


# the four Table I observables of each unit, in the reference's loss order
_OBS_KEYS = ("freq_ghz", "p_leak_mw", "p_total_mw", "area_mm2")


def _loss_fn(raw, units, log_meas, prior_idx, log_prior, prior_sig):
    """The reference's loss with its loop over the four units vectorised:
    squared log errors of every (unit, observable) plus log-normal priors."""
    pvec = torch.exp(raw)
    pred = _predict_core(pvec, *units)
    logs = torch.log(torch.stack([pred[k] for k in _OBS_KEYS], dim=1))
    loss = torch.sum((logs - log_meas) ** 2)
    return loss + torch.sum(((raw[prior_idx] - log_prior) / prior_sig) ** 2)


@functools.lru_cache(maxsize=4)
def calibrate(steps: int = 6000, lr: float = 0.02,
              device=None) -> TechParams:
    """Fit the technology/component constants to Table I (+priors).

    Float32 autograd on ``device`` (the card unless ``device='cpu'``), as
    the reference fits in float32.  Adam is written out as the reference
    writes it (eps added after the square root, bias corrections from
    ``t``), not ``torch.optim.Adam``; the bias corrections are a device
    table indexed by step, so each update divides by a tensor.
    """
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    structs, obs = _make_static_inputs()
    feats, depths, is_cma, vdd, vbb = zip(*structs)
    units = (torch.tensor(feats, **f32), torch.tensor(depths, **f32),
             torch.tensor(is_cma, device=dev), torch.tensor(vdd, **f32),
             torch.tensor(vbb, **f32))
    log_meas = torch.tensor([[math.log(v) for v in m] for m in obs], **f32)
    inits = tuple(s[1] for s in _PARAM_SPEC)
    prior = [(i, math.log(s[1]), s[2]) for i, s in enumerate(_PARAM_SPEC)
             if s[2] is not None]
    prior_idx = torch.tensor([p[0] for p in prior], device=dev)
    log_prior = torch.tensor([p[1] for p in prior], **f32)
    prior_sig = torch.tensor([p[2] for p in prior], **f32)
    b1, b2, eps = 0.9, 0.999, 1e-8
    ts = range(1, steps + 1)
    bc1 = torch.tensor([1 - b1 ** t for t in ts], **f32).unbind()
    bc2 = torch.tensor([1 - b2 ** t for t in ts], **f32).unbind()
    raw = torch.log(torch.tensor(inits, **f32))
    mom = torch.zeros_like(raw)
    vel = torch.zeros_like(raw)
    for c1, c2 in zip(bc1, bc2):
        raw.requires_grad_(True)
        loss = _loss_fn(raw, units, log_meas, prior_idx, log_prior,
                        prior_sig)
        g, = torch.autograd.grad(loss, raw)
        raw = raw.detach()
        mom = b1 * mom + (1 - b1) * g
        vel = b2 * vel + (1 - b2) * g * g
        raw = raw - lr * (mom / c1) / (torch.sqrt(vel / c2) + eps)
    # exp of the float32 logs in float32, as the reference's np.exp does
    return TechParams(tuple(float(x) for x in np.exp(raw.cpu().numpy())))


@functools.lru_cache(maxsize=4)
def _anchor_corrections(params: TechParams) -> Dict[str, Dict[str, float]]:
    out = {}
    for name, d in FABRICATED.items():
        m = TABLE_I[name]
        pred = predict(d, params, vdd=m.vdd, vbb=m.vbb)
        out[name] = dict(
            freq=m.freq_ghz / pred["freq_ghz"],
            area=m.area_mm2 / pred["area_mm2"],
            leak=m.leak_mw / pred["p_leak_mw"],
            dyn=(m.power_mw - m.leak_mw) / pred["p_dyn_mw"])
    return out


def calibration_report(params: TechParams | None = None, device=None):
    """Relative errors of the global fit vs Table I (benchmarks/tests).

    All four fabricated units are evaluated in one ``predict_points`` batch
    on ``device``.
    """
    params = params or calibrate(device=device)
    names = list(FABRICATED)
    meas = [TABLE_I[n] for n in names]
    p = predict_points([FABRICATED[n] for n in names], params,
                       vdd=[m.vdd for m in meas], vbb=[m.vbb for m in meas],
                       device=device)
    rep = {}
    for i, (name, m) in enumerate(zip(names, meas)):
        rep[name] = {
            "freq_rel_err": float(p["freq_ghz"][i]) / m.freq_ghz - 1.0,
            "leak_rel_err": float(p["p_leak_mw"][i]) / m.leak_mw - 1.0,
            "power_rel_err": float(p["p_total_mw"][i]) / m.power_mw - 1.0,
            "area_rel_err": float(p["area_mm2"][i]) / m.area_mm2 - 1.0,
            "gflops_per_w_pred": float(p["gflops_per_w"][i]),
            "gflops_per_w_meas": m.gflops_per_w,
            "gflops_per_mm2_pred": float(p["gflops_per_mm2"][i]),
            "gflops_per_mm2_meas": m.gflops_per_mm2,
        }
    return rep
