"""The port's DSE core against the JAX package: FPU structures, the
calibrated energy/area/delay model, the Fig. 3/4 sweep, body bias, the
objective API, the registry's format scales and stochastic rounding.

The JAX package's ``energy_model`` imports ``jax.experimental.enable_x64``,
a name jax 0.9.0 dropped, so its DSE modules do not import as they are.
The reference values are computed in a subprocess that restores the name
(``jax.experimental.enable_x64 = jax.enable_x64``) before importing them;
the alias never enters this process, whose collection of the JAX package's
own tests it would otherwise change.  The downstream checks run on the
reference's fitted parameters, so a fit drift is never read as a model
fault.  Tolerances:

  * bitwise: features, depths, ``feature_matrix``, the numpy backend,
    ``predict``/``predict_grid``/anchor corrections, ``pareto_mask``,
    ``body_bias``, ``objective`` and ``quantize_stochastic`` on JAX's own
    uniforms (finite, non-subnormal inputs, and only where XLA:CPU's
    ``exp2`` returns the exact power of two the scale is);
  * rtol 1e-12: the torch backend (here on the CPU) against JAX's float64
    ``predict_batch``/``predict_points``, the reference's own jax-vs-numpy
    bound; the Pareto sets and ``argbest`` picks identical;
  * rtol 1e-3 per value: the port's float32 ``calibrate()`` against the
    reference's float32 fit (Adam's steps follow rounding noise near the
    optimum);
  * 1e-12: the registry's energy/area/delay scales.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import body_bias as bb
from repro_torch.core import dse
from repro_torch.core import energy_model as em
from repro_torch.core import formats as tf
from repro_torch.core import objective as obj
from repro_torch.core.fpu_arch import FABRICATED, TABLE_I, FPUDesign
from repro_torch.core.latency_sim import SpecMix
from repro_torch.numerics import registry as treg

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CPU = "cpu"
RTOL = 1e-12
FORMATS = ("bf16", "fp16", "tf32", "fp8_e4m3", "fp8_e5m2")
QS_FORMATS = ("bf16", "fp16", "fp8_e4m3", "fp8_e5m2")

_REF = r"""
import dataclasses, pickle, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64  # the name jax 0.9.0 dropped
import jax.numpy as jnp
import numpy as np
from repro.core import body_bias as bb, dse, energy_model as em
from repro.core import formats as jf, objective as obj
from repro.core.fpu_arch import DP_CMA, FABRICATED, SP_CMA, SP_FMA
from repro.core.latency_sim import calibrated_spec_mix
from repro.numerics import registry as reg

FORMATS, QS_FORMATS = %r, %r
out = {}
P = em.calibrate()
out["params"] = P.values
fab = list(FABRICATED.values())
narrow = [d.with_format(jf.get_format(f)) for d in fab for f in FORMATS]
designs = (dse.enumerate_structures_full("sp")
           + dse.enumerate_structures_full("dp") + fab + narrow)
out["designs"] = [dataclasses.asdict(d) for d in designs]
out["enum"] = {(p, full): [dataclasses.asdict(d) for d in (
    dse.enumerate_structures_full(p) if full else dse.enumerate_structures(p))]
    for p in ("sp", "dp") for full in (False, True)}
out["features"] = [em.design_features(d) for d in designs]
out["depths"] = [(em.logic_depth_fo4(d), em.stage_depth_fo4(d))
                 for d in designs]
out["feature_matrix"] = em.feature_matrix(designs)
vdd, vbb = dse.DEFAULT_VDD_GRID, dse.DEFAULT_VBB_GRID
np_ = lambda o: {k: np.asarray(v) for k, v in o.items()}
out["batch_np"] = np_(em.predict_batch(designs, P, vdd, vbb, util=0.7,
                                       backend="numpy"))
out["batch_np_anch"] = np_(em.predict_batch(fab, P, vdd, vbb, backend="numpy",
                                            anchored=True))
out["batch_jax"] = np_(em.predict_batch(designs, P, vdd, vbb, util=0.7))
out["batch_jax_anch"] = np_(em.predict_batch(fab, P, vdd, vbb,
                                             anchored=True))
pv = np.linspace(0.5, 1.15, len(designs))
pb = np.linspace(0.0, 1.2, len(designs))
out["points"] = np_(em.predict_points(designs, P, vdd=pv, vbb=pb, util=0.5))
out["points_anch"] = np_(em.predict_points(fab, P, anchored=True))
out["predict"] = [em.predict(d, P, util=u, anchored=a, vdd=v)
                  for d in fab + narrow[:7] for u in (1.0, 0.3)
                  for a in (False, True) for v in (None, 0.61)]
vv, bg = np.meshgrid(vdd, vbb, indexing="ij")
out["grid"] = [np_(em.predict_grid(d, P, vv, bg, util=0.9)) for d in fab]
out["anchors"] = em._anchor_corrections(P)
out["report"] = em.calibration_report(P)
out["scales"] = {(f, s, p): em.format_scale_factors(
    jf.get_format(f), s, P, p) for f in FORMATS + ("fp32", "fp64")
    for s in ("fma", "cma") for p in ("sp", "dp", None)
    if not (p == "sp" and f == "fp64")}
out["registry"] = {s.name: s.as_dict() for s in reg.REGISTRY}
mix = calibrated_spec_mix()
out["mix"] = dataclasses.asdict(mix)
space = dse.enumerate_structures("sp") + dse.enumerate_structures("dp")
for backend in ("jax", "numpy"):
    res = dse.sweep_arrays(space, P, mix=mix, with_latency=True,
                           backend=backend)
    out["sweep_" + backend] = dict(
        metrics=np_(res.metrics), didx=res.design_index, vdd=res.vdd,
        vbb=res.vbb, tp=res.throughput_pareto_mask(),
        lat=res.latency_pareto_mask(), best_tp=res.argbest_throughput(),
        best_tp_half=res.argbest_throughput(0.5),
        best_lat=res.argbest_latency(),
        keys=[res.point(i).key for i in range(0, len(res), 97)])
out["best"] = [(dse.best_throughput_design(p, P).key,
                dse.best_throughput_design(p, P, 0.5).key,
                dse.best_latency_design(p, P).key) for p in ("sp", "dp")]
out["legacy"] = [(q.key, q.metrics) for q in dse.sweep(
    dse.enumerate_structures("dp")[:3], P, mix=mix, with_latency=True)]
res = dse.sweep_arrays(space, P, mix=mix, with_latency=True, backend="numpy")
cons = [obj.Constraint("freq_ghz", lo=1.0),
        obj.Constraint("area_mm2", hi=0.02)]
objs = [obj.THROUGHPUT, obj.LATENCY, obj.throughput_objective(0.3),
        obj.Objective("edpa", (("e_per_flop_pj", 1.0), ("area_mm2", 0.5),
                              ("avg_delay_ns", 1.0)))]
out["objective"] = [(o.score(res.metrics), o.argbest(res.metrics),
                     obj.argbest(res.metrics, o, cons)) for o in objs]
out["feasible"] = obj.feasible_mask(res.metrics, cons)
out["axis_costs"] = [obj.axis_costs(res.metrics, a)
                     for a in (obj.THROUGHPUT_AXES, obj.LATENCY_AXES)]
rng = np.random.default_rng(3)
pareto = []
for trial in range(8):
    n = int(rng.integers(1, 400))
    xs = rng.choice([0.1, 0.5, 1.0, 2.0], n) if trial %% 2 \
        else rng.uniform(0.1, 10, n)
    ys = rng.choice([0.1, 0.5, 1.0, 2.0], n) if trial %% 2 \
        else rng.uniform(0.1, 10, n)
    pareto.append((xs, ys, dse.pareto_mask(xs, ys)))
out["pareto"] = pareto
out["bb"] = [bb.bb_study(DP_CMA, P, vdd=0.6), bb.bb_study(SP_FMA, P),
             bb.bb_study(SP_CMA, P, util_low=0.2, vbb_idle=0.3)]
out["evu"] = [bb.energy_vs_utilization(d, P) for d in (SP_CMA, DP_CMA)]
out["iso"] = [bb.iso_frequency_vdd(d, P, 1.0, vbb) for d in fab
              for vbb in (0.0, 0.6)]
out["epo"] = [bb.energy_per_op(d, P, vdd=0.7, vbb_active=1.2, vbb_idle=i,
                               util=0.1) for d in fab for i in (None, 0.45)]
out["leak"] = bb.leak_bb_scale(P, np.linspace(0, 1.2, 9), 0.3)
x = (rng.standard_normal(60000)
     * np.exp2(rng.integers(-30, 30, 60000))).astype(np.float32)
x[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 3e38]
out["qs_x"] = x
ks = np.arange(-200, 200, dtype=np.float32)
out["exp2"] = (ks, np.asarray(jnp.exp2(jnp.asarray(ks))))
for f in QS_FORMATS:
    key = jax.random.PRNGKey(7)
    out["qs", f] = (
        np.asarray(jax.random.uniform(key, x.shape, dtype=jnp.float32)),
        np.asarray(jf.quantize_stochastic(jnp.asarray(x), jf.get_format(f),
                                          key)))
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
""" % (FORMATS, QS_FORMATS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's values, computed in a subprocess (see above)."""
    path = tmp_path_factory.mktemp("dse_ref") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _REF, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def params(ref):
    return em.TechParams(ref["params"])


@pytest.fixture(scope="module")
def designs(ref):
    return [FPUDesign(**d) for d in ref["designs"]]


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.array_equal(got, want, equal_nan=True), what


def _same_dict(got, want):
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k], k)


def _close_dict(got, want, rtol=RTOL):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0,
                                   err_msg=k)


# --------------------------------------------------------------- structures
@pytest.mark.parametrize("precision", ["sp", "dp"])
@pytest.mark.parametrize("full", [False, True], ids=["fig34", "full"])
def test_enumerations_match(ref, precision, full):
    fn = dse.enumerate_structures_full if full else dse.enumerate_structures
    got = [dataclasses.asdict(d) for d in fn(precision)]
    assert got == ref["enum"][precision, full]
    assert len(got) == (288 if full else 66)


def test_features_depths_and_feature_matrix_bitwise(ref, designs):
    assert [em.design_features(d) for d in designs] == ref["features"]
    assert [(em.logic_depth_fo4(d), em.stage_depth_fo4(d))
            for d in designs] == ref["depths"]
    for got, want in zip(em.feature_matrix(designs), ref["feature_matrix"]):
        _same(got, want)


def test_narrowed_designs_match(ref, designs):
    fab = list(FABRICATED.values())
    narrow = [d.with_format(tf.get_format(f)) for d in fab for f in FORMATS]
    assert designs[-len(narrow):] == narrow
    assert all(d.with_format(tf.get_format(d.name.split("@")[1])) == d
               for d in narrow)


# ------------------------------------------------------------------ model
def test_numpy_backend_bitwise(ref, params, designs):
    vdd, vbb = dse.DEFAULT_VDD_GRID, dse.DEFAULT_VBB_GRID
    _same_dict(em.predict_batch(designs, params, vdd, vbb, util=0.7,
                                backend="numpy"), ref["batch_np"])
    fab = list(FABRICATED.values())
    _same_dict(em.predict_batch(fab, params, vdd, vbb, backend="numpy",
                                anchored=True), ref["batch_np_anch"])


def test_torch_backend_matches_jax(ref, params, designs):
    vdd, vbb = dse.DEFAULT_VDD_GRID, dse.DEFAULT_VBB_GRID
    _close_dict(em.predict_batch(designs, params, vdd, vbb, util=0.7,
                                 device=CPU), ref["batch_jax"])
    fab = list(FABRICATED.values())
    _close_dict(em.predict_batch(fab, params, vdd, vbb, anchored=True,
                                 device=CPU), ref["batch_jax_anch"])
    cache = em.SweepExecutableCache()
    _close_dict(em.predict_batch(designs, params, vdd, vbb, util=0.7,
                                 cache=cache, device=CPU), ref["batch_jax"])


def test_predict_points_matches_jax(ref, params, designs):
    n = len(designs)
    got = em.predict_points(designs, params, vdd=np.linspace(0.5, 1.15, n),
                            vbb=np.linspace(0.0, 1.2, n), util=0.5,
                            device=CPU)
    _close_dict(got, ref["points"])
    _close_dict(em.predict_points(list(FABRICATED.values()), params,
                                  anchored=True, device=CPU),
                ref["points_anch"])


def test_predict_grid_and_anchors_bitwise(ref, params, designs):
    fab = list(FABRICATED.values())
    narrow = designs[-len(fab) * len(FORMATS):]
    got = [em.predict(d, params, util=u, anchored=a, vdd=v)
           for d in fab + narrow[:7] for u in (1.0, 0.3)
           for a in (False, True) for v in (None, 0.61)]
    assert got == ref["predict"]
    vv, bg = np.meshgrid(dse.DEFAULT_VDD_GRID, dse.DEFAULT_VBB_GRID,
                         indexing="ij")
    for d, want in zip(fab, ref["grid"]):
        _same_dict(em.predict_grid(d, params, vv, bg, util=0.9), want)
    assert em._anchor_corrections(params) == ref["anchors"]


def test_backend_jax_is_refused(params):
    with pytest.raises(ValueError, match="'torch'"):
        em.predict_batch([FABRICATED["sp_fma"]], params, [0.8], [0.0],
                         backend="jax")


def test_calibration_report_matches_jax(ref, params):
    got = em.calibration_report(params, device=CPU)
    assert list(got) == list(ref["report"])
    for name, row in ref["report"].items():
        for k, v in row.items():
            np.testing.assert_allclose(got[name][k], v, rtol=RTOL,
                                       err_msg=(name, k))


def test_calibrate_matches_reference_fit(ref):
    """The port's float32 Adam fit lands within rtol 1e-3 of the
    reference's on every constant, and its residuals within the envelope
    of tests/test_golden_fpmax.py."""
    got = em.calibrate(device=CPU)
    np.testing.assert_allclose(got.values, ref["params"], rtol=1e-3, atol=0)
    for name, row in em.calibration_report(got, device=CPU).items():
        assert abs(row["freq_rel_err"]) <= 0.32, name
        assert abs(row["power_rel_err"]) <= 0.15, name
        assert abs(row["area_rel_err"]) <= 0.33, name


# ------------------------------------------------------------ Fig. 3/4 sweep
@pytest.fixture(scope="module")
def space():
    return dse.enumerate_structures("sp") + dse.enumerate_structures("dp")


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_fig34_sweep_matches_jax(ref, params, space, backend):
    """The SP+DP Fig. 3/4 space (9,240 points) with latency: the numpy
    backend bitwise, the torch backend within rtol 1e-12 of JAX's; both
    with the reference's Pareto sets and picks."""
    mix = SpecMix(**ref["mix"])
    res = dse.sweep_arrays(space, params, mix=mix, with_latency=True,
                           backend=backend, device=CPU)
    want = ref["sweep_jax" if backend == "torch" else "sweep_numpy"]
    assert len(res) == 9240
    if backend == "numpy":
        _same_dict(res.metrics, want["metrics"])
    else:
        _close_dict(res.metrics, want["metrics"])
    _same(res.design_index, want["didx"])
    _same(res.vdd, want["vdd"])
    _same(res.vbb, want["vbb"])
    _same(res.throughput_pareto_mask(), want["tp"])
    _same(res.latency_pareto_mask(), want["lat"])
    assert res.argbest_throughput() == want["best_tp"]
    assert res.argbest_throughput(0.5) == want["best_tp_half"]
    assert res.argbest_latency() == want["best_lat"]
    assert [res.point(i).key for i in range(0, len(res), 97)] == want["keys"]


def test_best_designs_and_legacy_sweep_match(ref, params):
    """The Table I/II best-design helpers and the legacy DsePoint API;
    the helpers fall back to ``calibrated_spec_mix`` on the device."""
    got = [(dse.best_throughput_design(p, params, device=CPU).key,
            dse.best_throughput_design(p, params, 0.5, device=CPU).key,
            dse.best_latency_design(p, params, device=CPU).key)
           for p in ("sp", "dp")]
    assert got == ref["best"]
    pts = dse.sweep(dse.enumerate_structures("dp")[:3], params,
                    mix=SpecMix(**ref["mix"]), with_latency=True, device=CPU)
    assert [p.key for p in pts] == [k for k, _ in ref["legacy"]]
    for p, (_, want) in zip(pts, ref["legacy"]):
        assert list(p.metrics) == list(want)
        np.testing.assert_allclose(list(p.metrics.values()),
                                   list(want.values()), rtol=RTOL, atol=0)


def test_anchored_sweep_pins_table1(params):
    """The anchored batched path at the Table I operating points: exact to
    1e-6 (the reference's ANCHOR_RTOL), on the card's backend here on the
    CPU."""
    fab = list(FABRICATED.values())
    vdds = sorted({TABLE_I[d.name].vdd for d in fab})
    res = dse.sweep_arrays(fab, params, np.asarray(vdds), np.asarray([1.2]),
                           anchored=True, device=CPU)
    for i, d in enumerate(fab):
        m = TABLE_I[d.name]
        rows = np.nonzero((res.design_index == i) & (res.vdd == m.vdd))[0]
        assert rows.size == 1, d.name
        r = int(rows[0])
        for key, want in (("freq_ghz", m.freq_ghz), ("p_leak_mw", m.leak_mw),
                          ("p_total_mw", m.power_mw),
                          ("area_mm2", m.area_mm2)):
            np.testing.assert_allclose(res.metrics[key][r], want, rtol=1e-6,
                                       err_msg=(d.name, key))


def test_sweep_loop_equals_numpy_sweep(ref, params):
    designs = dse.enumerate_structures("dp")[::5]
    mix = SpecMix(**ref["mix"])
    pts = dse.sweep_loop(designs, params, mix=mix, with_latency=True,
                         device=CPU)
    res = dse.sweep_arrays(designs, params, mix=mix, with_latency=True,
                           backend="numpy", device=CPU)
    assert [p.key for p in pts] == [p.key for p in res.to_points()]
    assert [p.metrics for p in pts] == [p.metrics for p in res.to_points()]
    assert len(dse.throughput_pareto(pts)) == \
        len(dse.throughput_pareto(res))
    assert [p.key for p in dse.latency_pareto(pts)] == \
        [p.key for p in dse.latency_pareto(res).to_points()]


def test_pareto_mask_bitwise(ref):
    for xs, ys, want in ref["pareto"]:
        _same(dse.pareto_mask(xs, ys), want)
    assert dse.pareto_mask(np.array([]), np.array([])).shape == (0,)


def test_objective_bitwise(ref, params, space):
    res = dse.sweep_arrays(space, params, mix=SpecMix(**ref["mix"]),
                           with_latency=True, backend="numpy", device=CPU)
    cons = [obj.Constraint("freq_ghz", lo=1.0),
            obj.Constraint("area_mm2", hi=0.02)]
    objs = [obj.THROUGHPUT, obj.LATENCY, obj.throughput_objective(0.3),
            obj.Objective("edpa", (("e_per_flop_pj", 1.0),
                                   ("area_mm2", 0.5), ("avg_delay_ns", 1.0)))]
    for o, (score, best, best_c) in zip(objs, ref["objective"]):
        _same(o.score(res.metrics), score, o.name)
        assert o.argbest(res.metrics) == best
        assert obj.argbest(res.metrics, o, cons) == best_c
    _same(obj.feasible_mask(res.metrics, cons), ref["feasible"])
    for axes, want in zip((obj.THROUGHPUT_AXES, obj.LATENCY_AXES),
                          ref["axis_costs"]):
        for got, w in zip(obj.axis_costs(res.metrics, axes), want):
            _same(got, w)
    with pytest.raises(ValueError, match="no feasible"):
        obj.argbest(res.metrics, obj.LATENCY,
                    [obj.Constraint("freq_ghz", lo=1e9)])


# --------------------------------------------------------------- body bias
def test_body_bias_bitwise(ref, params):
    from repro_torch.core.fpu_arch import DP_CMA, SP_CMA, SP_FMA
    got = [bb.bb_study(DP_CMA, params, vdd=0.6), bb.bb_study(SP_FMA, params),
           bb.bb_study(SP_CMA, params, util_low=0.2, vbb_idle=0.3)]
    assert got == ref["bb"]
    s = got[0]  # the paper's claims (tests/test_latency_and_dse.py bounds)
    assert 0.10 < s["bb_energy_saving"] < 0.35
    assert 2.3 < s["low_util_static_ratio"] < 4.0
    assert 1.2 < s["low_util_adaptive_ratio"] < 1.9
    for d, want in zip((SP_CMA, DP_CMA), ref["evu"]):
        for g, w in zip(bb.energy_vs_utilization(d, params), want):
            _same(g, w)
    fab = list(FABRICATED.values())
    assert [bb.iso_frequency_vdd(d, params, 1.0, vbb) for d in fab
            for vbb in (0.0, 0.6)] == ref["iso"]
    assert [bb.energy_per_op(d, params, vdd=0.7, vbb_active=1.2,
                             vbb_idle=i, util=0.1)
            for d in fab for i in (None, 0.45)] == ref["epo"]
    _same(bb.leak_bb_scale(params, np.linspace(0, 1.2, 9), 0.3), ref["leak"])


# ----------------------------------------------------------------- registry
def test_format_scale_factors_match(ref, params):
    for (f, style, prec), want in ref["scales"].items():
        got = em.format_scale_factors(tf.get_format(f), style, params, prec)
        assert list(got) == list(want)
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   rtol=1e-12, atol=0,
                                   err_msg=(f, style, prec))


def test_registry_scales_match(ref, params, monkeypatch):
    """Fresh specs of every registered format (the default registry's specs
    cache their scales once computed) on the reference's parameters."""
    monkeypatch.setattr(em, "calibrate", lambda device=None: params)
    assert list(treg.REGISTRY.names()) == list(ref["registry"])
    for name, want in ref["registry"].items():
        spec = treg.REGISTRY.get(name)
        fresh = treg.FormatSpec(spec.fmt, spec.precision_class)
        got = fresh.as_dict()
        assert list(got) == list(want)
        for k, v in want.items():
            if isinstance(v, float):
                np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=0,
                                           err_msg=(name, k))
            else:
                assert got[k] == v, (name, k)
        assert (fresh.energy_scale, fresh.area_scale, fresh.delay_scale) \
            == (got["energy_scale"], got["area_scale"], got["delay_scale"])


# ------------------------------------------------------- stochastic rounding
@pytest.mark.parametrize("name", QS_FORMATS)
def test_quantize_stochastic_on_jax_uniforms(ref, name):
    """Bitwise on JAX's own uniforms where the reference's scale is exact.

    The reference builds the ulp as ``jnp.exp2`` of an integer, which
    XLA:CPU does not return exactly for most integers (it is exact at
    -12..12 and a few others); there its result lies off the format's grid,
    while the port's ulp is the exact power of two.  Those inputs, and
    f32-subnormal ones (XLA:CPU flushes them), are left out of the bitwise
    comparison; every port output is checked to lie on the grid."""
    fmt = tf.get_format(name)
    x = ref["qs_x"]
    u, want = ref["qs", name]
    got = tf.quantize_stochastic(torch.from_numpy(x), fmt,
                                 u=torch.from_numpy(u.copy())).numpy()
    ks, xla = ref["exp2"]
    exact_k = {int(k) for k, v in zip(ks, xla)
               if -149 <= k < 128 and v == np.float32(2.0 ** int(k))}
    e = ((x.view(np.uint32) >> 23) & 0xFF).astype(np.int64) - 127
    k = np.clip(e, fmt.emin, fmt.emax) - fmt.man_bits
    normal = (np.abs(x) >= np.finfo(np.float32).tiny) | ~np.isfinite(x) \
        | (x == 0)
    keep = normal & np.isin(k, sorted(exact_k))
    assert keep.sum() > 1000
    _same(got[keep].view(np.uint32), want[keep].view(np.uint32))
    fin = np.isfinite(got)
    grid = tf.quantize(torch.from_numpy(got[fin]), fmt).numpy()
    _same(grid, got[fin])
    _same(np.isnan(got), np.isnan(x))
