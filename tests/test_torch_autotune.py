"""The port's workload autotuner against the JAX package: the paper's
Table I split on the fabricated units and on the full enumeration at the
``TUNE_*`` grids, constraints, adaptive body bias, profiles from traces and
configs, and the sweep cache's hit/miss semantics.

The reference values come from a subprocess that restores
``jax.experimental.enable_x64`` (dropped in jax 0.9.0) before importing the
JAX package's DSE modules, so the alias never enters this process (see
tests/test_torch_dse.py).  Both sides tune on the reference's fitted
parameters.  Tolerances: identical picks (design, operating point, index,
objective); the chosen point's metrics within rtol 1e-12 (the torch backend
against JAX's float64); ``attach_workload_metrics`` and the profiles
bitwise.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.core import autotune as at
from repro_torch.core import energy_model as em
from repro_torch.core import objective as obj
from repro_torch.core.dse import enumerate_structures, sweep_arrays
from repro_torch.core.fpu_arch import FABRICATED
from repro_torch.core.localsearch import hillclimb
from repro_torch.core.trace import OpProfile
from repro_torch.roofline import analysis as ra

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CPU = "cpu"
# the electrical grids of tests/test_autotune.py; the TUNE_* grids in
# test_tune_split_full_grids
VDD = np.round(np.arange(0.55, 1.101, 0.05), 3)
VBB = np.round(np.arange(0.0, 1.21, 0.3), 2)
TRACE_PROFILES = [("chain", 64, 1e6), ("independent", 1, 2e5),
                  ("chain", 4096, 3e7), ("chain", 8, 5e5)]
FROM_TRACE = [(1.0, 1), (0.3, 4), (0.05, 64)]
FROM_CONFIG = [("tinyllama-1.1b", "train_4k", None),
               ("tinyllama-1.1b", "decode_32k", None),
               ("falcon-mamba-7b", "prefill_32k", 0.4),
               ("deepseek-67b", "decode_32k", 0.02),
               ("chatglm3-6b", "long_500k", None)]
DRYRUN = {"tinyllama-1.1b|decode_32k": {"status": "ok",
                                        "roofline_fraction": 0.031},
          "falcon-mamba-7b|prefill_32k": {"status": "ok",
                                          "roofline_fraction": 0.62},
          "chatglm3-6b|long_500k": {"status": "error"},
          "bad-key": {"status": "ok", "roofline_fraction": 1.0}}

_REF = r"""
import dataclasses, pickle, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64  # the name jax 0.9.0 dropped
import numpy as np
from repro.core import autotune as at, energy_model as em, objective as obj
from repro.core.dse import enumerate_structures, sweep_arrays
from repro.core.fpu_arch import FABRICATED
from repro.core.localsearch import hillclimb
from repro.core.trace import OpProfile
from repro.roofline import analysis as ra

TRACE_PROFILES, FROM_TRACE, FROM_CONFIG = %r, %r, %r
results_dir = sys.argv[2]
VDD = np.round(np.arange(0.55, 1.101, 0.05), 3)
VBB = np.round(np.arange(0.0, 1.21, 0.3), 2)
out = {}
P = em.calibrate()
out["params"] = P.values

def pick(r):
    return dict(design=r.design.name, vdd=r.vdd, vbb=r.vbb, index=r.index,
                n_points=r.n_points, objective=r.objective_name,
                metrics=r.metrics, fmt=r.format.name)

kw = dict(params=P, vdd_grid=VDD, vbb_grid=VBB)
out["fab"] = {(p, name): pick(at.autotune(
    at.PROFILES[name], p, designs=[d for d in FABRICATED.values()
                                   if d.precision == p],
    anchored=True, **kw)) for p in ("sp", "dp") for name in at.PROFILES}
out["split"] = {p: [pick(r) for r in at.tune_split(p, **kw)]
                for p in ("sp", "dp")}
out["split_full"] = {p: [pick(r) for r in at.tune_split(p, params=P)]
                     for p in ("sp", "dp")}
cons = (obj.Constraint("freq_ghz", lo=1.0),)
out["cons"] = pick(at.autotune(at.GEMM_STREAM, "sp", constraints=cons, **kw))
r = at.autotune(at.GEMM_LOW_ACTIVITY, "sp", constraints=cons, **kw)
out["low"] = (pick(r), at.static_bb_energy(r))
out["low_idle"] = pick(at.autotune(at.GEMM_LOW_ACTIVITY, "dp", vbb_idle=0.3,
                                   **kw))
profs = [OpProfile(*p) for p in TRACE_PROFILES]
out["from_trace"] = [dataclasses.asdict(at.profile_from_trace(
    "t", profs, activity=a, interleave=i)) for a, i in FROM_TRACE]
out["from_config"] = [dataclasses.asdict(at.profile_from_config(
    arch, shape, act, rd)) for arch, shape, act in FROM_CONFIG
    for rd in (results_dir, None)]
out["utilizations"] = ra.measured_utilizations(results_dir)
out["for_config"] = pick(at.autotune_for_config("tinyllama-1.1b",
                                                "decode_32k", **kw))
res = sweep_arrays(enumerate_structures("sp"), P, VDD, VBB,
                   mix=at.DEPENDENT_CHAIN.mix(), with_latency=True,
                   backend="numpy")
for profile, idle in ((at.GEMM_LOW_ACTIVITY, 0.15), (at.DEPENDENT_CHAIN, 0.0)):
    at.attach_workload_metrics(res, profile, P, vbb_idle=idle)
    out["attach", profile.name] = res.metrics["e_eff_pj"].copy()
out["hillclimb"] = [dataclasses.asdict(hillclimb(
    init, lambda x: (x - 3, x - 1, x + 1, x + 3),
    lambda x: None if x < 0 or x == 11 else -(x - 7) ** 2 + (x %% 4),
    max_iters=it)) for init, it in ((0, 100), (20, 100), (0, 1))]
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
""" % (TRACE_PROFILES, FROM_TRACE, FROM_CONFIG)


@pytest.fixture(scope="module")
def results_dir(tmp_path_factory):
    """A dry-run artifact directory both packages read."""
    d = tmp_path_factory.mktemp("results")
    (d / "dryrun_a.json").write_text(json.dumps(DRYRUN))
    (d / "dryrun_b.json").write_text(json.dumps(
        {"tinyllama-1.1b|decode_32k": {"status": "ok",
                                       "roofline_fraction": 0.05}}))
    (d / "dryrun_broken.json").write_text("{not json")
    return d


@pytest.fixture(scope="module")
def ref(tmp_path_factory, results_dir):
    """The JAX package's values, computed in a subprocess (see above)."""
    path = tmp_path_factory.mktemp("autotune_ref") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _REF, str(path),
                           str(results_dir)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def params(ref):
    return em.TechParams(ref["params"])


def _pick(r):
    return dict(design=r.design.name, vdd=r.vdd, vbb=r.vbb, index=r.index,
                n_points=r.n_points, objective=r.objective_name,
                metrics=r.metrics, fmt=r.format.name)


def _same_pick(got, want):
    got = _pick(got)
    for k in ("design", "vdd", "vbb", "index", "n_points", "objective",
              "fmt"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert list(got["metrics"]) == list(want["metrics"])
    np.testing.assert_allclose(list(got["metrics"].values()),
                               list(want["metrics"].values()), rtol=1e-12,
                               atol=0)


def _kw(params):
    return dict(params=params, vdd_grid=VDD, vbb_grid=VBB,
                cache=em.SweepExecutableCache(), device=CPU)


@pytest.mark.parametrize("precision", ["sp", "dp"])
def test_fabricated_units_pick_table1(ref, params, precision):
    """Over the four fabricated units, silicon-anchored: the GEMM mixes
    pick the FMA throughput unit, the dependent chain the CMA latency unit
    (the paper's Table I split), as the reference picks."""
    units = [d for d in FABRICATED.values() if d.precision == precision]
    for name, profile in at.PROFILES.items():
        r = at.autotune(profile, precision, designs=units, anchored=True,
                        **_kw(params))
        _same_pick(r, ref["fab"][precision, name])
        style = "cma" if name == "dependent_chain" else "fma"
        if name != "gemm_low_activity":
            assert r.design.name == f"{precision}_{style}"


@pytest.mark.parametrize("precision", ["sp", "dp"])
def test_tune_split_matches(ref, params, precision):
    tp, lat = at.tune_split(precision, **_kw(params))
    for got, want in zip((tp, lat), ref["split"][precision]):
        _same_pick(got, want)
    assert tp.design.name != lat.design.name
    assert lat.design.accum_latency_cycles <= tp.design.accum_latency_cycles


@pytest.mark.parametrize("precision", ["sp", "dp"])
def test_tune_split_full_grids(ref, params, precision):
    """Table I at full size: 288 structures x the TUNE_* grids (69,984
    points a tune), the reference's default grids."""
    tp, lat = at.tune_split(precision, params=params,
                            cache=em.SweepExecutableCache(), device=CPU)
    assert tp.n_points == 288 * at.TUNE_VDD_GRID.size * at.TUNE_VBB_GRID.size
    for got, want in zip((tp, lat), ref["split_full"][precision]):
        _same_pick(got, want)


def test_constraints_and_adaptive_body_bias(ref, params):
    cons = (obj.Constraint("freq_ghz", lo=1.0),)
    r = at.autotune(at.GEMM_STREAM, "sp", constraints=cons, **_kw(params))
    _same_pick(r, ref["cons"])
    low = at.autotune(at.GEMM_LOW_ACTIVITY, "sp", constraints=cons,
                      **_kw(params))
    want, want_static = ref["low"]
    _same_pick(low, want)
    np.testing.assert_allclose(at.static_bb_energy(low), want_static,
                               rtol=1e-12, atol=0)
    saving = at.static_bb_energy(low) / low.metrics["e_eff_pj"]
    assert 1.5 <= saving <= 4.0  # the paper's Fig. 4 ~2x
    _same_pick(at.autotune(at.GEMM_LOW_ACTIVITY, "dp", vbb_idle=0.3,
                           **_kw(params)), ref["low_idle"])
    with pytest.raises(ValueError, match="no feasible"):
        at.autotune(at.GEMM_STREAM, "sp", constraints=(
            obj.Constraint("freq_ghz", lo=1e9),), **_kw(params))


def test_attach_workload_metrics_bitwise(ref, params):
    res = sweep_arrays(enumerate_structures("sp"), params, VDD, VBB,
                       mix=at.DEPENDENT_CHAIN.mix(), with_latency=True,
                       backend="numpy", device=CPU)
    for profile, idle in ((at.GEMM_LOW_ACTIVITY, 0.15),
                          (at.DEPENDENT_CHAIN, 0.0)):
        at.attach_workload_metrics(res, profile, params, vbb_idle=idle)
        assert np.array_equal(res.metrics["e_eff_pj"],
                              ref["attach", profile.name])


def test_profiles_from_trace_and_config(ref, params, results_dir):
    profs = [OpProfile(*p) for p in TRACE_PROFILES]
    assert [dataclasses.asdict(at.profile_from_trace(
        "t", profs, activity=a, interleave=i))
        for a, i in FROM_TRACE] == ref["from_trace"]
    assert [dataclasses.asdict(at.profile_from_config(
        arch, shape, act, rd)) for arch, shape, act in FROM_CONFIG
        for rd in (str(results_dir), None)] == ref["from_config"]
    assert ra.measured_utilizations(str(results_dir)) == ref["utilizations"]
    assert ra.measured_utilization("tinyllama-1.1b", "decode_32k",
                                   str(results_dir)) == 0.05
    assert ra.measured_utilizations(str(results_dir / "absent")) == {}
    _same_pick(at.autotune_for_config("tinyllama-1.1b", "decode_32k",
                                      **_kw(params)), ref["for_config"])


# ------------------------------------------------------------ sweep cache
def test_cache_hits_on_same_shape_retune(params):
    fresh = em.SweepExecutableCache()
    kw = dict(params=params, vdd_grid=VDD, vbb_grid=VBB, cache=fresh,
              device=CPU)
    r1 = at.autotune(at.GEMM_STREAM, "sp", **kw)
    assert fresh.stats == dict(hits=0, misses=1, executables=1)
    r2 = at.autotune(at.GEMM_STREAM, "sp", **kw)
    assert fresh.stats == dict(hits=1, misses=1, executables=1)
    assert r2.key == r1.key and r2.metrics == r1.metrics
    assert r2.cache_stats == fresh.stats
    # the SP and DP full enumerations share one shape (288 structures)
    at.autotune(at.GEMM_STREAM, "dp", **kw)
    assert fresh.stats == dict(hits=2, misses=1, executables=1)
    at.autotune(at.GEMM_STREAM, "dp", designs=enumerate_structures("dp"),
                **kw)
    assert fresh.stats == dict(hits=2, misses=2, executables=2)
    fresh.clear()
    assert fresh.stats == dict(hits=0, misses=0, executables=0)
    uncached = at.autotune(at.GEMM_STREAM, "sp", params=params,
                           vdd_grid=VDD, vbb_grid=VBB, cache=None,
                           device=CPU)
    assert uncached.metrics == r1.metrics and uncached.cache_stats == {}


def test_format_joint_autotune_is_not_ported(params):
    for kw in (dict(formats=("bf16",)), dict(accuracy_slo=1e-3)):
        with pytest.raises(NotImplementedError, match="item 7"):
            at.autotune(at.GEMM_STREAM, "sp", params=params, device=CPU,
                        **kw)


def test_hillclimb_matches(ref):
    """The generic local search (a copy): the same best state, trajectory
    and counts as the reference's, infeasible states and the iteration cap
    included."""
    got = [dataclasses.asdict(hillclimb(
        init, lambda x: (x - 3, x - 1, x + 1, x + 3),
        lambda x: None if x < 0 or x == 11 else -(x - 7) ** 2 + (x % 4),
        max_iters=it)) for init, it in ((0, 100), (20, 100), (0, 1))]
    assert got == ref["hillclimb"]
    with pytest.raises(ValueError, match="infeasible initial state"):
        hillclimb(-1, lambda x: (), lambda x: None if x < 0 else x)
