"""The port's chip facade against the JAX package's: the fabricated and
default dies, routing by phase / precision / accuracy class / health,
``partition_slots`` and ``slot_fleets``, ``default_policy``, energy
telemetry, ``chip_matmul``, the format-joint ``autotune`` and
``tune_chip``.

The JAX package's chip module imports ``jax.experimental.enable_x64``, a
name jax 0.9.0 dropped, so the reference values are computed in one
subprocess that restores it before importing, and pickles them back; the
alias never enters this process (see tests/test_torch_dse.py).  Both sides
run the same call sequence (``_TABLE``, executed against each package) on
the reference's fitted parameters, with the reference's small electrical
grids (tests/test_chip.py).  Tolerances:

  * identical: unit names, designs, operating points, formats, routes,
    fleets, reject and fault outcomes, numerics policies, and every host
    metric row (``predict`` is numpy on both sides);
  * rtol 1e-12: metric values that come out of a sweep (the torch backend
    against JAX's float64), as in tests/test_torch_autotune.py;
  * bitwise: ``chip_matmul`` and ``matmul_for_policy`` (the plain K1 on the
    CPU) against the JAX package's emulated matmul.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import faults
from repro_torch.core import autotune as at
from repro_torch.core import chip
from repro_torch.core import energy_model as em
from repro_torch.core.dse import enumerate_structures
from repro_torch.core.fpu_arch import FABRICATED
from repro_torch.models.numerics import chip_matmul
from repro_torch.numerics import get_format, matmul_for_policy

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CPU = "cpu"
RTOL = 1e-12
VDD = np.round(np.arange(0.55, 1.101, 0.05), 3)
VBB = np.round(np.arange(0.0, 1.21, 0.3), 2)

#: the same calls against either package: ``ns`` holds its ``chip``,
#: ``at``, ``UnitFault``, ``FABRICATED``, ``get_format`` and
#: ``dev`` (``{}`` for JAX, ``{"device": "cpu"}`` for the port).
_TABLE = r'''
import dataclasses
import numpy as np


def make_unit(ns, name, fmt, rel_err, e_pj, phases=()):
    metrics = dict(freq_ghz=1.0, cycle_ns=1.0, p_total_mw=2e3 * e_pj,
                   area_mm2=0.01, gflops_per_w=1.0 / (e_pj * 1e-3),
                   gflops_per_mm2=200.0, e_eff_pj=e_pj, rel_err=rel_err,
                   avg_latency_penalty=0.0)
    return ns["chip"].ChipUnit(name, ns["FABRICATED"]["sp_cma"], 0.8, 1.2,
                               phases=phases, metrics=metrics,
                               fmt=ns["get_format"](fmt))


def pol_name(p):
    return (p.fmt.name, p.accum_style, p.fpu_design.name, p.emulate,
            p.kernel_style, p.compute_dtype)


def host_table(ns, params):
    chip, UnitFault, gf = ns["chip"], ns["UnitFault"], ns["get_format"]
    out = {}
    fab = chip.fabricated_chip(None, params)
    for prec in (None, "sp", "dp"):
        spec = chip.fabricated_chip(prec, params)
        out["spec", prec] = spec.as_dict()
    for u in fab.units:
        out["unit", u.name] = (u.key, dict(u.metrics), u.rel_err(),
                               u.e_per_flop_pj, u.gflops_effective,
                               u.area_mm2, u.avg_power_mw, u.energy_j(3e9),
                               u.operand_format.name, pol_name(u.numerics()),
                               pol_name(u.numerics(gf("fp8_e4m3"), True)),
                               chip.kernel_style_for(u.design),
                               u.as_dict())
    pol = chip.ChipPolicy(fab, params)
    phases = ("train", "prefill", "decode", "long", "bulk", "latency",
              "throughput", "chain", "train_4k", "decode_32k", "long_500k",
              "prefill_32k", "sp_fma", "dp_cma")
    slos = (None, 1e-2, 3e-8, 1e-8, 2e-17, 1e-30)
    for ph in phases:
        out["class", ph] = chip.workload_class(ph)
        for prec in (None, "sp", "dp"):
            for slo in slos:
                out["route", ph, prec, slo] = pol.unit_for_phase(
                    ph, precision=prec, accuracy_slo=slo).name
            for fmt in (gf("bf16"), None, gf("fp8_e5m2")):
                for emu in (False, True):
                    out["numerics", ph, prec, fmt and fmt.name,
                        emu] = pol_name(
                        pol.numerics_for_phase(ph, fmt=fmt, precision=prec,
                                               emulate=emu))
            out["e_pj", ph, prec] = pol.energy_per_flop_pj(ph, prec)
            out["req_j", ph, prec] = pol.request_energy_j(ph, 7e9, prec)
    for prec in (None, "sp", "dp"):
        for dc in (None, "interactive", "bulk"):
            for slo in slos:
                out["admit", prec, dc, slo] = pol.admission_unit(
                    precision=prec, deadline_class=dc,
                    accuracy_slo=slo).name
        for w in ("throughput", "latency"):
            out["select", w, prec] = pol.select_fpu(w, prec).name
    for bad in (lambda: pol.admission_unit(deadline_class="sideways"),
                lambda: pol.select_fpu("sideways"),
                lambda: fab.unit("no_such_unit")):
        try:
            bad()
            out.setdefault("raised", []).append(None)
        except Exception as e:
            out.setdefault("raised", []).append(type(e).__name__)
    for precs in (None, ("sp",), ("dp",), ("dp", "sp")):
        for dr in (False, True):
            for acc in ((None,), (None, 1e-2), (None, 1e-2, 3e-8), ()):
                out["fleet_units", precs, dr, acc] = [
                    u.name for u in pol.decode_fleet_units(
                        precisions=precs, deadline_routing=dr,
                        accuracy_slos=acc)]
                for n in (4, 5, 8, 13):
                    try:
                        out["slot_fleets", precs, dr, acc, n] = \
                            pol.slot_fleets(n, precisions=precs,
                                            deadline_routing=dr,
                                            accuracy_slos=acc)
                    except ValueError as e:
                        out["slot_fleets", precs, dr, acc, n] = str(e)
    units = fab.units
    for counts in ((1, 1, 1, 1), (3, 1, 2, 5), (7, 1, 1, 2), (1, 9, 4, 1)):
        us = [dataclasses.replace(u, count=c) for u, c in zip(units, counts)]
        for n in range(1, 14):
            for sub in (us, us[:2], us[1:]):
                try:
                    out["partition", counts, n, len(sub), sub[0].name] = \
                        chip.partition_slots(n, sub)
                except ValueError as e:
                    out["partition", counts, n, len(sub),
                        sub[0].name] = str(e)
    # telemetry
    for ph in ("train", "decode"):
        for prec in ("sp", "dp"):
            for bb in (True, False):
                out["tele", ph, prec, bb] = pol.step_energy_telemetry(
                    ph, achieved_flops=3e12, step_time_s=0.5,
                    peak_flops=2e13, adaptive_bb=bb, precision=prec)
    for name, d in ns["FABRICATED"].items():
        out["unit_tele", name] = chip.unit_energy_telemetry(
            d, params, achieved_flops=1e12, step_time_s=1.0,
            peak_flops=5e13, vdd=0.7, vbb_active=0.9)
    out["aggregate"] = chip.ChipPolicy.aggregate_telemetry(
        [out["tele", "train", "sp", True], out["tele", "decode", "dp", True],
         dict(unit="x", energy_j=2.5), {}])
    # health
    h = {}
    hp = chip.ChipPolicy(chip.fabricated_chip(None, params), params)
    h["r0"] = hp.unit_for_phase("decode", precision="sp").name
    v0 = hp.health_version
    hp.set_health("sp_cma", "dead", reason="test", now=1.5)
    h["dead"] = (hp.health_version > v0, len(hp._route),
                 hp.unit_for_phase("decode", precision="sp").name,
                 hp.in_service("sp_cma"), hp.unit_time_scale("sp_cma"))
    hp.clear_health("sp_cma")
    hp.set_health("sp_cma", "throttled", freq_scale=0.5, reason="thermal")
    u = hp.spec.unit("sp_cma")
    h["throttled"] = (hp.in_service("sp_cma"),
                      hp.unit_for_phase("decode", precision="sp").name,
                      hp.unit_time_scale("sp_cma"),
                      hp.unit_energy_scale("sp_cma"),
                      hp.unit_energy_j(u, 1e9))
    hp.set_health("sp_fma", "quarantined", reason="nan burst", now=4.2)
    h["both"] = (hp.unit_for_phase("decode", precision="sp").name,
                 hp.unit_for_phase("train", precision="sp").name,
                 hp.health_report(),
                 [x.name for x in hp.in_service_units()])
    for x in hp.spec.units:
        hp.set_health(x.name, "dead")
    try:
        hp.unit_for_phase("decode")
        h["all_dead"] = None
    except UnitFault:
        h["all_dead"] = "UnitFault"
    hp.clear_health()
    v1 = hp.health_version
    hp.unit_for_phase("decode", precision="sp")
    hp.set_health("sp_cma", "throttled", freq_scale=0.25)
    dp_only = chip.ChipSpec("dp-only", tuple(
        x for x in hp.spec.units if x.design.precision == "dp"))
    hp.replace_spec(dp_only)
    try:
        hp.unit_health("sp_cma")
        pruned = False
    except KeyError:
        pruned = True
    h["replace"] = (hp.health_version > v1, len(hp._route), pruned,
                    hp.unit_for_phase("decode").name)
    for bad in (dict(status="zombie"), dict(freq_scale=0.0)):
        try:
            chip.UnitHealth(**bad)
            h.setdefault("bad", []).append(None)
        except ValueError:
            h.setdefault("bad", []).append("ValueError")
    out["health"] = h
    # accuracy classes on a tiered die, and the bounded route cache
    eco = make_unit(ns, "decode_eco", "fp8_e4m3", 1e-2, 0.5)
    mid = make_unit(ns, "decode_mid", "bf16", 1e-3, 1.0)
    gold = make_unit(ns, "decode_gold", "fp32", 1e-8, 4.0)
    tp = chip.ChipPolicy(chip.ChipSpec("tiered", (eco, mid, gold)), params)
    for slo in (None, 5e-2, 5e-3, 1e-7, 1e-30):
        out["tiered", slo] = (tp.admission_unit(accuracy_slo=slo).name,
                              tp.unit_for_phase("train",
                                                accuracy_slo=slo).name)
    out["tiered_fleets"] = tp.slot_fleets(6, accuracy_slos=(5e-2, 1e-7))
    for i in range(5000):
        tp.admission_unit(accuracy_slo=1e-8 * (1 + i))
    out["route_cache"] = len(tp._route)
    for bad in (lambda: chip.ChipSpec("empty", ()),
                lambda: chip.ChipSpec("dup", (eco, eco)),
                lambda: chip.ChipSpec("tight", (eco,), area_budget_mm2=1e-3),
                lambda: chip.ChipSpec("hot", (eco,), tdp_budget_mw=1.0)):
        try:
            bad()
            out.setdefault("spec_raised", []).append(None)
        except ValueError as e:
            out.setdefault("spec_raised", []).append(str(e))
    return out


def swept_table(ns, params, cache, vdd, vbb):
    """Values that come out of a sweep: picks exact, metrics rtol 1e-12."""
    chip, at, gf = ns["chip"], ns["at"], ns["get_format"]
    dev = ns["dev"]
    out = {}
    for prec in ("sp", "dp"):
        spec = chip.default_chip(prec, params, **dev)
        out["default", prec] = [(u.name, u.design.name, u.vdd, u.vbb,
                                 u.phases, dict(u.metrics))
                                for u in spec.units]
        pol = chip.default_policy(prec, params, **dev)
        out["default_policy", prec] = (
            pol.spec.name, pol.select_fpu("throughput", prec).name,
            pol.select_fpu("latency", prec).name,
            [pol.unit_for_phase(ph, precision=prec).name
             for ph in ("train", "prefill", "decode")],
            pol_name(pol.numerics_for_phase("decode", precision=prec,
                                            emulate=True)))
    designs = tuple(ns["enumerate_structures"]("sp"))
    tiers = tuple(gf(f) for f in ("fp32", "bf16", "fp8_e4m3"))

    def tune(**kw):
        r = at.autotune(at.GEMM_STREAM, designs=designs, params=params,
                        vdd_grid=vdd, vbb_grid=vbb, cache=cache, **dev,
                        **kw)
        return (r.design.name, r.vdd, r.vbb, r.index, r.n_points,
                r.fmt.name if r.fmt is not None else None, r.format.name,
                dict(r.metrics), r.as_dict())

    out["base"] = tune()
    out["loose"] = tune(formats=tiers, accuracy_slo=5e-2)
    out["tight"] = tune(formats=tiers, accuracy_slo=1e-7)
    out["free"] = tune(formats=tiers)
    out["ladder"] = tune(accuracy_slo=1e-2)
    try:
        tune(formats=(gf("fp8_e4m3"),), accuracy_slo=1e-12)
        out["infeasible"] = None
    except ValueError as e:
        out["infeasible"] = str(e)
    phases = [chip.PhaseSpec("train", at.GEMM_STREAM, designs=designs,
                             flops_fraction=0.7, accuracy_slo=5e-2,
                             formats=tiers),
              chip.PhaseSpec("decode", at.DEPENDENT_CHAIN, designs=designs,
                             flops_fraction=0.3, accuracy_slo=1e-7,
                             formats=tiers)]
    budgets = (dict(), dict(area_budget_mm2=0.5),
               dict(area_budget_mm2=0.2, tdp_budget_mw=800.0))
    for i, b in enumerate(budgets):
        r = chip.tune_chip(phases, params=params, vdd_grid=vdd,
                           vbb_grid=vbb, cache=cache, name="slo_mix", **b,
                           **dev)
        rep = dict(r.report)
        rep.pop("cache_stats")
        out["tune_chip", i] = ([(u.name, u.design.name, u.vdd, u.vbb,
                                 u.count, u.fmt.name, u.phases)
                                for u in r.spec.units], rep)
    cfg_phases = chip.phases_from_config("tinyllama-1.1b")
    out["phases_cfg"] = [(p.name, dataclasses.asdict(p.profile),
                          p.precision, p.flops_fraction)
                         for p in cfg_phases]
    r = chip.tune_chip(cfg_phases, params=params, vdd_grid=vdd,
                       vbb_grid=vbb, cache=cache, accuracy_slo=1e-2, **dev)
    rep = dict(r.report)
    rep.pop("cache_stats")
    out["tune_cfg"] = ([(u.name, u.design.name, u.vdd, u.vbb, u.count,
                         u.fmt.name) for u in r.spec.units], rep)
    pol = r.policy
    out["tune_cfg_routes"] = [pol.unit_for_phase(ph).name for ph in (
        "train", "decode", "prefill", "train_4k", "decode_32k")]
    return out
'''

_REF = r"""
import pickle, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64  # the name jax 0.9.0 dropped
import jax.numpy as jnp
import numpy as np
from repro import faults
from repro.core import autotune as at, chip
from repro.core.dse import enumerate_structures
from repro.core.energy_model import SweepExecutableCache, calibrate
from repro.core.fpu_arch import FABRICATED
from repro.models.numerics import chip_matmul
from repro.numerics import get_format, matmul_for_policy

inp = pickle.load(open(sys.argv[1], "rb"))
exec(inp["table"])
ns = dict(chip=chip, at=at, UnitFault=faults.UnitFault,
          FABRICATED=FABRICATED, get_format=get_format, dev={},
          enumerate_structures=enumerate_structures)
params = calibrate()
out = dict(params=params.values, host=host_table(ns, params),
           swept=swept_table(ns, params, SweepExecutableCache(),
                             inp["vdd"], inp["vbb"]))
pol = chip.ChipPolicy(chip.fabricated_chip(None, params), params)
x, w = (jnp.asarray(t) for t in inp["mm"])
for ph in ("prefill", "decode"):
    for prec in ("sp", "dp"):
        for fmt in (None, "fp8_e4m3"):
            out["chip_matmul", ph, prec, fmt] = np.asarray(
                chip_matmul(x, w, pol, ph, fmt=fmt, precision=prec))
        np_pol = pol.numerics_for_phase(ph, precision=prec)
        out["matmul_for_policy", ph, prec] = np.asarray(
            matmul_for_policy(x, w, np_pol))
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
"""

exec(_TABLE)


def _mm_operands():
    rng = np.random.default_rng(6)
    return (rng.standard_normal((12, 300)).astype(np.float32),
            rng.standard_normal((300, 40)).astype(np.float32))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's values, computed in a subprocess (see above)."""
    d = tmp_path_factory.mktemp("chip_ref")
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump(dict(table=_TABLE, vdd=VDD, vbb=VBB,
                         mm=_mm_operands()), fh)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _REF, str(d / "in.pkl"),
                           str(d / "out.pkl")], capture_output=True,
                          text=True, env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(d / "out.pkl", "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def params(ref):
    return em.TechParams(ref["params"])


def _ns():
    return dict(chip=chip, at=at, UnitFault=faults.UnitFault,
                FABRICATED=FABRICATED, get_format=get_format,
                dev={"device": CPU},
                enumerate_structures=enumerate_structures)


@pytest.fixture(scope="module")
def swept(params):
    return swept_table(_ns(), params, em.SweepExecutableCache(), VDD, VBB)


def _match(got, want, rtol, path="", seen=None):
    """Equal structure; floats equal (rtol=0) or within rtol."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(map(str, got)) == \
            sorted(map(str, want)), path
        for k in want:
            _match(got[k], want[k], rtol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _match(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)) and not isinstance(
            want, bool):
        g, w = float(got), float(want)
        if math.isnan(w):
            assert math.isnan(g), path
        elif rtol == 0 or not math.isfinite(w) or w == 0:
            assert g == w, (path, g, w)
        else:
            assert abs(g / w - 1) <= rtol, (path, g, w)
    elif dataclasses.is_dataclass(want):
        _match(dataclasses.asdict(got), dataclasses.asdict(want), rtol, path)
    else:
        assert got == want, (path, got, want)


HOST_GROUPS = ("spec", "unit", "class", "route", "numerics", "e_pj",
               "req_j", "admit", "select", "raised", "fleet_units",
               "slot_fleets", "partition", "tele", "unit_tele", "aggregate",
               "health", "tiered", "tiered_fleets", "route_cache",
               "spec_raised")


def _group(table, name):
    return {k: v for k, v in table.items()
            if (k[0] if isinstance(k, tuple) else k) == name}


@pytest.mark.parametrize("group", HOST_GROUPS)
def test_host_facade_identical(ref, params, group):
    """Routing, fleets, health and telemetry: the same calls give
    the same values, float for float."""
    want = _group(ref["host"], group)
    assert want, group
    got = _group(host_table(_ns(), params), group)
    _match(got, want, 0.0, group)


def test_route_facts_as_the_reference_states_them(ref):
    """Spot facts of the fabricated die's routing the JAX package's own
    tests assert, read off the port's table."""
    host = ref["host"]
    assert host["route", "train", "sp", None] == "sp_fma"
    assert host["route", "decode", "dp", None] == "dp_cma"
    assert host["route", "decode_32k", "sp", None] == "sp_cma"
    assert host["admit", "sp", "bulk", None] == "sp_fma"
    assert host["health"]["all_dead"] == "UnitFault"
    assert host["route_cache"] <= 4096
    assert host["tiered", 1e-30][0] == "decode_gold"


@pytest.mark.parametrize("group", ("default", "default_policy", "base",
                                   "loose", "tight", "free", "ladder",
                                   "infeasible",
                                   "tune_chip", "phases_cfg", "tune_cfg",
                                   "tune_cfg_routes"))
def test_swept_picks_equal(ref, swept, group):
    """Default dies, ``default_policy``'s routes, the format-joint autotune
    and tune_chip: the same picks (design, operating point, format, fleet
    counts), their metrics within rtol 1e-12."""
    _match(_group(swept, group), _group(ref["swept"], group), RTOL, group)


def test_format_joint_acceptance(swept):
    """The reference's acceptance facts on the port's own tunes: a loose
    SLO downshifts to a sub-SP format with a GFLOPS/W win, a tight one
    keeps fp32 at the format-agnostic optimum, an unmeetable one raises."""
    base, loose, tight = swept["base"], swept["loose"], swept["tight"]
    assert base[5] is None and base[6] == "fp32"
    assert loose[5] in ("bf16", "fp8_e4m3") and loose[7]["rel_err"] <= 5e-2
    assert loose[7]["gflops_per_w"] > 1.5 * base[7]["gflops_per_w"]
    assert tight[5] == "fp32" and tight[:3] == base[:3]
    assert "no feasible" in swept["infeasible"]
    units, rep = swept["tune_chip", 0]
    assert units[0][5] != "fp32" and units[1][5] == "fp32"
    assert rep["units"][0]["accuracy_slo"] == 5e-2


@pytest.mark.parametrize("phase", ("prefill", "decode"))
def test_chip_matmul_bitwise(ref, params, phase):
    """The routed unit's (format, style) reaches the emulated matmul: the
    port's ``chip_matmul`` (the plain k-block route on the CPU) and
    ``matmul_for_policy`` through the plain K1 replay (``impl='fused'``)
    equal the JAX package's bitwise."""
    pol = chip.ChipPolicy(chip.fabricated_chip(None, params), params)
    x, w = (torch.from_numpy(t) for t in _mm_operands())
    for prec in ("sp", "dp"):
        for fmt in (None, "fp8_e4m3"):
            got = chip_matmul(x, w, pol, phase, fmt=fmt, precision=prec)
            np.testing.assert_array_equal(
                got.numpy(), ref["chip_matmul", phase, prec, fmt])
        np_pol = pol.numerics_for_phase(phase, precision=prec)
        got = matmul_for_policy(x, w, np_pol, impl="fused", device=CPU)
        np.testing.assert_array_equal(
            got.numpy(), ref["matmul_for_policy", phase, prec])
    # emulation really rounds: not the native product
    native = (x.double() @ w.double()).float()
    assert not torch.equal(chip_matmul(x, w, pol, phase), native)


def test_default_policy_is_cached_and_picks_the_default_die(params):
    chip.clear_policy_cache()
    pol = chip.default_policy("sp", params, device=CPU)
    assert pol.select_fpu("throughput", "sp") == chip.default_chip(
        "sp", params, device=CPU).unit("sp_throughput").design
    with pytest.raises(ValueError):
        pol.select_fpu("sideways", "sp")
    a = chip.default_policy("sp", params, device=CPU)
    assert chip.default_policy("sp", params, device=CPU) is a
    assert chip.default_policy("dp", params, device=CPU) is not a
    chip.clear_policy_cache()
