"""The port's fault-tolerant serving against the JAX package's: the fault
vocabulary (``faults``), the health monitor and ``ResilientServer``'s
recovery protocol under seeded chaos.

``FaultInjector`` and ``random_faults`` draw with numpy in both packages, so
they are compared in this process: the same events and the same corrupted
token columns for the same seed.  The serving scenarios are those of the
JAX package's tests/test_resilience.py (the monitor's verdicts; a kill
mid-run that loses nothing; every fleet killed, requests parked and a probe
bringing one back; a throttle detected and repriced; transient and
persistent corruption; the probe; backpressure; deadline shedding;
validation rejects; a random chaos soak), the kill again with chunked
prefill, and the JAX package's traced kill-and-corrupt scenario of
tests/test_telemetry.py.  They run on a
reduced tinyllama in float32 with a fake clock and ``synthetic_dispatch_s``
in both packages (``_SCENARIOS``, executed against each).  The JAX side
imports ``core.chip``, whose energy model needs the ``enable_x64`` alias
that jax 0.9.0 dropped, so it runs in one subprocess that restores it and
pickles its results and exported weights back (see
tests/test_torch_serve_chip.py).  Tolerances:

  * identical: tokens, routed units, requeue counts, reject codes, the
    fault log (its times are sums of the fake clock's ticks in both), the
    health report's statuses, parked/shed counts, and the traced
    scenario's span trees, events, metric timelines and system events;
  * rel 1e-9: every energy (the chip facade's own parity bound,
    tests/test_torch_serve_chip.py).

On the port's side the reference's own claims are asserted too: no request
is lost, and every finished stream is bitwise the port's own
``greedy_decode``, continuations included.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from repro import faults as jfaults
from repro_torch import faults
from repro_torch.configs.base import get_config
from repro_torch.core import chip
from repro_torch.core import energy_model as em
from repro_torch.core.chip import UnitHealth
from repro_torch.core.fpu_arch import FABRICATED
from repro_torch.models import LM
from repro_torch.models.convert import params_from_jax
from repro_torch.numerics import get_format
from repro_torch.serve import engine, resilience
from repro_torch.telemetry import Tracer

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CPU = "cpu"
REL = 1e-9

#: the scenarios, against either package: ``ns`` holds its ``engine``,
#: ``resilience``, ``chip``, ``faults``, ``UnitHealth``, ``FABRICATED``,
#: ``get_format``, ``Tracer``, the model and weights, the fitted
#: parameters ``P`` and the prompt dtype.
_SCENARIOS = r'''
import numpy as np

TICK = 0.05


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def make_unit(ns, name, fmt, rel_err, e_pj):
    metrics = dict(freq_ghz=1.0, cycle_ns=1.0, p_total_mw=2e3 * e_pj,
                   area_mm2=0.01, gflops_per_w=1.0 / (e_pj * 1e-3),
                   gflops_per_mm2=200.0, e_eff_pj=e_pj, rel_err=rel_err,
                   avg_latency_penalty=0.0)
    return ns["chip"].ChipUnit(name, ns["FABRICATED"]["sp_cma"], 0.8, 1.2,
                               metrics=metrics, fmt=ns["get_format"](fmt))


def tiered_policy(ns):
    chip = ns["chip"]
    spec = chip.ChipSpec("tiered", (
        make_unit(ns, "decode_eco", "fp8_e4m3", 1e-2, 0.5),
        make_unit(ns, "decode_gold", "fp32", 1e-8, 4.0)))
    return chip.ChipPolicy(spec, ns["P"])


def requests(ns, n=6, new_tokens=8, seed=5, **kw):
    rng = np.random.default_rng(seed)
    kw.setdefault("accuracy_slo", 5e-2)
    return [ns["engine"].Request(
        uid=i, prompt=rng.integers(0, 256, 4 + i % 4).astype(ns["dtype"]),
        max_new_tokens=new_tokens, **kw) for i in range(n)]


def server(ns, events=(), *, probe=None, slots=4, seed=3, tracer=None,
           chunk=None, **res_kw):
    R, F = ns["resilience"], ns["faults"]
    clock = FakeClock()
    srv = R.ResilientServer(
        ns["model"], ns["params"], slots=slots, max_len=64,
        chip_policy=tiered_policy(ns), accuracy_fleets=(5e-2, 1e-7),
        dispatch_tokens=3, clock=clock, tracer=tracer, prefill_chunk=chunk,
        injector=F.FaultInjector(events, seed=seed) if events else None,
        resilience=R.ResilienceConfig(synthetic_dispatch_s=TICK,
                                      probe_interval_s=probe, **res_kw))
    return srv, clock


def drive(srv, clock, max_steps=300):
    for _ in range(max_steps):
        clock.t += TICK
        srv.step()
        if srv.idle():
            break


def row(r):
    return dict(uid=r.uid, output=list(r.output), routed=r.routed_unit,
                done=r.done, expired=r.expired, rejected=r.rejected,
                reason=r.reject_reason.split("]")[0] + "]",
                requeues=r.requeues, energy=r.energy_j,
                units=dict(r.unit_energy_j))


def served(ns, srv, reqs, **extra):
    out = dict(reqs=[row(r) for r in reqs], report=srv.resilience_report(),
               finished=sorted(r.uid for r in srv.finished if r.done),
               parked=len(srv._parked), wasted=srv.wasted_energy_j,
               energy=srv.energy_report())
    out.update(extra)
    return out


def verdict(v):
    return None if v is None else (v.unit, v.status, v.freq_scale)


def sc_monitor(ns):
    M = ns["resilience"].HealthMonitor
    out = {}
    mon = M(window=8, tolerance=1.5, trip=2, recover_trip=2)
    out["throttle"] = [verdict(mon.observe_dispatch("u", dt))
                       for dt in [0.1] * 6 + [0.4, 0.4, 0.1, 0.1]]
    mon = M(window=8, tolerance=1.5, trip=3)
    out["streak"] = [verdict(mon.observe_dispatch("u", dt))
                     for dt in [0.1] * 5 + [0.5, 0.5, 0.1, 0.5]]
    mon = M()
    out["fault"] = verdict(mon.observe_fault("u", "no output"))
    out["corrupt"] = verdict(mon.observe_corruption("u", 5))
    out["counts"] = (dict(mon.fault_dispatches),
                     dict(mon.corrupt_dispatches))
    return out


def sc_kill(ns, chunk=None):
    K = ns["faults"].FaultKind
    srv, clock = server(ns, (ns["faults"].FaultEvent(
        at_s=3 * TICK, unit="decode_eco", kind=K.KILL),), chunk=chunk)
    reqs = requests(ns)
    for r in reqs:
        srv.submit(r)
    first = [r.routed_unit for r in reqs]
    drive(srv, clock)
    return served(ns, srv, reqs, first_routes=first)


def sc_kill_all(ns):
    F = ns["faults"]
    K = F.FaultKind
    srv, clock = server(ns, (
        F.FaultEvent(at_s=TICK, unit="decode_eco", kind=K.KILL),
        F.FaultEvent(at_s=TICK, unit="decode_gold", kind=K.KILL,
                     duration_s=4 * TICK)), probe=6 * TICK)
    reqs = requests(ns, n=3)
    for r in reqs:
        srv.submit(r)
    for _ in range(3):
        clock.t += TICK
        srv.step()
    parked_mid = len(srv._parked)
    mid = [(r.done, r.expired) for r in reqs]
    try:
        srv.submit(ns["engine"].Request(uid=9, prompt=reqs[0].prompt,
                                        max_new_tokens=2))
        new = None
    except F.UnitFault:
        new = "UnitFault"
    drive(srv, clock)
    return served(ns, srv, reqs, parked_mid=parked_mid, mid=mid,
                  new_submit=new)


def sc_throttle(ns):
    K = ns["faults"].FaultKind
    srv, clock = server(ns, (ns["faults"].FaultEvent(
        at_s=3 * TICK, unit="decode_eco", kind=K.THROTTLE,
        magnitude=0.5),))
    reqs = requests(ns, n=4, new_tokens=10)
    for r in reqs:
        srv.submit(r)
    drive(srv, clock)
    return served(ns, srv, reqs)


def sc_throttle_price(ns):
    policy = tiered_policy(ns)
    u = policy.spec.unit("decode_eco")
    base = policy.unit_energy_j(u, 1e9)
    policy.set_health("decode_eco", ns["UnitHealth"].THROTTLED,
                      freq_scale=0.5)
    return dict(base=base, derated=policy.unit_energy_j(u, 1e9),
                scale=policy.unit_energy_scale("decode_eco"))


def sc_transient_corrupt(ns):
    K = ns["faults"].FaultKind
    srv, clock = server(ns, (ns["faults"].FaultEvent(
        at_s=3 * TICK, unit="decode_eco", kind=K.CORRUPT,
        duration_s=3 * TICK, magnitude=1.0),), probe=1.0,
        backoff_base_s=2 * TICK)
    reqs = requests(ns)
    for r in reqs:
        srv.submit(r)
    drive(srv, clock)
    return served(ns, srv, reqs)


def sc_persistent_corrupt(ns):
    K = ns["faults"].FaultKind
    srv, clock = server(ns, (ns["faults"].FaultEvent(
        at_s=3 * TICK, unit="decode_eco", kind=K.CORRUPT, magnitude=1.0),),
        max_retries=2, backoff_base_s=TICK)
    reqs = requests(ns)
    for r in reqs:
        srv.submit(r)
    drive(srv, clock)
    return served(ns, srv, reqs)


def sc_probe(ns):
    K = ns["faults"].FaultKind
    srv, clock = server(ns, (ns["faults"].FaultEvent(
        at_s=3 * TICK, unit="decode_eco", kind=K.KILL,
        duration_s=4 * TICK),), probe=6 * TICK)
    first = requests(ns)
    for r in first:
        srv.submit(r)
    drive(srv, clock)
    late = ns["engine"].Request(uid=99, prompt=first[0].prompt,
                                max_new_tokens=4, accuracy_slo=5e-2)
    srv.submit(late)
    late_route = late.routed_unit
    drive(srv, clock)
    return served(ns, srv, first + [late], late_route=late_route,
                  eco_in_service=srv.chip_policy.in_service("decode_eco"))


def sc_backpressure(ns):
    srv, _ = server(ns, backpressure_depth=0.5)
    srv.chip_policy.set_health("decode_eco", ns["UnitHealth"].THROTTLED,
                               freq_scale=0.5, reason="test")
    reqs = requests(ns, n=4)
    srv.submit(reqs[0])
    try:
        srv.submit(reqs[1])
        code = None
    except ns["engine"].RequestRejected as e:
        code = e.code
    return dict(code=code, reqs=[row(r) for r in reqs[:2]],
                rejected=[r.uid for r in srv.rejected])


def sc_shed(ns):
    srv, clock = server(ns, shed_unmeetable=True)
    srv.chip_policy.set_health("decode_eco", ns["UnitHealth"].THROTTLED,
                               freq_scale=0.1, reason="test")
    prompt = requests(ns, 1)[0].prompt
    Req = ns["engine"].Request
    hopeless = Req(uid=0, prompt=prompt, max_new_tokens=30,
                   accuracy_slo=5e-2, deadline_s=clock.t + TICK / 10)
    patient = Req(uid=1, prompt=prompt, max_new_tokens=4,
                  accuracy_slo=5e-2)
    srv.submit(hopeless)
    srv.submit(patient)
    clock.t += TICK
    srv.step()
    shed_now = ([r.uid for r in srv.shed_requests],
                [r.uid for r in srv.rejected])
    drive(srv, clock)
    return served(ns, srv, [hopeless, patient], shed_now=shed_now)


VALIDATION = [("max_new_tokens", 0), ("max_new_tokens", "ten"),
              ("accuracy_slo", -1e-3), ("precision", "fp4"),
              ("accuracy_slo", 1e-30)]


def sc_validation(ns):
    eng = ns["engine"]
    out = []
    cases = [dict(dict(uid=0, prompt=np.arange(4).astype(ns["dtype"]),
                       max_new_tokens=4), **{field: value})
             for field, value in VALIDATION]
    cases += [dict(uid=0, prompt=p, max_new_tokens=4) for p in (
        np.zeros((2, 2), ns["dtype"]), np.zeros(0, ns["dtype"]),
        np.zeros(4, np.float32), np.zeros(4096, ns["dtype"]))]
    for kw in cases:
        srv, _ = server(ns)
        req = eng.Request(**kw)
        try:
            srv.submit(req)
            out.append(None)
        except eng.RequestRejected as e:
            out.append((e.code, req.rejected,
                        req.reject_reason.split("]")[0] + "]",
                        req in srv.rejected,
                        all(not q for q in srv._queues.values())))
    return out


def sc_soak(ns):
    F = ns["faults"]
    events = F.random_faults(["decode_eco", "decode_gold"], horizon_s=2.0,
                             n_events=5, seed=11, mean_duration_s=0.4)
    srv, clock = server(ns, tuple(events), probe=0.5, backoff_base_s=TICK)
    reqs = requests(ns, n=8)
    for r in reqs:
        srv.submit(r)
    drive(srv, clock, max_steps=600)
    return served(ns, srv, reqs, events=[e.as_dict() for e in events])


def span_rows(tr):
    return [(s.span_id, s.uid, s.parent_id, s.name, s.site, s.fleet,
             s.start_s, s.end_s, s.status, s.energy_j,
             dict(s.unit_energy_j), s.prefill_tokens, s.decode_tokens,
             [tuple(e) for e in s.events], dict(s.attrs)) for s in tr.spans]


def sc_traced(ns):
    F = ns["faults"]
    K = F.FaultKind
    tracer = ns["Tracer"]()
    events = (F.FaultEvent(at_s=0.3, unit="decode_eco", kind=K.CORRUPT,
                           magnitude=1.0, duration_s=2 * TICK),
              F.FaultEvent(at_s=0.8, unit="decode_eco", kind=K.KILL,
                           magnitude=1.0))
    srv, clock = server(ns, events, probe=2.0, tracer=tracer)
    reqs = requests(ns)
    for r in reqs:
        srv.submit(r)
    drive(srv, clock)
    return served(ns, srv, reqs, spans=span_rows(tracer),
                  metrics=dict(tracer.metrics),
                  system=list(tracer.system_events),
                  integrity=tracer.check_integrity(),
                  span_energy=tracer.total_energy_j(),
                  span_units=tracer.unit_energy_j(),
                  req_span_energy={r.uid: tracer.request_energy_j(r.uid)
                                   for r in reqs})


def sc_kill_chunked(ns):
    """The kill with 3-token prefill chunks: continuations re-prefill chunk
    by chunk and commit nothing at their final chunk."""
    return sc_kill(ns, chunk=3)


SCENARIOS = dict(monitor=sc_monitor, kill=sc_kill,
                 kill_chunked=sc_kill_chunked, kill_all=sc_kill_all,
                 throttle=sc_throttle, throttle_price=sc_throttle_price,
                 transient_corrupt=sc_transient_corrupt,
                 persistent_corrupt=sc_persistent_corrupt, probe=sc_probe,
                 backpressure=sc_backpressure, shed=sc_shed,
                 validation=sc_validation, soak=sc_soak, traced=sc_traced)
'''

_REF = r"""
import dataclasses, pickle, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64  # the name jax 0.9.0 dropped
import numpy as np
from repro import faults
from repro.configs.base import get_config
from repro.core import chip
from repro.core.chip import UnitHealth
from repro.core.energy_model import calibrate
from repro.core.fpu_arch import FABRICATED
from repro.models import LM
from repro.numerics import get_format
from repro.serve import engine, resilience
from repro.telemetry import Tracer

exec(sys.argv[1])
cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                          dtype="float32")
model = LM(cfg)
params = model.init(jax.random.PRNGKey(3))
P = calibrate()
ns = dict(engine=engine, resilience=resilience, chip=chip, faults=faults,
          UnitHealth=UnitHealth, FABRICATED=FABRICATED,
          get_format=get_format, Tracer=Tracer, P=P, model=model,
          params=params, dtype=np.int32)
out = dict(P=P.values, weights=jax.tree.map(np.asarray, params))
for name, fn in SCENARIOS.items():
    out[name] = fn(ns)
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
"""

exec(_SCENARIOS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's scenario results and weights, from one subprocess
    (see above)."""
    path = tmp_path_factory.mktemp("resilience_ref") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _REF, _SCENARIOS,
                           str(path)], capture_output=True, text=True,
                          env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def ns(ref):
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    return dict(engine=engine, resilience=resilience, chip=chip,
                faults=faults, UnitHealth=UnitHealth, FABRICATED=FABRICATED,
                get_format=get_format, Tracer=Tracer,
                P=em.TechParams(ref["P"]), model=LM(cfg, device=CPU),
                params=params_from_jax(ref["weights"], cfg, device=CPU),
                dtype=np.int64)


@pytest.fixture(scope="module")
def port(ns):
    """Each scenario's port results, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = SCENARIOS[name](ns)
        return cache[name]

    return get


def _match(got, want, path=""):
    """Equal structure and values; floats equal, or within REL where the
    key names an energy."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(map(str, got)) == \
            sorted(map(str, want)), (path, sorted(got), sorted(want))
        for k in want:
            _match(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _match(g, w, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)) and not isinstance(
            want, bool):
        g, w = float(got), float(want)
        energy = any(k in path for k in ("energy", "units", "wasted",
                                         "_j", "base", "derated", "scale",
                                         "spans"))
        if math.isnan(w):
            assert math.isnan(g), path
        elif energy and w != 0 and math.isfinite(w):
            assert abs(g / w - 1) <= REL, (path, g, w)
        else:
            assert g == w, (path, g, w)
    elif isinstance(want, (np.integer, int)) and not isinstance(want, bool):
        assert int(got) == int(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def greedy(ns):
    """The port's single-sequence streams, cached per (prompt, length)."""
    cache = {}

    def get(prompt, n):
        key = (tuple(int(t) for t in prompt), n)
        if key not in cache:
            cache[key] = engine.greedy_decode(ns["model"], ns["params"],
                                              np.asarray(prompt), n,
                                              max_len=64)
        return cache[key]

    return get


# ----------------------------------------------------------- fault vocabulary
def _events(mod):
    F = mod
    return [F.FaultEvent(at_s=0.2, unit="u0", kind=F.FaultKind.CORRUPT,
                         duration_s=1.0, magnitude=0.6),
            F.FaultEvent(at_s=0.1, unit="u1", kind=F.FaultKind.THROTTLE,
                         magnitude=0.5),
            F.FaultEvent(at_s=0.4, unit="u0", kind=F.FaultKind.CORRUPT,
                         duration_s=0.5, magnitude=0.9),
            F.FaultEvent(at_s=0.3, unit="u1", kind=F.FaultKind.KILL,
                         duration_s=0.2)]


def test_fault_injector_matches_jax():
    """The same schedule gives the same polls, symptoms and corrupted token
    columns, dispatch after dispatch, as ``repro.faults``."""
    toks = np.arange(40, dtype=np.int64).reshape(8, 5)
    ij = jfaults.FaultInjector(_events(jfaults), seed=7)
    it = faults.FaultInjector(_events(faults), seed=7)
    assert [e.as_dict() for e in it.events] == \
        [e.as_dict() for e in ij.events]
    assert it.CORRUPT_TOKEN == ij.CORRUPT_TOKEN == -(2 ** 30)
    for now in np.arange(0.0, 1.2, 0.05):
        assert [e.as_dict() for e in it.poll(now)] == \
            [e.as_dict() for e in ij.poll(now)]
        for unit in ("u0", "u1"):
            assert it.killed(unit, now) == ij.killed(unit, now)
            assert it.time_scale(unit, now) == ij.time_scale(unit, now)
            for col in range(toks.shape[1]):
                gt, nt = it.corrupt_tokens(unit, now, toks[:, col])
                gj, nj = ij.corrupt_tokens(unit, now, toks[:, col])
                np.testing.assert_array_equal(gt, gj)
                assert nt == nj
    assert it._dispatch_counter == ij._dispatch_counter > 0
    with pytest.raises(ValueError):
        faults.FaultEvent(at_s=0.0, unit="u", kind="melt")
    with pytest.raises(ValueError):
        faults.FaultEvent(at_s=0.0, unit="u", kind=faults.FaultKind.THROTTLE,
                          magnitude=1.5)


@pytest.mark.parametrize("seed", [0, 11, 12345])
def test_random_faults_match_jax(seed):
    kw = dict(horizon_s=2.0, n_events=9, seed=seed, mean_duration_s=0.4)
    got = faults.random_faults(["a", "b", "c"], **kw)
    want = jfaults.random_faults(["a", "b", "c"], **kw)
    assert [e.as_dict() for e in got] == [e.as_dict() for e in want]
    got = faults.random_faults(["a"], kinds=(faults.FaultKind.CORRUPT,),
                               **kw)
    want = jfaults.random_faults(["a"], kinds=(jfaults.FaultKind.CORRUPT,),
                                 **kw)
    assert [e.as_dict() for e in got] == [e.as_dict() for e in want]


def test_step_failure_schedule():
    hook = faults.step_failure_schedule({2, 5})
    for step in range(8):
        if step in (2, 5):
            with pytest.raises(faults.SimulatedFailure):
                hook(step)
        else:
            hook(step)
    hook(2)  # each listed step fires once


# ---------------------------------------------------------------- scenarios
def _same(port, ref, name):
    got = port(name)
    _match(got, ref[name], name)
    return got


def _held_to_greedy(got, ns, greedy, n=None, new_tokens=8):
    """No request lost, and each stream bitwise the port's greedy_decode."""
    for r in got["reqs"]:
        if r["uid"] >= 50:
            continue
        assert r["done"] and not r["expired"], r["uid"]
    reqs = requests(ns, n=n or len(got["reqs"]), new_tokens=new_tokens)
    by_uid = {r.uid: r for r in reqs}
    for r in got["reqs"]:
        if r["uid"] in by_uid:
            want = greedy(by_uid[r["uid"]].prompt,
                          by_uid[r["uid"]].max_new_tokens)
            assert r["output"] == want, r["uid"]


def test_monitor_verdicts_match_jax(port, ref):
    got = _same(port, ref, "monitor")
    assert got["throttle"][:7] == [None] * 7
    unit, status, scale = got["throttle"][7]
    assert status == UnitHealth.THROTTLED
    assert scale == pytest.approx(0.25, rel=0.05)
    assert got["throttle"][9][1] == UnitHealth.HEALTHY
    assert got["streak"] == [None] * 9
    assert got["fault"][1] == UnitHealth.DEAD
    assert got["corrupt"][1] == resilience.HealthVerdict.CORRUPT


@pytest.mark.parametrize("name", ["kill", "kill_chunked"])
def test_kill_midrun_matches_jax(port, ref, ns, greedy, name):
    got = _same(port, ref, name)
    assert got["first_routes"] == ["decode_eco"] * 6
    assert got["finished"] == list(range(6))
    _held_to_greedy(got, ns, greedy)
    for r in got["reqs"]:
        assert r["routed"] == "decode_gold" and r["requeues"] >= 1
    rep = got["report"]
    assert rep["health"]["decode_eco"]["status"] == UnitHealth.DEAD
    kills = [f for f in rep["fault_log"] if f["kind"] == "kill"]
    assert kills and kills[0]["recovered_s"] is not None
    assert rep["recovery_latency_s"]["max"] > 0.0


def test_kill_of_every_fleet_parks_matches_jax(port, ref, ns, greedy):
    got = _same(port, ref, "kill_all")
    assert got["parked_mid"] > 0
    assert got["mid"] == [(False, False)] * 3
    assert got["new_submit"] == "UnitFault"
    _held_to_greedy(got, ns, greedy)
    assert got["parked"] == 0


def test_throttle_matches_jax(port, ref, ns, greedy):
    got = _same(port, ref, "throttle")
    _held_to_greedy(got, ns, greedy, new_tokens=10)
    h = got["report"]["health"]["decode_eco"]
    assert h["status"] == UnitHealth.THROTTLED and h["in_service"]
    assert h["freq_scale"] == pytest.approx(0.5, rel=0.1)
    assert h["energy_scale"] > 1.0
    price = _same(port, ref, "throttle_price")
    assert price["derated"] > price["base"]
    assert 1.0 < price["scale"] <= 2.0


def test_transient_corruption_matches_jax(port, ref, ns, greedy):
    got = _same(port, ref, "transient_corrupt")
    _held_to_greedy(got, ns, greedy)
    for r in got["reqs"]:
        assert faults.FaultInjector.CORRUPT_TOKEN not in r["output"]
    assert sum(got["report"]["corrupt_dispatches"].values()) >= 1
    assert got["wasted"] > 0.0


def test_persistent_corruption_matches_jax(port, ref, ns, greedy):
    got = _same(port, ref, "persistent_corrupt")
    _held_to_greedy(got, ns, greedy)
    assert all(r["routed"] == "decode_gold" for r in got["reqs"])
    h = got["report"]["health"]["decode_eco"]
    assert h["status"] == UnitHealth.QUARANTINED and not h["in_service"]


def test_probe_matches_jax(port, ref, ns, greedy):
    got = _same(port, ref, "probe")
    _held_to_greedy(got, ns, greedy, n=6)
    assert got["late_route"] == "decode_eco" and got["eco_in_service"]
    assert got["reqs"][-1]["done"]


def test_backpressure_matches_jax(port, ref):
    got = _same(port, ref, "backpressure")
    assert got["code"] == "backpressure"
    assert got["reqs"][1]["rejected"] and got["rejected"] == [1]


def test_deadline_shedding_matches_jax(port, ref):
    got = _same(port, ref, "shed")
    assert got["shed_now"] == ([0], [0])
    hopeless, patient = got["reqs"]
    assert hopeless["rejected"] and hopeless["reason"] == \
        "[shed_unmeetable]"
    assert patient["done"] and not patient["rejected"]


def test_validation_rejects_match_jax(port, ref):
    got = _same(port, ref, "validation")
    codes = [g[0] for g in got]
    assert codes == ["bad_max_tokens", "bad_max_tokens", "bad_accuracy_slo",
                     "unknown_precision", "accuracy_slo_unmeetable",
                     "bad_prompt", "bad_prompt", "bad_prompt",
                     "prompt_too_long"]
    assert all(g[1] and g[3] and g[4] for g in got)


def test_chaos_soak_matches_jax(port, ref, ns, greedy):
    got = _same(port, ref, "soak")
    assert got["finished"] == list(range(8))
    _held_to_greedy(got, ns, greedy)


def test_traced_recovery_matches_jax(port, ref):
    """The JAX package's traced corrupt-then-kill scenario: span trees,
    events, timelines and system events equal; the span energy reconciles
    with the ledger per unit and per request, on the port's side too."""
    got = _same(port, ref, "traced")
    assert got["integrity"] == []
    ledger = got["energy"]["per_unit_j"]
    assert got["span_energy"] == pytest.approx(sum(ledger.values()),
                                               rel=REL)
    for unit, e in got["span_units"].items():
        assert e == pytest.approx(ledger[unit], rel=REL)
    for r in got["reqs"]:
        assert got["req_span_energy"][r["uid"]] == pytest.approx(
            r["energy"], rel=REL)
    assert any(r["requeues"] for r in got["reqs"])


# ------------------------------------------------------- the device's faults
def test_a_device_error_propagates_and_drains_nothing(ns, monkeypatch):
    """Faults are the injector's symptoms only: an exception from the model
    (as a kernel or its build would raise) reaches the caller, and no
    fleet is drained or marked."""
    srv, clock = server(ns, (faults.FaultEvent(
        at_s=100.0, unit="decode_eco", kind=faults.FaultKind.KILL),))
    for r in requests(ns, n=4):
        srv.submit(r)
    clock.t += TICK
    srv.step()

    def broken(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(ns["model"], "decode_scan", broken)
    clock.t += TICK
    with pytest.raises(RuntimeError, match="illegal memory access"):
        srv.step()
    assert srv.fault_log == [] and not srv._out_of_service
    assert all(h["status"] == UnitHealth.HEALTHY
               for h in srv.chip_policy.health_report().values())


def test_resilient_server_needs_a_chip_policy(ns):
    with pytest.raises(ValueError, match="chip_policy"):
        resilience.ResilientServer(ns["model"], ns["params"], slots=2,
                                   max_len=32)
