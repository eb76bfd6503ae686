"""The port's cluster layer against the JAX package's: ``ClusterSpec`` and
``homogeneous``, the seeded load generator and ``latency_stats``, the
``ClusterRouter`` (accuracy, deadline and least-loaded routing, structured
rejects, a die killed with traffic on it, every die failed and one
restored, a one-die cluster against a bare ``BatchedServer``, chunked
prefill on every die, a traced die kill mid-prefill), trace replay with and
without ``StepCost``, and ``tune_cluster``.

The scenarios are those of the JAX package's tests/test_cluster.py, the
cluster router of tests/test_serve_chunked.py and the traced die kill of
tests/test_telemetry.py, run against each package (``_SCENARIOS``) on a
reduced tinyllama in float32 with the reference's weights
(``params_from_jax``).  ``repro.cluster`` imports ``core.chip``, whose
energy model needs the ``enable_x64`` alias jax 0.9.0 dropped, so the JAX
side runs in one subprocess that restores it and pickles its results and
weights back (see tests/test_torch_resilience.py).  Tolerances:

  * identical: arrivals (times, classes, prompts, deadlines), tokens,
    placements, routed units, requeues, migrations, parked counts, reject
    codes and reasons, error messages, and the simulated latencies, TTFTs
    and spans (all are sums of the same ticks), span trees field for
    field;
  * rel 1e-9: energies (the chip facade's serving bound,
    tests/test_torch_serve_chip.py);
  * rtol 1e-12: ``tune_cluster``'s and ``tune_chip``'s reports (the torch
    sweep against JAX's float64, tests/test_torch_chip.py); picks and
    counts identical.

The port's side also keeps the reference's own claims: nothing is lost and
every stream is bitwise the port's ``greedy_decode``.  One test is the
port's alone: an error that is not ``faults.UnitFault`` raised by a die's
``admission_unit`` propagates out of ``route()``.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import cluster as tcluster
from repro_torch.configs.base import get_config
from repro_torch.core import autotune as at
from repro_torch.core import chip
from repro_torch.core import energy_model as em
from repro_torch.core.fpu_arch import FABRICATED
from repro_torch.faults import UnitFault
from repro_torch.models import LM
from repro_torch.models.convert import params_from_jax
from repro_torch.numerics import get_format
from repro_torch.serve import engine
from repro_torch.telemetry import Event, Tracer

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CPU = "cpu"
REL = 1e-9
RTOL_TUNE = 1e-12

#: the scenarios, against either package: ``ns`` holds its ``cluster``
#: package, ``chip``, ``engine``, ``at`` (autotune), ``get_format``,
#: ``FABRICATED``, ``Event``, ``SweepExecutableCache``, the fitted
#: parameters ``P``, the model and weights, and ``dev`` (the device
#: keyword of the port's DSE calls; empty for the reference).
_SCENARIOS = r'''
import numpy as np

TICK = 0.05
MAX_LEN = 64
VDD = np.round(np.arange(0.55, 1.101, 0.05), 3)
VBB = np.round(np.arange(0.0, 1.21, 0.3), 2)


def make_unit(ns, name, fmt, rel_err, e_pj, phases=()):
    metrics = dict(freq_ghz=1.0, cycle_ns=1.0, p_total_mw=2e3 * e_pj,
                   area_mm2=0.01, gflops_per_w=1.0 / (e_pj * 1e-3),
                   gflops_per_mm2=200.0, e_eff_pj=e_pj, rel_err=rel_err,
                   avg_latency_penalty=0.0)
    return ns["chip"].ChipUnit(name, ns["FABRICATED"]["sp_cma"], 0.8, 1.2,
                               phases=phases, metrics=metrics,
                               fmt=ns["get_format"](fmt))


def eco_gold(ns):
    chip, C = ns["chip"], ns["cluster"]
    return C.ClusterSpec("eco+gold", (
        chip.ChipSpec("eco", (make_unit(ns, "decode_eco", "fp8_e4m3", 1e-2,
                                        0.5),)),
        chip.ChipSpec("gold", (make_unit(ns, "decode_gold", "fp32", 1e-8,
                                         4.0),))))


def router(ns, spec, *, slots=4, **kw):
    C = ns["cluster"]
    clock = C.SimClock()
    kw.setdefault("accuracy_fleets", (5e-2, 1e-7))
    kw.setdefault("dispatch_tokens", 3)
    return C.ClusterRouter(ns["model"], ns["params"], spec, slots=slots,
                           max_len=MAX_LEN, clock=clock, **kw), clock


def requests(ns, n=6, new_tokens=8, seed=5, lens=None, **kw):
    rng = np.random.default_rng(seed)
    lens = lens or [4 + i % 4 for i in range(n)]
    return [ns["engine"].Request(
        uid=i, prompt=rng.integers(0, 256, n_).astype(np.int32),
        max_new_tokens=new_tokens, **kw) for i, n_ in enumerate(lens)]


def drive(target, clock, max_steps=400, tick=TICK):
    for _ in range(max_steps):
        clock.t += tick
        target.step()
        if target.idle():
            break


def row(r):
    return dict(uid=r.uid, prompt=[int(t) for t in r.prompt],
                output=list(r.output), routed=r.routed_unit, done=r.done,
                expired=r.expired, rejected=r.rejected,
                reason=r.reject_reason, requeues=r.requeues,
                submitted_s=r.submitted_s, first_token_s=r.first_token_s,
                energy=r.energy_j, units=dict(r.unit_energy_j))


def reports(rt):
    return dict(cluster=rt.cluster_report(), load=rt.load_report(),
                utilization=rt.utilization_report(),
                energy=rt.energy_report())


def error(fn):
    try:
        fn()
    except (ValueError, KeyError) as e:
        return (type(e).__name__, str(e))
    return None


def sc_spec(ns):
    chip, C = ns["chip"], ns["cluster"]
    die = chip.ChipSpec("d0", (make_unit(ns, "u", "fp32", 1e-8, 1.0),))
    out = dict(
        empty=error(lambda: C.ClusterSpec("empty", ())),
        dup=error(lambda: C.ClusterSpec("dup", (die, die))),
        tight=error(lambda: C.ClusterSpec(
            "tight", (die,), area_budget_mm2=die.area_mm2 / 2)),
        hot=error(lambda: C.ClusterSpec(
            "hot", (die,), tdp_budget_mw=die.peak_power_mw / 2)),
        none=error(lambda: C.homogeneous(die, 0)))
    c = C.homogeneous(die, 3)
    out["homogeneous"] = c.as_dict()
    out["named"] = C.homogeneous(die, 2, name="pair").name
    out["die2_units_equal"] = c.chip("d0/die2").units == die.units
    out["unknown_die"] = error(lambda: c.chip("nope"))
    out["budgeted"] = C.ClusterSpec("ok", (die,), area_budget_mm2=1.0,
                                    tdp_budget_mw=1e6).as_dict()
    return out


TRACES = dict(
    two_class=dict(horizon_s=10.0, base_rate_rps=2.0, seed=11,
                   classes=(("a", dict(weight=2)),
                            ("b", dict(deadline_slack_s=1.5)))),
    default=dict(),
    smoke=dict(horizon_s=3.0, base_rate_rps=2.0, diurnal_amplitude=0.6,
               diurnal_period_s=12.0, burst_multiplier=3.0, burst_on_s=1.5,
               burst_off_s=5.0, seed=7,
               classes=(("loose_bulk", dict(weight=3,
                                            prompt_lens=(16, 32, 64, 128),
                                            max_new_tokens=32,
                                            accuracy_slo=5e-2)),
                        ("tight_interactive",
                         dict(weight=1, prompt_lens=(24, 48, 96),
                              max_new_tokens=16, accuracy_slo=1e-7,
                              deadline_slack_s=120.0)))))


def trace_config(ns, spec):
    C = ns["cluster"]
    kw = dict(spec)
    if "classes" in kw:
        kw["classes"] = tuple(C.RequestClass(n, **c)
                              for n, c in kw["classes"])
    return C.TraceConfig(**kw)


def arrival_rows(trace):
    return [(a.at_s, a.cls, a.request.uid, a.request.prompt.dtype.name,
             [int(t) for t in a.request.prompt], a.request.max_new_tokens,
             a.request.precision, a.request.accuracy_slo,
             a.request.deadline_s) for a in trace]


def sc_generate(ns):
    C = ns["cluster"]
    out = {}
    for name, spec in TRACES.items():
        cfg = trace_config(ns, spec)
        out[name] = arrival_rows(C.generate(cfg, 32000 if name == "smoke"
                                            else 100))
    out["start_uid"] = arrival_rows(C.generate(
        trace_config(ns, TRACES["two_class"]), 50, start_uid=1000))
    out["invalid"] = [error(lambda kw=kw: C.TraceConfig(**kw)) for kw in (
        dict(diurnal_amplitude=1.5), dict(diurnal_amplitude=-0.1),
        dict(burst_multiplier=0.5), dict(classes=()))]
    return out


def sc_latency_stats(ns):
    ls = ns["cluster"].latency_stats
    return dict(
        pair=ls({0: 2.0, 1: 4.0}, {0: 0.5, 1: 1.5}),
        no_ttft=ls({0: 2.0, 1: 4.0}),
        empty=ls({}), empty_ttft=ls({}, {}),
        non_finite=ls({1: 1.0, 2: float("nan"), 3: float("inf"), 4: 3.0},
                      {1: 0.5, 2: float("nan")}),
        spread=ls({i: 0.1 * i * i for i in range(37)},
                  {i: 0.01 * i for i in range(37)}))


def sc_accuracy(ns):
    rt, clock = router(ns, eco_gold(ns))
    loose = requests(ns, n=3, accuracy_slo=5e-2)
    tight = requests(ns, n=3, seed=6, accuracy_slo=1e-7)
    for r in tight:
        r.uid += 100
    targets = [rt.submit(r) for r in loose + tight]
    drive(rt, clock)
    done = rt.drain_finished()
    return dict(targets=targets, done=sorted(r.uid for r in done),
                reqs=[row(r) for r in loose + tight], **reports(rt))


def sc_deadline(ns):
    chip, C = ns["chip"], ns["cluster"]
    spec = chip.ChipSpec("tiered", (
        make_unit(ns, "decode_lat", "fp32", 1e-8, 4.0, phases=("decode",)),
        make_unit(ns, "decode_bulk", "fp32", 1e-8, 1.0, phases=("bulk",))))
    rt, clock = router(ns, C.ClusterSpec("solo", (spec,)),
                       deadline_routing=True, accuracy_fleets=())
    interactive = requests(ns, n=2, deadline_s=1e9)
    bulk = requests(ns, n=2, seed=6)
    for r in bulk:
        r.uid += 100
    targets = [rt.submit(r) for r in interactive + bulk]
    drive(rt, clock)
    rt.drain_finished()
    return dict(targets=targets, reqs=[row(r) for r in interactive + bulk],
                **reports(rt))


def sc_least_loaded(ns):
    chip, C = ns["chip"], ns["cluster"]
    twins = C.ClusterSpec("twins", (
        chip.ChipSpec("a", (make_unit(ns, "decode_eco", "fp8_e4m3", 1e-2,
                                      0.5),)),
        chip.ChipSpec("b", (make_unit(ns, "decode_eco", "fp8_e4m3", 1e-2,
                                      0.5),))))
    rt, clock = router(ns, twins, slots=2)
    reqs = requests(ns, n=5, accuracy_slo=5e-2)
    targets = []
    for r in reqs:
        targets.append(rt.submit(r))
    load_mid = rt.load_report()
    drive(rt, clock)
    rt.drain_finished()
    return dict(targets=targets, load_mid=load_mid,
                reqs=[row(r) for r in reqs], **reports(rt))


def sc_rejects(ns):
    E = ns["engine"]
    rt, _ = router(ns, eco_gold(ns))
    out = []
    for kw in (dict(precision="dp"), dict(accuracy_slo=1e-12),
               dict(precision="sp", accuracy_slo=1e-12),
               dict(max_new_tokens=0)):
        kw = dict(kw)
        n = kw.pop("max_new_tokens", 8)
        req = requests(ns, n=1, new_tokens=n, **kw)[0]
        try:
            rt.submit(req)
            out.append(None)
        except E.RequestRejected as e:
            out.append((e.code, e.reason, req.rejected, req.reject_reason))
    return dict(rejects=out, rejected=len(rt.rejected),
                cluster=rt.cluster_report())


def sc_die_kill(ns):
    rt, clock = router(ns, eco_gold(ns))
    reqs = requests(ns, n=6, accuracy_slo=5e-2)
    targets = {r.uid: rt.submit(r) for r in reqs}
    for _ in range(2):
        clock.t += TICK
        rt.step()
    mid = [row(r) for r in reqs]
    moved = rt.fail_chip("eco")
    after_kill = dict(migrations=rt.migrations, load=rt.load_report())
    drive(rt, clock)
    done = rt.drain_finished()
    return dict(targets=targets, mid=mid, moved=[r.uid for r in moved],
                after_kill=after_kill,
                done=sorted(r.uid for r in done if r.done),
                reqs=[row(r) for r in reqs], **reports(rt))


def sc_park(ns):
    rt, clock = router(ns, eco_gold(ns))
    rt.fail_chip("eco")
    rt.fail_chip("gold")
    reqs = requests(ns, n=3, accuracy_slo=5e-2)
    targets = [rt.submit(r) for r in reqs]
    parked, idle = len(rt._parked), rt.idle()
    clock.t += TICK
    stepped = rt.step()
    unknown = error(lambda: rt.fail_chip("nope"))
    rt.restore_chip("gold")
    drive(rt, clock)
    done = rt.drain_finished()
    return dict(targets=targets, parked=parked, idle=idle, stepped=stepped,
                unknown=unknown, done=sorted(r.uid for r in done if r.done),
                parked_after=len(rt._parked), reqs=[row(r) for r in reqs],
                **reports(rt))


def sc_one_die(ns):
    chip, C, E = ns["chip"], ns["cluster"], ns["engine"]
    spec = chip.ChipSpec("solo", (
        make_unit(ns, "decode_eco", "fp8_e4m3", 1e-2, 0.5),
        make_unit(ns, "decode_gold", "fp32", 1e-8, 4.0)))
    rt, rclock = router(ns, C.ClusterSpec("one", (spec,)))
    sclock = C.SimClock()
    solo = E.BatchedServer(ns["model"], ns["params"], slots=4,
                           max_len=MAX_LEN,
                           chip_policy=chip.ChipPolicy(spec, **ns["dev"]),
                           accuracy_fleets=(5e-2, 1e-7), dispatch_tokens=3,
                           clock=sclock)
    via_router = requests(ns, n=4, accuracy_slo=5e-2)
    via_solo = requests(ns, n=4, accuracy_slo=5e-2)
    targets = []
    for rr, rs in zip(via_router, via_solo):
        targets.append(rt.submit(rr))
        solo.submit(rs)
    drive(rt, rclock)
    drive(solo, sclock)
    rt.drain_finished()
    return dict(targets=targets, router=[row(r) for r in via_router],
                solo=[row(r) for r in via_solo],
                solo_energy=solo.energy_report(), **reports(rt))


def sc_replay(ns, cost=None):
    C = ns["cluster"]
    rt, clock = router(ns, eco_gold(ns))
    trace = C.generate(C.TraceConfig(
        horizon_s=4.0, base_rate_rps=1.5, seed=9,
        classes=(C.RequestClass("loose", weight=3, max_new_tokens=6,
                                accuracy_slo=5e-2),
                 C.RequestClass("tight", max_new_tokens=6,
                                accuracy_slo=1e-7))), 256)
    rep = C.replay(rt, trace, clock, tick_s=TICK, dispatch_tokens=3,
                   cost=None if cost is None else C.StepCost(**cost))
    return dict(
        n=len(trace), finished=[r.uid for r in rep["finished"]],
        rejected=[r.uid for r in rep["rejected"]],
        expired=[r.uid for r in rep["expired"]],
        latency_s=rep["latency_s"], ttft_s=rep["ttft_s"],
        classes=rep["classes"], span_s=rep["span_s"],
        submitted=rep["submitted"],
        stats=C.latency_stats(rep["latency_s"], rep["ttft_s"]),
        reqs=[row(a.request) for a in trace], **reports(rt))


def sc_replay_cost(ns):
    return sc_replay(ns, cost=dict(t_prefill_token_s=1e-3,
                                   t_decode_token_s=5e-3))


def sc_split_replay(ns):
    """The launcher's path: a replay up to a kill, the kill, then the rest
    of the trace with the first part's arrivals carried over."""
    C = ns["cluster"]
    rt, clock = router(ns, eco_gold(ns))
    trace = C.generate(C.TraceConfig(
        horizon_s=3.0, base_rate_rps=4.0, seed=5,
        classes=(C.RequestClass("loose", weight=3, max_new_tokens=30,
                                accuracy_slo=5e-2),
                 C.RequestClass("tight", max_new_tokens=6,
                                accuracy_slo=1e-7,
                                deadline_slack_s=60.0))), 256)
    pre = [a for a in trace if a.at_s < 1.0]
    post = [a for a in trace if a.at_s >= 1.0]
    rep = C.replay(rt, pre, clock, tick_s=TICK, dispatch_tokens=3,
                   max_steps=int(1.0 / TICK))
    moved = rt.fail_chip("eco")
    rep2 = C.replay(rt, post, clock, tick_s=TICK, dispatch_tokens=3,
                    carryover={a.request.uid: a.at_s for a in pre})
    return dict(moved=[r.uid for r in moved],
                first=[r.uid for r in rep["finished"]],
                second=[r.uid for r in rep2["finished"]],
                latency_s=[rep["latency_s"], rep2["latency_s"]],
                ttft_s=[rep["ttft_s"], rep2["ttft_s"]],
                span_s=[rep["span_s"], rep2["span_s"]],
                reqs=[row(a.request) for a in trace], **reports(rt))


def tune_rows(spec):
    """(die, [(unit, design, vdd, vbb, count, fmt)]) of a cluster or, for
    a ``ChipSpec``, of its one die."""
    chips = getattr(spec, "chips", (spec,))
    return [(d.name, [(u.name, u.design.name, u.vdd, u.vbb, u.count,
                       u.fmt.name if u.fmt is not None else None)
                      for u in d.units]) for d in chips]


def sc_tune(ns):
    chip, C, at = ns["chip"], ns["cluster"], ns["at"]
    cache = ns["SweepExecutableCache"]()
    P, dev = ns["P"], ns["dev"]
    phases = (chip.PhaseSpec("train", at.GEMM_STREAM, flops_fraction=0.7),
              chip.PhaseSpec("decode", at.DEPENDENT_CHAIN,
                             flops_fraction=0.3))
    golden = chip.tune_chip(phases, params=P, vdd_grid=VDD, vbb_grid=VBB,
                            cache=cache, **dev)
    rc = C.tune_cluster([C.ChipClass("solo", phases)], max_chips=1,
                        params=P, vdd_grid=VDD, vbb_grid=VBB, cache=cache,
                        **dev)
    out = dict(golden=tune_rows(golden.spec),
               degenerate=dict(counts=rc.counts, dies=tune_rows(rc.spec),
                               report=rc.report,
                               converged=rc.search.converged,
                               best=rc.search.best,
                               best_score=rc.search.best_score))
    classes = [C.ChipClass("bulk", (chip.PhaseSpec("train",
                                                   at.GEMM_STREAM),),
                           workload_share=3.0),
               C.ChipClass("interactive",
                           (chip.PhaseSpec("decode", at.DEPENDENT_CHAIN),),
                           workload_share=1.0)]
    for name, kw in (("open", dict(max_chips=4)),
                     ("budget", dict(max_chips=6, area_budget_mm2=0.6,
                                     tdp_budget_mw=2500.0))):
        try:
            rc = C.tune_cluster(classes, params=P, vdd_grid=VDD,
                                vbb_grid=VBB, cache=cache, **dev, **kw)
        except ValueError as e:
            out[name] = str(e)
            continue
        out[name] = dict(counts=rc.counts, dies=tune_rows(rc.spec),
                         report=rc.report, converged=rc.search.converged,
                         best=rc.search.best, best_score=rc.search.best_score,
                         trajectory=rc.search.trajectory,
                         as_dict=rc.as_dict())
    out["errors"] = [
        error(lambda: C.tune_cluster([], params=P, **dev)),
        error(lambda: C.tune_cluster([classes[0], classes[0]], params=P,
                                     **dev)),
        error(lambda: C.ChipClass("x", ())),
        error(lambda: C.ChipClass("x", phases, workload_share=0.0))]
    return out


def sc_chunked(ns):
    chip, C = ns["chip"], ns["cluster"]
    die = chip.ChipSpec("d", (make_unit(ns, "decode", "fp32", 1e-8, 1.0),))
    cl = C.homogeneous(die, 2)
    out = {}
    for mode, kw in (("mono", {}), ("chunked", dict(prefill_chunk=4))):
        rt, clock = router(ns, cl, slots=2, accuracy_fleets=(), **kw)
        reqs = requests(ns, lens=[7, 13, 5, 9], new_tokens=5)
        targets = [rt.submit(r) for r in reqs]
        drive(rt, clock, max_steps=200, tick=0.01)
        out[mode] = dict(idle=rt.idle(), targets=targets,
                         done=sorted(r.uid for r in rt.drain_finished()),
                         reqs=[row(r) for r in reqs], **reports(rt))
    return out


def span_rows(tr):
    return [dict(span_id=s.span_id, uid=s.uid, parent_id=s.parent_id,
                 name=s.name, site=s.site, fleet=s.fleet,
                 start_s=s.start_s, end_s=s.end_s, status=s.status,
                 energy_j=s.energy_j, unit_energy_j=dict(s.unit_energy_j),
                 prefill_tokens=s.prefill_tokens,
                 decode_tokens=s.decode_tokens,
                 events=[tuple(e) for e in s.events], attrs=dict(s.attrs))
            for s in tr.spans]


def sc_traced_kill(ns):
    C, Ev = ns["cluster"], ns["Event"]
    rt, clock = router(ns, eco_gold(ns), prefill_chunk=8)
    tracer = C.trace_cluster(rt)
    reqs = requests(ns, n=5, new_tokens=6, accuracy_slo=5e-2,
                    lens=[20 + 4 * i for i in range(5)])
    targets = {r.uid: rt.submit(r) for r in reqs}
    clock.t += TICK
    rt.step()
    mid_prefill = [not r.done and not r.output for r in reqs]
    moved = rt.fail_chip("eco")
    drive(rt, clock)
    done = rt.drain_finished()
    roots = tracer.roots()
    return dict(
        targets=targets, mid_prefill=mid_prefill,
        moved=[r.uid for r in moved],
        done=sorted(r.uid for r in done if r.done),
        reqs=[row(r) for r in reqs], spans=span_rows(tracer),
        system=[tuple(e) for e in tracer.system_events],
        metrics=dict(tracer.metrics),
        integrity=tracer.check_integrity(),
        roots={u: s.span_id for u, s in roots.items()},
        attempts={r.uid: [(a.span_id, a.parent_id, a.site)
                          for a in tracer.attempts_for(r.uid)]
                  for r in reqs},
        migrate={r.uid: [e[1] for e in tracer.events_for(r.uid)
                         if e[0] == Ev.MIGRATE] for r in reqs},
        span_energy=tracer.total_energy_j(), **reports(rt))


SCENARIOS = dict(spec=sc_spec, generate=sc_generate,
                 latency_stats=sc_latency_stats, accuracy=sc_accuracy,
                 deadline=sc_deadline, least_loaded=sc_least_loaded,
                 rejects=sc_rejects, die_kill=sc_die_kill, park=sc_park,
                 one_die=sc_one_die, replay=sc_replay,
                 replay_cost=sc_replay_cost, split_replay=sc_split_replay,
                 tune=sc_tune, chunked=sc_chunked,
                 traced_kill=sc_traced_kill)
'''

_REF = r"""
import dataclasses, pickle, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64  # the name jax 0.9.0 dropped
import numpy as np
from repro import cluster
from repro.configs.base import get_config
from repro.core import autotune as at
from repro.core import chip
from repro.core.energy_model import SweepExecutableCache, calibrate
from repro.core.fpu_arch import FABRICATED
from repro.models import LM
from repro.numerics import get_format
from repro.serve import engine
from repro.telemetry import Event

exec(sys.argv[1])
cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                          dtype="float32")
model = LM(cfg)
params = model.init(jax.random.PRNGKey(3))
P = calibrate()
ns = dict(cluster=cluster, chip=chip, engine=engine, at=at,
          get_format=get_format, FABRICATED=FABRICATED, Event=Event,
          SweepExecutableCache=SweepExecutableCache, P=P, model=model,
          params=params, dev={})
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
    path = tmp_path_factory.mktemp("cluster_ref") / "ref.pkl"
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
    return dict(cluster=tcluster, chip=chip, engine=engine, at=at,
                get_format=get_format, FABRICATED=FABRICATED, Event=Event,
                SweepExecutableCache=em.SweepExecutableCache,
                P=em.TechParams(ref["P"]), model=LM(cfg, device=CPU),
                params=params_from_jax(ref["weights"], cfg, device=CPU),
                dev=dict(device=CPU))


@pytest.fixture(scope="module")
def port(ns):
    """Each scenario's port results, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = SCENARIOS[name](ns)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def greedy(ns):
    """The port's single-sequence streams, cached per (prompt, length)."""
    cache = {}

    def get(prompt, n):
        key = (tuple(int(t) for t in prompt), n)
        if key not in cache:
            cache[key] = engine.greedy_decode(ns["model"], ns["params"],
                                              np.asarray(prompt), n,
                                              max_len=MAX_LEN)
        return cache[key]

    return get


def _tol(path):
    """The tolerance of a float at ``path``: tune reports rtol 1e-12,
    energies rel 1e-9, everything else exact."""
    if path.startswith("tune"):
        return RTOL_TUNE
    if any(k in path for k in ("energy", "units", "_j")):
        return REL
    return 0.0


def _match(got, want, path=""):
    """Equal structure and values; floats within ``_tol(path)``."""
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
    elif dataclasses.is_dataclass(want):
        _match(dataclasses.asdict(got), dataclasses.asdict(want), path)
    elif isinstance(want, (float, np.floating)) and not isinstance(
            want, bool):
        g, w, tol = float(got), float(want), _tol(path)
        if math.isnan(w):
            assert math.isnan(g), path
        elif tol and w != 0 and math.isfinite(w):
            assert abs(g / w - 1) <= tol, (path, g, w)
        else:
            assert g == w, (path, g, w)
    elif isinstance(want, (np.integer, int)) and not isinstance(want, bool):
        assert int(got) == int(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def _same(port, ref, name):
    got = port(name)
    _match(got, ref[name], name)
    return got


def _held_to_greedy(rows, greedy):
    """No request lost, and each stream bitwise the port's greedy_decode."""
    for r in rows:
        assert r["done"] and not r["expired"] and not r["rejected"], r["uid"]
        assert r["output"] == greedy(r["prompt"], len(r["output"])), r["uid"]


# ---------------------------------------------------------------- spec, load
def test_cluster_spec_matches_jax(port, ref):
    got = _same(port, ref, "spec")
    assert "at least one" in got["empty"][1]
    assert "duplicate" in got["dup"][1]
    assert "area" in got["tight"][1] and "TDP" in got["hot"][1]
    assert [c["name"] for c in got["homogeneous"]["chips"]] == \
        [f"d0/die{i}" for i in range(3)]
    assert got["die2_units_equal"] and got["unknown_die"][0] == "KeyError"


@pytest.mark.parametrize("trace", ["two_class", "default", "smoke",
                                   "start_uid"])
def test_generate_is_bitwise_jax(port, ref, trace):
    """The same ``TraceConfig`` gives the same arrivals: times, classes,
    uids, prompts (and their dtype), budgets and deadlines."""
    got = port("generate")[trace]
    _match(got, ref["generate"][trace], trace)
    assert got, trace
    times = [a[0] for a in got]
    assert times == sorted(times)
    if trace == "two_class":
        for at_s, cls, *_, deadline in got:
            assert (deadline == at_s + 1.5) if cls == "b" else \
                deadline is None


def test_trace_config_validation_matches_jax(port, ref):
    got = port("generate")["invalid"]
    _match(got, ref["generate"]["invalid"], "invalid")
    assert all(g is not None and g[0] == "ValueError" for g in got)


def test_latency_stats_match_jax(port, ref):
    got = _same(port, ref, "latency_stats")
    assert got["empty"] == dict(n=0, p50_s=0.0, p99_s=0.0, mean_s=0.0,
                                max_s=0.0)
    assert got["non_finite"]["n"] == 2 and got["non_finite"]["n_ttft"] == 1
    assert "p99_ttft_s" not in got["no_ttft"]


# ------------------------------------------------------------------ routing
def test_accuracy_routing_matches_jax(port, ref, greedy):
    """Tight-SLO traffic lands only on gold; loose-SLO traffic spreads
    least-loaded over both dies and eco serves some of it."""
    got = _same(port, ref, "accuracy")
    assert got["targets"][0] == "eco" and got["targets"][3:] == ["gold"] * 3
    routed = [r["routed"] for r in got["reqs"]]
    assert "decode_eco" in routed[:3] and routed[3:] == ["decode_gold"] * 3
    _held_to_greedy(got["reqs"], greedy)


def test_deadline_routing_matches_jax(port, ref, greedy):
    got = _same(port, ref, "deadline")
    assert [r["routed"] for r in got["reqs"]] == \
        ["decode_lat"] * 2 + ["decode_bulk"] * 2
    _held_to_greedy(got["reqs"], greedy)


def test_least_loaded_alternates_matches_jax(port, ref, greedy):
    got = _same(port, ref, "least_loaded")
    assert got["targets"][:4] == ["a", "b", "a", "b"]
    _held_to_greedy(got["reqs"], greedy)


def test_structured_rejects_match_jax(port, ref):
    got = _same(port, ref, "rejects")
    codes = [r[0] if r else None for r in got["rejects"]]
    assert codes == ["unknown_precision", "accuracy_slo_unmeetable",
                     "accuracy_slo_unmeetable", "bad_max_tokens"]
    assert "eco+gold" in got["rejects"][0][1]
    assert "1e-08" in got["rejects"][1][1]


def test_non_unit_fault_propagates_from_route(ns):
    """A die whose ``admission_unit`` raises ``UnitFault`` is not native and
    the request degrades onto another die; any other error (the card, a
    kernel, its build) propagates out of ``route()`` and ``submit()``."""
    rt, _ = router(ns, eco_gold(ns))
    req = requests(ns, n=1, accuracy_slo=5e-2)[0]
    assert rt.route(req) == "eco"
    pol = rt.policies["eco"]

    def unit_fault(**kw):
        raise UnitFault("no unit in service")

    pol.admission_unit = unit_fault
    assert rt.route(req) == "gold"

    def device_error(**kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    pol.admission_unit = device_error
    with pytest.raises(RuntimeError, match="illegal memory access"):
        rt.route(req)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        rt.submit(req)
    assert all(srv.idle() for srv in rt.servers.values())


def test_router_policies_live_on_the_model_device(ns):
    rt, _ = router(ns, eco_gold(ns))
    assert all(p._device == ns["model"].device
               for p in rt.policies.values())
    assert rt.servers["eco"].trace_site == "eco"


# --------------------------------------------------------- failure, parking
def test_die_kill_migrates_with_zero_loss_matches_jax(port, ref, greedy):
    got = _same(port, ref, "die_kill")
    on_eco = sorted(u for u, t in got["targets"].items() if t == "eco")
    assert on_eco and sorted(got["moved"]) == on_eco
    assert got["after_kill"]["migrations"] == len(got["moved"])
    assert got["done"] == [r["uid"] for r in got["reqs"]]
    for r in got["reqs"]:
        if r["uid"] in on_eco:
            assert r["routed"] == "decode_gold" and r["requeues"] >= 1
    _held_to_greedy(got["reqs"], greedy)


def test_all_dies_failed_park_then_restore_matches_jax(port, ref, greedy):
    got = _same(port, ref, "park")
    assert got["targets"] == [""] * 3 and got["parked"] == 3
    assert got["idle"] is False and got["stepped"] == 0
    assert got["done"] == [0, 1, 2] and got["parked_after"] == 0
    assert got["unknown"][0] == "KeyError"
    _held_to_greedy(got["reqs"], greedy)


def test_one_die_cluster_matches_batched_server_and_jax(port, ref, greedy):
    got = _same(port, ref, "one_die")
    assert got["targets"] == ["solo"] * 4
    for rr, rs in zip(got["router"], got["solo"]):
        assert rr["output"] == rs["output"] and rr["routed"] == rs["routed"]
    _held_to_greedy(got["router"], greedy)


# ------------------------------------------------------------------- replay
@pytest.mark.parametrize("name", ["replay", "replay_cost", "split_replay"])
def test_trace_replay_matches_jax(port, ref, greedy, name):
    """Open-loop replay through the router: the same finished set, the
    same simulated latencies and TTFTs, energies at rel 1e-9; with
    ``StepCost`` the clock also advances by each step's token work."""
    got = _same(port, ref, name)
    _held_to_greedy(got["reqs"], greedy)
    if name == "split_replay":
        assert got["moved"]
        return
    assert len(got["finished"]) == got["n"] and not got["rejected"]
    st = got["stats"]
    assert st["n"] == got["n"] and 0.0 < st["p50_s"] <= st["p99_s"]
    if name == "replay_cost":
        plain = port("replay")
        assert got["span_s"] > plain["span_s"]


# ------------------------------------------------------------- tune_cluster
@pytest.mark.parametrize("case", ["degenerate", "open", "budget",
                                  "errors", "golden"])
def test_tune_cluster_matches_jax(port, ref, case):
    """The degenerate case reproduces ``tune_chip`` unit for unit; the
    two-class cases cover every class, the heavier with at least as many
    replicas.  Picks and counts identical, reports within rtol 1e-12."""
    got = port("tune")
    _match(got[case], ref["tune"][case], f"tune/{case}")
    if case == "degenerate":
        (name, units), = got[case]["dies"]
        assert name == "solo/die0" and got[case]["counts"] == {"solo": 1}
        assert [u[1:] for u in units] == \
            [u[1:] for u in got["golden"][0][1]]
    elif case in ("open", "budget"):
        rc = got[case]
        assert isinstance(rc, dict), rc
        assert rc["report"]["classes_covered"] == 2 and rc["converged"]
        assert rc["counts"]["bulk"] >= rc["counts"]["interactive"] >= 1


# --------------------------------------------------- chunked and traced kill
def test_router_inherits_chunked_prefill_matches_jax(port, ref, greedy):
    got = _same(port, ref, "chunked")
    mono, chunked = got["mono"], got["chunked"]
    assert mono["idle"] and chunked["idle"]
    assert [r["output"] for r in mono["reqs"]] == \
        [r["output"] for r in chunked["reqs"]]
    _held_to_greedy(mono["reqs"], greedy)


def test_traced_die_kill_mid_prefill_matches_jax(port, ref, greedy):
    """Span trees, events, metric timelines and system events field for
    field: one root a request, attempts chained across dies, the kill and
    the migrations recorded."""
    got = _same(port, ref, "traced_kill")
    assert any(got["mid_prefill"]) and got["integrity"] == []
    assert sorted(got["roots"]) == [r["uid"] for r in got["reqs"]]
    for uid in got["moved"]:
        attempts = got["attempts"][uid]
        assert len(attempts) >= 2
        assert {"eco", "gold"} <= {a[2] for a in attempts}
        assert attempts[0][1] == got["roots"][uid]
        assert all(n[1] == p[0] for p, n in zip(attempts, attempts[1:]))
        assert got["migrate"][uid]
    assert any(e[0] == Event.FAULT and e[3].get("kind") == "die_kill"
               for e in got["system"])
    _held_to_greedy(got["reqs"], greedy)
