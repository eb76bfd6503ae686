"""The port's ``BatchedServer(chip_policy=...)`` against the JAX package's:
fleet routing by precision, deadline class, accuracy class and health,
per-request and chip-level energy, fleet reports and reject codes, and
``flops_per_token=`` on both servers.

A reduced tinyllama in float32 runs on weights exported from the JAX
model (``models/convert.params_from_jax``).  The JAX package's chip module
imports ``jax.experimental.enable_x64``, a name jax 0.9.0 dropped, so the
JAX engine runs in one subprocess that restores it before importing, and
pickles its results and the exported weights back; the alias never enters
this process (see tests/test_torch_dse.py).  Both sides run the same calls
(``_DRIVE``, executed against each package) on the reference's fitted
parameters.  Tolerances:

  * identical: routed units, tokens, fleet plans and reports, reject codes,
    fault outcomes;
  * rel 1e-9: ``energy_j``, ``unit_energy_j``, ``energy_report`` and
    ``run_report``'s energy (the JAX package's own bound between its bulk
    and per-token charging, tests/test_serve_fused.py); per-request energy
    also against JAX's per-token ``ReferenceServer`` and against the sum
    prefill tokens x flops/token on the prefill unit + decoded tokens x
    flops/token on the routed unit.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import faults
from repro_torch.configs.base import get_config
from repro_torch.core import chip
from repro_torch.core import energy_model as em
from repro_torch.models import LM
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CPU = "cpu"
REL = 1e-9

#: the same calls against either package: ``ns`` holds its ``engine``,
#: ``chip``, ``UnitFault``, the model and weights and the prompt dtype.
_DRIVE = r'''
import numpy as np

# (prompt length, new tokens, precision, deadline, accuracy_slo)
TRAFFIC = [(5, 4, "sp", None, None), (9, 6, "dp", 1e9, None),
           (3, 1, None, None, 1e-2), (12, 5, "sp", 1e9, 1e-2),
           (7, 3, "dp", None, None), (17, 6, None, 1e9, None),
           (4, 2, "sp", None, 3e-8), (10, 5, "dp", 1e9, 1e-2),
           (6, 4, None, None, None), (8, 3, "sp", 1e9, None)]
# the servers' flops_per_token= (None: 2 x active params; 0: nothing)
FLOPS_PER_TOKEN = (None, 0, 1e9)
BAD = [(4, 2, "fp16", None, None, "unknown_precision"),
       (4, 2, None, None, 0.0, "bad_accuracy_slo"),
       (4, 2, "sp", None, 1e-30, "accuracy_slo_unmeetable")]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def prompts(vocab, lens, dtype, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(dtype) for n in lens]


def req_row(r):
    return dict(uid=r.uid, output=list(r.output), routed=r.routed_unit,
                energy=r.energy_j, units=dict(r.unit_energy_j),
                done=r.done, expired=r.expired, rejected=r.rejected,
                reason=r.reject_reason.split("]")[0] + "]")


def drive(ns, chunk):
    eng, chip, params, model = ns["engine"], ns["chip"], ns["P"], ns["model"]
    out = {}
    pol = chip.ChipPolicy(chip.fabricated_chip(None, params), params)
    server = eng.BatchedServer(
        model, ns["params"], slots=6, max_len=32, chip_policy=pol,
        deadline_routing=True, accuracy_fleets=(1e-2,), dispatch_tokens=3,
        clock=FakeClock(1.0), prefill_chunk=chunk)
    out["fleets"] = dict(server._fleets)
    out["flops_per_token"] = server.flops_per_token
    ps = prompts(256, [t[0] for t in TRAFFIC], ns["dtype"])
    reqs = [eng.Request(uid=i, prompt=p, max_new_tokens=n, deadline_s=dl,
                        precision=prec, accuracy_slo=slo)
            for i, (p, (_, n, prec, dl, slo)) in enumerate(zip(ps,
                                                               TRAFFIC))]
    for r in reqs:
        server.submit(r)
    out["fleet_report_queued"] = server.fleet_report()
    bad = prompts(256, [b[0] for b in BAD], ns["dtype"], seed=12)
    codes = []
    for i, (p, (_, n, prec, dl, slo, _code)) in enumerate(zip(bad, BAD)):
        r = eng.Request(uid=100 + i, prompt=p, max_new_tokens=n,
                        deadline_s=dl, precision=prec, accuracy_slo=slo)
        try:
            server.submit(r)
            codes.append(None)
        except eng.RequestRejected as e:
            codes.append((e.code, r.rejected, r.reject_reason.split("]")[0]))
    out["rejects"] = codes
    finished = server.run(max_steps=200)
    out["finished"] = sorted(r.uid for r in finished)
    out["reqs"] = [req_row(r) for r in reqs]
    out["energy_report"] = server.energy_report()
    rr = server.run_report()
    out["run_report"] = {k: rr[k] for k in ("tokens_decoded",
                                            "prefill_tokens", "energy_j")}
    out["fleet_report"] = server.fleet_report()
    # health: a dead unit's fleet stops taking admissions (degrade, don't
    # drop); an engine-side outage routes around its fleet too
    pol.set_health("sp_cma", "dead", reason="test")
    server.set_fleet_in_service("dp_fma", False)
    more = prompts(256, [5, 6, 7, 8], ns["dtype"], seed=13)
    reqs2 = [eng.Request(uid=200 + i, prompt=p, max_new_tokens=3,
                         deadline_s=1e9 if i % 2 else None,
                         precision="sp" if i < 2 else "dp")
             for i, p in enumerate(more)]
    for r in reqs2:
        server.submit(r)
    out["fleet_report_degraded"] = server.fleet_report()
    server.run(max_steps=100)
    out["reqs2"] = [req_row(r) for r in reqs2]
    for name in server._fleets:
        server.set_fleet_in_service(name, False)
    try:
        server.submit(eng.Request(uid=300, prompt=more[0], max_new_tokens=2))
        out["no_fleet"] = None
    except ns["UnitFault"]:
        out["no_fleet"] = "UnitFault"
    out["energy_report_end"] = server.energy_report()
    return out


def drive_sp(ns, server_cls, **kw):
    """An sp die, no deadline routing: the bulk engine against the
    per-token reference (``kw``: more constructor arguments)."""
    eng, chip, params = ns["engine"], ns["chip"], ns["P"]
    pol = chip.ChipPolicy(chip.fabricated_chip("sp", params), params)
    server = server_cls(ns["model"], ns["params"], slots=2, max_len=32,
                        chip_policy=pol, **kw)
    ps = prompts(256, (4, 9, 6, 12), ns["dtype"], seed=14)
    reqs = [eng.Request(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(ps)]
    for r in reqs:
        server.submit(r)
    server.run(max_steps=100)
    return dict(reqs=[req_row(r) for r in reqs],
                energy_report=server.energy_report(),
                flops_per_token=server.flops_per_token)


def drive_drain(ns):
    """An sp die: force-drain the busy fleet (energy frozen), drain the
    other with every fleet out of service (the requests park), hand the
    parked requests over with ``take_parked`` and resume them on a fresh
    server; ``load_report`` along the way."""
    eng, chip, params = ns["engine"], ns["chip"], ns["P"]
    pol = chip.ChipPolicy(chip.fabricated_chip("sp", params), params)

    def server():
        return eng.BatchedServer(ns["model"], ns["params"], slots=4,
                                 max_len=48, chip_policy=pol,
                                 deadline_routing=True, clock=FakeClock(1.0))

    def fresh(uids):  # bulk, then two deadline-bound (the other fleet)
        return [eng.Request(uid=i, prompt=ps[i], max_new_tokens=new[i],
                            deadline_s=1e9 if i >= 3 else None)
                for i in uids]

    ps = prompts(256, (4, 6, 5, 7, 9), ns["dtype"], seed=15)
    new = (30, 30, 4, 12, 10)
    reqs = fresh(range(5))
    first = server()
    out = dict(fleets=dict(first._fleets))
    for r in reqs[:3]:
        first.submit(r)
    first.step()
    first.step()
    out["load_before"] = first.load_report()
    before = [req_row(r) for r in reqs[:3]]
    fleet = reqs[0].routed_unit
    affected = first.drain_fleet(fleet, requeue=False)
    out["force"] = dict(fleet=fleet, affected=sorted(r.uid for r in affected),
                        before=before, after=[req_row(r) for r in reqs[:3]],
                        next_step=first.step(),
                        energy=first.energy_report())
    for r in reqs[3:]:
        first.submit(r)
    first.step()
    first.step()
    out["routed_around"] = [r.routed_unit for r in reqs[3:]]
    for name in first._fleets:
        if name != fleet:
            first.drain_fleet(name, requeue=True)
    out["parked_load"] = first.load_report()
    parked = first.take_parked()
    out["parked"] = [(r.uid, list(r.output), r.requeues) for r in parked]
    out["after_take"] = first.load_report()
    second = server()
    out["resumed_fleets"] = [second.requeue(r) for r in parked]
    second.run(max_steps=100)
    out["resumed"] = [req_row(r) for r in reqs[3:]]
    out["energy_second"] = second.energy_report()
    third = server()
    whole = fresh(range(3, 5))
    for r in whole:
        third.submit(r)
    third.run(max_steps=100)
    out["uninterrupted"] = [list(r.output) for r in whole]
    return out
'''

_REF = r"""
import dataclasses, pickle, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64  # the name jax 0.9.0 dropped
import numpy as np
from repro import faults
from repro.configs.base import get_config
from repro.core import chip
from repro.core.energy_model import calibrate
from repro.models import LM
from repro.serve import engine

exec(sys.argv[1])
cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                          dtype="float32")
model = LM(cfg)
params = model.init(jax.random.PRNGKey(3))
P = calibrate()
ns = dict(engine=engine, chip=chip, UnitFault=faults.UnitFault, P=P,
          model=model, params=params, dtype=np.int32)
out = dict(P=P.values, weights=jax.tree.map(np.asarray, params))
for chunk in (None, 4):
    out["drive", chunk] = drive(ns, chunk)
out["sp_bulk"] = drive_sp(ns, engine.BatchedServer)
out["sp_ref"] = drive_sp(ns, engine.ReferenceServer)
for fpt in FLOPS_PER_TOKEN:
    for cls in (engine.BatchedServer, engine.ReferenceServer):
        out["fpt", cls.__name__, fpt] = drive_sp(ns, cls,
                                                 flops_per_token=fpt)
out["drain"] = drive_drain(ns)
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
"""

exec(_DRIVE)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX engine's results and weights, from a subprocess (see
    above)."""
    path = tmp_path_factory.mktemp("serve_chip_ref") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _REF, _DRIVE, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def ns(ref):
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    model = LM(cfg, device=CPU)
    return dict(engine=engine, chip=chip, UnitFault=faults.UnitFault,
                P=em.TechParams(ref["P"]), model=model,
                params=params_from_jax(ref["weights"], cfg, device=CPU),
                dtype=np.int64)


def _energy_close(got, want):
    assert got == pytest.approx(want, rel=REL, abs=0.0)


def _same_reqs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("uid", "output", "routed", "done", "expired", "rejected",
                  "reason"):
            assert g[k] == w[k], (g["uid"], k, g[k], w[k])
        _energy_close(g["energy"], w["energy"])
        assert sorted(g["units"]) == sorted(w["units"]), g["uid"]
        for unit, e in w["units"].items():
            _energy_close(g["units"][unit], e)


def _same_report(got, want):
    assert got["chip"] == want["chip"]
    assert got["tokens_decoded"] == want["tokens_decoded"]
    _energy_close(got["total_j"], want["total_j"])
    _energy_close(got["j_per_token"], want["j_per_token"])
    assert sorted(got["per_unit_j"]) == sorted(want["per_unit_j"])
    for unit, e in want["per_unit_j"].items():
        _energy_close(got["per_unit_j"][unit], e)


@pytest.mark.parametrize("chunk", [None, 4], ids=["monolithic", "chunked"])
def test_chip_routed_serving_matches_jax(ref, ns, chunk):
    got, want = drive(ns, chunk), ref["drive", chunk]
    assert got["fleets"] == want["fleets"]
    assert sorted(want["fleets"]) == ["dp_cma", "dp_fma", "sp_cma",
                                      "sp_fma"]
    assert got["flops_per_token"] == want["flops_per_token"]
    assert got["rejects"] == want["rejects"]
    assert [c[0] for c in got["rejects"]] == [b[-1] for b in BAD]
    assert got["finished"] == want["finished"]
    _same_reqs(got["reqs"], want["reqs"])
    _same_reqs(got["reqs2"], want["reqs2"])
    for key in ("fleet_report_queued", "fleet_report",
                "fleet_report_degraded"):
        assert got[key] == want[key], key
    for key in ("energy_report", "energy_report_end"):
        _same_report(got[key], want[key])
    assert got["run_report"]["tokens_decoded"] == \
        want["run_report"]["tokens_decoded"]
    assert got["run_report"]["prefill_tokens"] == \
        want["run_report"]["prefill_tokens"]
    _energy_close(got["run_report"]["energy_j"],
                  want["run_report"]["energy_j"])
    assert got["no_fleet"] == want["no_fleet"] == "UnitFault"


@pytest.mark.parametrize("chunk", [None, 4], ids=["monolithic", "chunked"])
def test_energy_is_the_per_token_sum(ref, ns, chunk):
    """Each request's energy: prompt tokens x flops/token on the prefill
    unit plus decoded tokens (all but the first) on its routed unit, at the
    unit's pJ/FLOP; the chip totals are the sum over requests."""
    got = drive(ns, chunk)
    pol = chip.ChipPolicy(chip.fabricated_chip(None, ns["P"]), ns["P"])
    fpt = got["flops_per_token"]
    lens = dict(enumerate(t[0] for t in TRAFFIC))
    total = {}
    for row, (n_prompt, _, prec, _, _) in zip(got["reqs"], TRAFFIC):
        pre = pol.unit_for_phase("prefill", precision=prec or "sp")
        dec = pol.spec.unit(row["routed"])
        want = {pre.name: n_prompt * fpt * pre.e_per_flop_pj * 1e-12}
        want[dec.name] = want.get(dec.name, 0.0) + \
            (len(row["output"]) - 1) * fpt * dec.e_per_flop_pj * 1e-12
        want = {k: v for k, v in want.items() if v}
        _energy_close(row["energy"], sum(want.values()))
        assert sorted(row["units"]) == sorted(want)
        for unit, e in want.items():
            _energy_close(row["units"][unit], e)
            total[unit] = total.get(unit, 0.0) + row["units"][unit]
    assert lens
    rep = got["energy_report"]
    for unit, e in total.items():
        _energy_close(rep["per_unit_j"][unit], e)
    _energy_close(rep["total_j"], sum(total.values()))


def test_bulk_energy_matches_jax_per_token_reference(ref, ns):
    """The port's dispatch-boundary charging against JAX's per-token
    ``ReferenceServer`` (and JAX's own ``BatchedServer``) on an sp die, and
    the port's ``ReferenceServer`` against JAX's."""
    got = drive_sp(ns, engine.BatchedServer)
    for want in (ref["sp_ref"], ref["sp_bulk"]):
        _same_reqs(got["reqs"], want["reqs"])
        _same_report(got["energy_report"], want["energy_report"])
    # and the port's own per-token engine against JAX's
    got = drive_sp(ns, engine.ReferenceServer)
    _same_reqs(got["reqs"], ref["sp_ref"]["reqs"])
    _same_report(got["energy_report"], ref["sp_ref"]["energy_report"])


def test_no_policy_engine_charges_nothing(ns):
    server = engine.BatchedServer(ns["model"], ns["params"], slots=2,
                                  max_len=32)
    r = engine.Request(uid=0, prompt=np.arange(5), max_new_tokens=3,
                       precision="sp", accuracy_slo=1e-2)
    server.submit(r)
    server.run()
    assert r.routed_unit == "" and r.energy_j == 0.0 and not r.unit_energy_j
    assert server.energy_report()["total_j"] == 0.0
    assert list(server.fleet_report()) == ["(default)"]


def test_drain_park_and_take_parked_match_jax(ref, ns):
    """``drain_fleet(requeue=False)`` finishes the fleet's requests as
    expired with their tokens and per-unit energy frozen; draining the
    last fleet in service parks its requests; ``take_parked`` hands them
    over and ``requeue`` on a fresh server resumes them as an uninterrupted
    run would have gone on.  Tokens, load reports and states equal to the
    JAX engine's, energies at rel 1e-9."""
    got, want = drive_drain(ns), ref["drain"]
    for key in ("fleets", "load_before", "routed_around", "parked_load",
                "parked", "after_take", "resumed_fleets", "uninterrupted"):
        assert got[key] == want[key], key
    gf, wf = got["force"], want["force"]
    assert (gf["fleet"], gf["affected"], gf["next_step"]) == \
        (wf["fleet"], wf["affected"], wf["next_step"])
    for key in ("before", "after"):
        _same_reqs(gf[key], wf[key])
    _same_report(gf["energy"], wf["energy"])
    _same_reqs(got["resumed"], want["resumed"])
    _same_report(got["energy_second"], want["energy_second"])
    # the port's own invariants
    assert gf["affected"] == [0, 1, 2] and gf["next_step"] == 0
    for b, a in zip(gf["before"], gf["after"]):
        assert a["output"] == b["output"] and a["energy"] == b["energy"]
        assert a["units"] == b["units"] and a["done"] and a["expired"]
    assert [bool(b["output"]) for b in gf["before"]] == [True, True, False]
    assert all(u != gf["fleet"] for u in got["routed_around"])
    assert got["parked_load"]["parked"] == 2
    assert got["parked_load"]["serving_slots"] == 0
    assert got["after_take"]["parked"] == 0
    assert [p[2] for p in got["parked"]] == [1, 1]
    assert all(p[1] for p in got["parked"])  # tokens committed before
    assert [r["output"] for r in got["resumed"]] == got["uninterrupted"]


@pytest.mark.parametrize("fpt", FLOPS_PER_TOKEN, ids=str)
@pytest.mark.parametrize("server_cls", ["BatchedServer", "ReferenceServer"])
def test_flops_per_token_matches_jax(ref, ns, server_cls, fpt):
    """``flops_per_token=`` of both servers as the JAX engine takes it:
    ``None`` charges 2 x active params a token, 0 nothing, 1e9 that many;
    each request's energy and ``energy_report`` at rel 1e-9, the same
    tokens and routes."""
    got = drive_sp(ns, getattr(engine, server_cls), flops_per_token=fpt)
    want = ref["fpt", server_cls, fpt]
    assert got["flops_per_token"] == want["flops_per_token"]
    assert got["flops_per_token"] == {
        None: 2.0 * ns["model"].cfg.active_param_count(), 0: 0.0,
        1e9: 1e9}[fpt]
    _same_reqs(got["reqs"], want["reqs"])
    _same_report(got["energy_report"], want["energy_report"])
    if not fpt and fpt is not None:
        assert got["energy_report"]["total_j"] == 0.0
