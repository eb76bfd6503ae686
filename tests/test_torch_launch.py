"""The port's launchers against the JAX package's: ``launch.serve`` (plain,
``--chaos kill``, ``--chaos corrupt``), ``launch.cluster`` (plain,
``--fail-at``, ``--trace-out x.jsonl``) and ``launch.train``, on the CPU.

Each launcher builds the reduced config with its package's own random
weights, so the tokens differ; with no stop token the schedule does not
depend on them.  The JAX side runs every case in one subprocess through
``runpy`` with the ``enable_x64`` alias restored (``repro.core.chip``
needs it under jax 0.9.0; see tests/test_torch_cluster.py), the port's in
this process through ``main(argv)`` with ``--device cpu``.  Both record
the servers, routers and replays the launcher built (``_RECORD``, run
against each package) and pickle or return them.  Tolerances:

  * identical: the printed summary, request counts, tokens per request,
    dispatches, requeues and migrations, the fault log and health, the
    simulated latencies, TTFTs and spans, the trace's span count;
  * rel 1e-9: joules.

The JSONL trace each package writes loads with the port's ``load_jsonl``
and the two give the same spans (energies at rel 1e-9).

``launch.train`` trains each package's own random weights, so only the
printed rows' structure is compared: the same keys in the same order, the
same steps, ``tokens`` and ``lr``, finite losses.
"""
import ast
import contextlib
import io
import math
import os
import pickle
import subprocess
import sys

import pytest

from repro_torch.launch import cluster as tcluster_launch
from repro_torch.launch import serve as tserve_launch
from repro_torch.launch import train as ttrain_launch
from repro_torch.telemetry import load_jsonl

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
REL = 1e-9

CASES = dict(serve=("serve", []),
             serve_kill=("serve", ["--chaos", "kill"]),
             serve_corrupt=("serve", ["--chaos", "corrupt"]),
             cluster=("cluster", []),
             cluster_fail=("cluster", ["--fail-at", "2.0",
                                       "--fail-die", "eco"]),
             cluster_trace=("cluster", ["--trace-out", "x.jsonl"]))

#: ``record(pkg, launch, name, argv)``: run one launcher of package
#: ``pkg`` through ``launch(which, argv)`` and return what it printed and
#: what its servers, routers and replays hold, and the servers.
_RECORD = r'''
import contextlib
import importlib
import io


def request_row(r):
    return dict(uid=r.uid, n_out=len(r.output), routed=r.routed_unit,
                done=r.done, expired=r.expired, requeues=r.requeues,
                energy=r.energy_j, units=dict(r.unit_energy_j))


def server_row(s):
    out = dict(requests=[request_row(r) for r in s._submitted_for_test],
               dispatches=s.dispatches, host_syncs=s.host_syncs,
               prefill_tokens=s.prefill_tokens,
               tokens_decoded=s.tokens_decoded)
    if s.chip_policy is not None:
        out["energy"] = s.energy_report()
    if hasattr(s, "resilience_report"):
        out["resilience"] = s.resilience_report()
        out["wasted_j"] = s.wasted_energy_j
    return out


def replay_row(rep):
    return dict(finished=[request_row(r) for r in rep["finished"]],
                rejected=[r.uid for r in rep["rejected"]],
                expired=[r.uid for r in rep["expired"]],
                latency_s=rep["latency_s"], ttft_s=rep["ttft_s"],
                classes=rep["classes"], span_s=rep["span_s"],
                submitted=rep["submitted"])


def record(pkg, launch, which, argv):
    eng = importlib.import_module(pkg + ".serve.engine")
    clu = importlib.import_module(pkg + ".cluster")
    servers, routers, replays = [], [], []
    s_init, r_init, replay = (eng.BatchedServer.__init__,
                              clu.ClusterRouter.__init__, clu.replay)

    def server_init(self, *a, **k):
        s_init(self, *a, **k)
        self._submitted_for_test = []
        submit = self.submit

        def recorded_submit(req):
            self._submitted_for_test.append(req)
            return submit(req)

        self.submit = recorded_submit
        servers.append(self)

    def router_init(self, *a, **k):
        r_init(self, *a, **k)
        routers.append(self)

    def recorded_replay(*a, **k):
        out = replay(*a, **k)
        replays.append(replay_row(out))
        return out

    eng.BatchedServer.__init__ = server_init
    clu.ClusterRouter.__init__ = router_init
    clu.replay = recorded_replay
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            launch(which, argv)
    finally:
        eng.BatchedServer.__init__ = s_init
        clu.ClusterRouter.__init__ = r_init
        clu.replay = replay
    out = dict(stdout=buf.getvalue().splitlines(), replays=replays,
               routers=[r.cluster_report() for r in routers])
    if not routers:
        out["servers"] = [server_row(s) for s in servers]
    return out, servers
'''

_REF = r"""
import os, pickle, runpy, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64  # the name jax 0.9.0 dropped

exec(sys.argv[1])
CASES = eval(sys.argv[2])


def launch(which, argv):
    sys.argv = [which] + argv
    runpy.run_module("repro.launch." + which, run_name="__main__")


os.chdir(sys.argv[3])
out = {name: record("repro", launch, which, argv)[0]
       for name, (which, argv) in CASES.items()}
with open("ref.pkl", "wb") as fh:
    pickle.dump(out, fh)
"""

exec(_RECORD)

_MAINS = dict(serve=tserve_launch.main, cluster=tcluster_launch.main)


def _port_launch(which, argv):
    _MAINS[which](argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("launch")


@pytest.fixture(scope="module")
def ref(workdir):
    """Every case through the JAX package's launchers, in one subprocess
    working in ``workdir/ref``."""
    d = workdir / "ref"
    d.mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _REF, _RECORD, repr(CASES),
                           str(d)], capture_output=True, text=True, env=env,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(d / "ref.pkl", "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def port(workdir):
    """Each case through the port's launchers on the CPU, working in
    ``workdir/port``, computed once: (record, servers)."""
    d = workdir / "port"
    d.mkdir()
    cache = {}

    def get(name):
        if name not in cache:
            which, argv = CASES[name]
            cwd = os.getcwd()
            os.chdir(d)
            try:
                cache[name] = record("repro_torch", _port_launch, which,
                                     argv)
            finally:
                os.chdir(cwd)
        return cache[name]

    return get


def _match(got, want, path=""):
    """Equal structure and values; floats exact, joules within REL."""
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
    elif isinstance(want, float):
        joules = any(k in path for k in ("energy", "units", "_j"))
        if math.isnan(want):
            assert math.isnan(got), path
        elif joules and want != 0 and math.isfinite(want):
            assert abs(got / want - 1) <= REL, (path, got, want)
        else:
            assert got == want, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_launcher_matches_jax(port, ref, name):
    (got, servers), want = port(name), ref[name]
    _match(got, want, name)
    which, argv = CASES[name]
    if which == "serve":
        (srv,) = got["servers"]
        n = 8  # --requests' default
        assert len(srv["requests"]) == n
        assert all(r["done"] and not r["expired"] and r["n_out"] == 12
                   for r in srv["requests"])
        if "--chaos" in argv:
            # the die's calibration is never fitted: nothing served reads it
            assert servers[0].chip_policy._params is None
            assert got["stdout"][0].startswith(f"chaos={argv[1]}: {n}/{n} "
                                               "requests completed")
            log = srv["resilience"]["fault_log"]
            assert log and log[0]["unit"] == "decode_eco"
        else:
            assert got["stdout"][0].startswith(f"{n}/{n} requests completed")
    else:
        fin = sum(len(r["finished"]) for r in got["replays"])
        n_trace = int(got["stdout"][-3 if "--trace-out" in argv else -2]
                      .split()[0].split("/")[1])
        assert fin == n_trace and not any(r["expired"]
                                          for r in got["replays"])
        (rep,) = got["routers"]
        if "--fail-at" in argv:
            assert rep["failed"] == ["eco"] and len(got["replays"]) == 2
            assert rep["migrations"] >= 1
            assert got["stdout"][0].startswith("killed die 'eco' at t=")
            assert rep["migrations"] == int(got["stdout"][0].split(": ")[1]
                                            .split()[0])


def test_cluster_trace_loads_with_port_loader(port, ref, workdir):
    """Both packages' JSONL traces load with the port's ``load_jsonl``:
    as many spans as printed, a clean integrity check, and the same span
    trees (energies at rel 1e-9)."""
    (got, _), want = port("cluster_trace"), ref["cluster_trace"]
    traces = {}
    for side, rec in (("port", got), ("ref", want)):
        tr = load_jsonl(str(workdir / side / "x.jsonl"))
        n = int(rec["stdout"][-1].split()[1])
        assert len(tr.spans) == n > 0
        assert tr.check_integrity() == []
        traces[side] = tr
    rows = {side: [dict(uid=s.uid, parent_id=s.parent_id, name=s.name,
                        site=s.site, fleet=s.fleet, start_s=s.start_s,
                        end_s=s.end_s, status=s.status, energy_j=s.energy_j,
                        unit_energy_j=s.unit_energy_j,
                        prefill_tokens=s.prefill_tokens,
                        decode_tokens=s.decode_tokens)
                   for s in tr.spans] for side, tr in traces.items()}
    _match(rows["port"], rows["ref"], "spans")
    arrivals = [e for e in traces["port"].system_events
                if e[0] == "arrival"]
    assert len(arrivals) == sum(r["submitted"] for r in got["replays"])


TRAIN_ARGV = ["--steps", "20", "--seq-len", "32", "--batch", "4"]


def test_train_launcher_rows_match_jax(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "repro.launch.train"]
                          + TRAIN_ARGV, capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = proc.stdout.strip().splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrain_launch.main(TRAIN_ARGV + [
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "10"])
    got = buf.getvalue().strip().splitlines()
    assert len(got) == len(want) == 3 and got[-1] == want[-1]
    for g, w in zip(got[:-1], want[:-1]):
        g, w = ast.literal_eval(g), ast.literal_eval(w)
        assert list(g) == list(w)
        for k in ("step", "tokens", "lr", "aux_loss"):
            assert g[k] == w[k], k
        assert math.isfinite(g["loss"]) and g["grad_norm"] > 0
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_10", "step_20"]


def _train_rows(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrain_launch.main(argv)
    lines = buf.getvalue().strip().splitlines()
    return [ast.literal_eval(line) for line in lines[:-1]], lines[-1]


def test_train_launcher_sharded_matches_unsharded():
    """``--devices 4 --data 2 --model 2`` on 4 spawned gloo ranks: rank 0's
    rows have the unsharded run's steps, tokens and lr, and its loss
    within 1e-4 relative (the printed values, rounded to 4 places)."""
    argv = ["--device", "cpu", "--steps", "3", "--seq-len", "32",
            "--batch", "4"]
    want, want_tail = _train_rows(argv)
    got, got_tail = _train_rows(argv + ["--devices", "4", "--data", "2",
                                        "--model", "2"])
    assert got_tail == want_tail.replace("on 1 device(s)", "on 4 device(s)")
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("step", "tokens", "lr"):
            assert g[k] == w[k], k
        assert abs(g["loss"] - w["loss"]) / w["loss"] < 1e-4


def test_train_launcher_devices_must_match_the_mesh():
    with pytest.raises(ValueError, match="--data 2 x --model 2"):
        ttrain_launch.main(["--device", "cpu", "--devices", "3", "--data",
                            "2", "--model", "2"])
