"""The port's telemetry against the JAX package's: the recording tracer,
its exporters and the trace-derived workload profiles.

  * **Tracer and exporters.**  The JAX package's tracer tests
    (tests/test_telemetry.py) become event scripts (``SCRIPTS``) run into
    ``repro.telemetry.Tracer`` (standard library only, so it runs in this
    process) and into the port's.  Spans, integrity reports, JSONL rows
    and Chrome trace events are equal, and a JSONL log written by either
    package loads in the other to the same tracer.
  * **The engine's instrumentation.**  One reduced tinyllama server in
    float32 on a fake clock, monolithic and chunked, in both packages on
    the same exported weights: span trees, events, counters and metric
    timelines equal; a disabled tracer leaves the tokens as they are; the
    reject and expire paths close the root.
  * **Profiles.**  ``summarize_trace``, ``profile_from_trace`` and
    ``phases_from_trace`` of those traces against the JAX package's on the
    same JSONL logs.  The JAX profile reaches ``core/energy_model.py``,
    which needs the ``enable_x64`` alias that jax 0.9.0 dropped, so its
    values come from one subprocess that restores it (see
    tests/test_torch_serve_chip.py); equal, float for float.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import telemetry as jtel
from repro.configs.base import get_config as jget_config
from repro.models import LM as JLM
from repro.serve import engine as jengine
from repro_torch import telemetry as tel
from repro_torch.configs.base import get_config
from repro_torch.models import LM
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TICK = 0.05
MAX_LEN = 64


# ------------------------------------------------------------ event scripts
def _idempotent_root(T):
    tr = T.Tracer()
    a = tr.request_begin(7, 1.0, prompt_tokens=4)
    b = tr.request_begin(7, 2.0, precision="sp")
    assert a is b and a.start_s == 1.0 and a.is_root
    return tr


def _attempt_chain(T):
    tr = T.Tracer()
    tr.request_begin(1, 0.0)
    tr.begin_attempt(1, 0.1, site="eco", fleet="decode_eco")
    tr.end_attempt(1, 0.5, status="drained")
    tr.begin_attempt(1, 0.6, site="gold", fleet="decode_gold")
    return tr


def _stale_attempt(T):
    tr = T.Tracer()
    tr.begin_attempt(1, 0.0, site="a")
    tr.begin_attempt(1, 1.0, site="b")  # no explicit end_attempt
    return tr


def _token_counters(T):
    E = T.Event
    tr = T.Tracer()
    tr.request_begin(3, 0.0)
    tr.event(3, E.ADMIT, 0.0)
    tr.begin_attempt(3, 0.1, site="die")
    tr.event(3, E.PREFILL_CHUNK, 0.2, tokens=16)
    tr.event(3, E.PREFILL_CHUNK, 0.3, tokens=4)
    tr.event(3, E.DECODE_DISPATCH, 0.4, tokens=3)
    tr.event(3, E.FINISH, 0.5, tokens_out=3)
    return tr


def _open_attempt(T):
    tr = T.Tracer()
    tr.request_begin(1, 0.0)
    tr.begin_attempt(1, 0.1)
    tr.end_request(1, 0.2, "ok")  # attempt still open
    tr.begin_attempt(5, 0.0).parent_id = 999  # an orphan
    tr.begin_attempt(6, 2.0).end_s = 1.0      # ends before it starts
    tr.spans.append(dataclasses.replace(tr.spans[0], span_id=99))
    return tr


def _hand_trace(T):
    E = T.Event
    tr = T.Tracer()
    tr.request_begin(1, 0.0, prompt_tokens=4, precision="sp")
    tr.event(1, E.ADMIT, 0.0)
    tr.begin_attempt(1, 0.1, site="eco", fleet="decode_eco", slot=2)
    tr.event(1, E.PREFILL, 0.1, tokens=4, bucket=4)
    tr.charge(1, "decode_eco", 1.5e-6, 2e6, 0.1, phase="prefill")
    tr.event(1, E.DECODE_DISPATCH, 0.2, tokens=3, slot=2)
    tr.charge(1, "decode_eco", 2.5e-6, 3e6, 0.2)
    tr.end_attempt(1, 0.3, status="ok")
    tr.end_request(1, 0.3, "ok")
    tr.request_begin(2, 0.05)                 # left open: a live request
    tr.begin_attempt(2, 0.15, site="gold", fleet="decode_gold")
    tr.event(2, E.REQUEUE, 0.2, requeues=1)
    tr.count("occupancy", 0.1, 0.5, site="eco")
    tr.count("occupancy", 0.2, 0.75, site="eco")
    tr.count("queued", 0.2, 3, site="gold")
    tr.system_event(E.FAULT, 0.25, site="eco", unit="decode_eco",
                    kind="kill")
    tr.system_event(E.PROBE, 0.35, site="eco", unit="decode_eco")
    return tr


SCRIPTS = dict(idempotent_root=_idempotent_root,
               attempt_chain=_attempt_chain, stale_attempt=_stale_attempt,
               token_counters=_token_counters, open_attempt=_open_attempt,
               hand_trace=_hand_trace)


def _spans(tr):
    return [dataclasses.asdict(s) for s in tr.spans]


def _state(tr):
    return dict(spans=_spans(tr), metrics=tr.metrics,
                system=tr.system_events, integrity=tr.check_integrity(),
                roots=sorted(tr.roots()),
                total_energy=tr.total_energy_j(),
                unit_energy=tr.unit_energy_j(),
                events={uid: tr.events_for(uid) for uid in tr.roots()},
                attempts={uid: [s.span_id for s in tr.attempts_for(uid)]
                          for uid in tr.roots()})


def test_event_vocabulary_matches_jax():
    names = [n for n in vars(jtel.Event) if n.isupper()]
    assert names == [n for n in vars(tel.Event) if n.isupper()]
    for n in names:
        assert getattr(tel.Event, n) == getattr(jtel.Event, n), n
    assert not tel.NULL_TRACER.enabled
    for hook, args in (("request_begin", (1, 0.0)),
                       ("event", (1, tel.Event.ADMIT, 0.0)),
                       ("begin_attempt", (1, 0.0)),
                       ("end_attempt", (1, 0.0)), ("end_request", (1, 0.0)),
                       ("charge", (1, "u", 1.0, 1.0, 0.0)),
                       ("count", ("occupancy", 0.0, 1.0)),
                       ("system_event", (tel.Event.FAULT, 0.0))):
        assert getattr(tel.NULL_TRACER, hook)(*args) is None, hook
        assert getattr(jtel.NULL_TRACER, hook)(*args) is None, hook


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_tracer_matches_jax(script):
    """Spans, events, counters, timelines, integrity reports and the
    energy queries of one event script, equal in both packages."""
    got, want = SCRIPTS[script](tel), SCRIPTS[script](jtel)
    assert _state(got) == _state(want)


def test_integrity_reports_what_the_reference_reports():
    problems = _open_attempt(tel).check_integrity()
    assert any("still open" in p for p in problems)
    assert any("orphaned" in p for p in problems)
    assert any("before it starts" in p for p in problems)
    assert any("root spans (want 1)" in p for p in problems)
    for name in ("attempt_chain", "stale_attempt", "token_counters",
                 "hand_trace"):
        assert SCRIPTS[name](tel).check_integrity() == [], name


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_exports_match_jax(script, tmp_path):
    """JSONL rows and Chrome trace events equal; each package's log loads
    in the other to an equal tracer, which stays live."""
    got, want = SCRIPTS[script](tel), SCRIPTS[script](jtel)
    paths = {}
    for name, mod, tr in (("port", tel, got), ("jax", jtel, want)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        mod.write_jsonl(tr, paths[name])
    assert open(paths["port"]).read() == open(paths["jax"]).read()
    assert tel.to_chrome_trace(got) == jtel.to_chrome_trace(want)
    chrome = tmp_path / "t.json"
    tel.write_chrome_trace(got, str(chrome))
    assert json.loads(chrome.read_text()) == jtel.to_chrome_trace(want)
    for path in paths.values():
        back_t, back_j = tel.load_jsonl(path), jtel.load_jsonl(path)
        assert _state(back_t) == _state(back_j)
        assert _state(back_t) == _state(tel.coerce_tracer(path))
        assert tel.coerce_tracer(got) is got
        s = back_t.begin_attempt(1, 9.0, site="late")
        assert s.span_id not in {x.span_id for x in got.spans}
    if script == "hand_trace":
        evs = tel.to_chrome_trace(got)["traceEvents"]
        att = next(e for e in evs if e["ph"] == "X"
                   and e["name"] == "attempt:eco/decode_eco")
        assert att["ts"] == pytest.approx(0.1e6)
        assert att["dur"] == pytest.approx(0.2e6)
        assert att["args"]["energy_j"] == pytest.approx(4e-6)
        assert {e["ph"] for e in evs} == {"M", "X", "i", "C"}


# ----------------------------------------------------- the engine, traced
@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tm = LM(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _requests(eng, n, new_tokens, dtype, seed=5):
    rng = np.random.default_rng(seed)
    return [eng.Request(uid=i, max_new_tokens=new_tokens,
                        prompt=rng.integers(0, 256, 4 + 3 * i).astype(dtype))
            for i in range(n)]


def _serve_traced(eng, T, model, params, dtype, chunk, tracer=True):
    """Six requests (prompts of 4-19 tokens, one past its deadline in the
    queue, one rejected) through a traced server on a fake clock."""
    clock = FakeClock()
    tr = T.Tracer() if tracer else None
    srv = eng.BatchedServer(model, params, slots=3, max_len=MAX_LEN,
                            dispatch_tokens=3, clock=clock, tracer=tr,
                            prefill_chunk=chunk, stop_tokens=(7,))
    reqs = _requests(eng, 6, 6, dtype)
    reqs[4].deadline_s = 0.01
    for r in reqs:
        srv.submit(r)
    bad = eng.Request(uid=9, max_new_tokens=2,
                      prompt=np.arange(MAX_LEN + 8).astype(dtype))
    with pytest.raises(eng.RequestRejected):
        srv.submit(bad)
    for _ in range(200):
        clock.t += TICK
        srv.step()
        if srv.idle():
            break
    return tr, {r.uid: (list(r.output), r.done, r.expired) for r in reqs}


@pytest.fixture(scope="module")
def traces(pair):
    jm, jp, tm, tp = pair
    out = {}
    for chunk in (None, 8):
        out["jax", chunk] = _serve_traced(jengine, jtel, jm, jp, np.int32,
                                          chunk)
        out["port", chunk] = _serve_traced(engine, tel, tm, tp, np.int64,
                                           chunk)
    return out


@pytest.mark.parametrize("chunk", [None, 8], ids=["monolithic", "chunked"])
def test_engine_trace_matches_jax(traces, chunk):
    """Span trees, events (sites, fleets, slots, buckets, tokens), counters
    and metric timelines of the same traffic, equal in both packages."""
    (got, got_out), (want, want_out) = traces["port", chunk], \
        traces["jax", chunk]
    assert got_out == want_out
    assert _state(got) == _state(want)
    assert got.check_integrity() == []
    for name in ("occupancy", "decode_occupancy", "prefill_occupancy",
                 "queued", "backlog_tokens", "decode_stall_frac",
                 "bucket_hit", "fleet_util.default"):
        assert name in got.metrics, name
    roots = got.roots()
    assert roots[9].status == "rejected" and roots[4].status == "expired"
    for uid, (out, done, expired) in got_out.items():
        if uid == 4:
            continue
        assert roots[uid].status == "ok" and done and not expired
        att, = got.attempts_for(uid)
        assert att.decode_tokens == len(out)


@pytest.mark.parametrize("chunk", [None, 8], ids=["monolithic", "chunked"])
def test_disabled_tracer_leaves_tokens_as_they_are(pair, traces, chunk):
    _, _, tm, tp = pair
    tr, out = _serve_traced(engine, tel, tm, tp, np.int64, chunk,
                            tracer=False)
    assert tr is None and out == traces["port", chunk][1]
    srv = engine.BatchedServer(tm, tp, slots=2, max_len=MAX_LEN)
    assert srv.tracer is tel.NULL_TRACER


# ---------------------------------------------------------------- profiles
_PROFILES = r"""
import dataclasses, pickle, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64  # the name jax 0.9.0 dropped
from repro.telemetry import (phases_from_trace, profile_from_trace,
                             summarize_trace)

out = {}
for key, path in pickle.load(open(sys.argv[1], "rb")).items():
    out[key] = dict(
        summary=dataclasses.asdict(summarize_trace(path)),
        profile=dataclasses.asdict(profile_from_trace(path, name="m")),
        flat=dataclasses.asdict(profile_from_trace(path, adaptive_bb=False)),
        phases=[dataclasses.asdict(p) for p in phases_from_trace(
            path, name="m", precision="dp", accuracy_slo=1e-2)])
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
"""


def _profiles(source):
    return dict(
        summary=dataclasses.asdict(tel.summarize_trace(source)),
        profile=dataclasses.asdict(tel.profile_from_trace(source,
                                                          name="m")),
        flat=dataclasses.asdict(tel.profile_from_trace(source,
                                                       adaptive_bb=False)),
        phases=[dataclasses.asdict(p) for p in tel.phases_from_trace(
            source, name="m", precision="dp", accuracy_slo=1e-2)])


def test_profiles_match_jax(traces, tmp_path):
    """The port's summary, blended profile and phase rows equal the JAX
    package's on the same logs (the port's traces, the hand trace and an
    empty tracer)."""
    logs = {}
    for chunk in (None, 8):
        logs["serve", chunk] = str(tmp_path / f"serve_{chunk}.jsonl")
        tel.write_jsonl(traces["port", chunk][0], logs["serve", chunk])
    logs["hand"] = str(tmp_path / "hand.jsonl")
    tel.write_jsonl(_hand_trace(tel), logs["hand"])
    logs["empty"] = str(tmp_path / "empty.jsonl")
    tel.write_jsonl(tel.Tracer(), logs["empty"])
    with open(tmp_path / "in.pkl", "wb") as fh:
        pickle.dump(logs, fh)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _PROFILES,
                           str(tmp_path / "in.pkl"),
                           str(tmp_path / "out.pkl")], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(tmp_path / "out.pkl", "rb") as fh:
        want = pickle.load(fh)
    for key, path in logs.items():
        got = _profiles(path)
        assert got == want[key], key
        if key != "empty":  # a live tracer gives what its log gives
            live = traces["port", key[1]][0] if key[0] == "serve" \
                else _hand_trace(tel)
            assert _profiles(live) == got, key
    summ = want["serve", None]["summary"]
    assert summ["n_requests"] == 7 and summ["n_completed"] == 5
    assert 0.0 < summ["activity"] <= 1.0
    assert want["empty"]["profile"]["activity"] == tel.MIN_ACTIVITY
    assert [p["name"] for p in want["serve", 8]["phases"]] == \
        ["m:prefill", "m:decode"]
