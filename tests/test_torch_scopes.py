"""Phase scopes of the port's telemetry (``telemetry.scope``): what the
serving engine, the model's entry points and K1 record, and where.

With tracing off nothing is recorded and the served tokens are those of a
traced run, bitwise.  Under a CPU ``torch.profiler`` session the scopes
nest as the engine runs them, count the prefill's real and padded tokens
exactly, measure each request's wait on the engine's clock, carry K1's
shape and schedule, convert to the profiler's clock, and survive the JSONL
and Chrome exports.  No JAX: the scopes have no counterpart there.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import telemetry as tel
from repro_torch.configs.base import get_config
from repro_torch.core.formats import get_format
from repro_torch.kernels import fused
from repro_torch.models import LM
from repro_torch.serve import engine

#: torch 2.11's profiler warns once a process that it keeps one cycle
pytestmark = pytest.mark.filterwarnings(
    "ignore:.*Profiler clears events:UserWarning")

MAX_LEN = 64

#: each scope's parent in the engine's monolithic and chunked steps
PARENT = {"serve.step": None, "serve.admit": "serve.step",
          "serve.prefill": "serve.admit",
          "serve.cache_write": "serve.prefill",
          "model.prefill_batched": "serve.prefill",
          "model.apply": "model.prefill_batched",
          "attn": "model.apply",
          "serve.decode": "serve.step",
          "model.decode_scan": "serve.decode",
          "serve.commit": "serve.step"}


@pytest.fixture(scope="module")
def lm():
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32", n_layers=1)
    model = LM(cfg, device="cpu")
    return model, model.init(0)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def serve(lm, chunk, tracer=None, profiled=False):
    """Six requests (prompts of 3-23 tokens, so 8-, 16- and 32-token
    buckets) submitted a quarter second apart on a fake clock, through a
    three-slot server; returns (outputs, server, requests)."""
    model, params = lm
    clock = FakeClock()
    srv = engine.BatchedServer(model, params, slots=3, max_len=MAX_LEN,
                               dispatch_tokens=3, clock=clock, tracer=tracer,
                               prefill_chunk=chunk)
    rng = np.random.default_rng(7)
    reqs = [engine.Request(uid=i, max_new_tokens=4,
                           prompt=rng.integers(0, 256, 3 + 4 * i))
            for i in range(6)]

    def run():
        for i, req in enumerate(reqs):
            clock.t = 0.25 * i
            srv.submit(req)
        for _ in range(100):
            clock.t += 0.5
            srv.step(3)
            if srv.idle():
                break

    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            run()
    else:
        run()
    return {r.uid: list(r.output) for r in reqs}, srv, reqs


@pytest.mark.parametrize("chunk", [None, 8], ids=["monolithic", "chunked"])
def test_tracing_off_records_nothing_and_changes_no_token(lm, chunk):
    before = tel.profiled_session()
    n_before = len(before.scopes) if before is not None else 0
    off, _, _ = serve(lm, chunk)
    after = tel.profiled_session()
    assert after is before
    assert (len(after.scopes) if after is not None else 0) == n_before
    on, _, _ = serve(lm, chunk, profiled=True)
    assert on == off
    traced, _, _ = serve(lm, chunk, tracer=tel.Tracer())
    assert traced == off


@pytest.mark.parametrize("chunk", [None, 8], ids=["monolithic", "chunked"])
def test_engine_scopes_nest_and_count_the_prefill(lm, chunk):
    _, srv, reqs = serve(lm, chunk, profiled=True)
    tr = tel.profiled_session()
    by_id = {s.scope_id: s for s in tr.scopes}
    names = {s.name for s in tr.scopes}
    want = set(PARENT) - ({"serve.cache_write", "model.prefill_batched",
                           "model.apply", "attn"} if chunk else set())
    assert names == want
    for s in tr.scopes:
        parent = by_id[s.parent_id].name if s.parent_id is not None \
            else None
        assert parent == PARENT[s.name], (s.name, parent)
        assert s.end_ns >= s.start_ns and s.device_s is None
    pf = tr.scopes_named("serve.prefill")
    assert sum(s.attrs["real_tokens"] for s in pf) == srv.prefill_tokens
    for s in pf:
        a = s.attrs
        assert a["padded_tokens"] == a["rows"] * a["bucket"] \
            - a["real_tokens"]
    if chunk is None:
        assert sum(s.attrs["padded_tokens"] for s in pf) == sum(
            engine.bucket_length(len(r.prompt)) - len(r.prompt)
            for r in reqs)
    # one wait per request, at the start of its first prefill
    assert sum(len(s.attrs["waited_s"]) for s in pf) == len(reqs)
    steps = tr.scopes_named("serve.step")
    assert sum(s.attrs["batches"] for s in tr.scopes_named("serve.admit")) \
        == len(pf)
    assert sum(s.attrs["tokens"] for s in tr.scopes_named("serve.commit")) \
        + len(reqs) == srv.tokens_decoded
    assert all(s.attrs["seated"] >= s.attrs["decode_lanes"] for s in steps)
    dec = tr.scopes_named("serve.decode")
    assert [s.attrs["steps"] for s in dec] == [3] * len(dec)


def test_waits_are_exact_on_the_engine_clock(lm):
    """Monolithic admission prefills a request and commits its first token
    in one step, at one reading of the fake clock: the wait is that
    reading less the submission's."""
    _, _, reqs = serve(lm, None, profiled=True)
    got = sorted(w for s in tel.profiled_session().scopes_named(
        "serve.prefill") for w in s.attrs["waited_s"])
    want = sorted(r.first_token_s - r.submitted_s for r in reqs)
    assert got == want and got[0] > 0


def test_engine_tracer_takes_the_engine_scopes(lm):
    tracer = tel.Tracer()
    before = tel.profiled_session()
    serve(lm, None, tracer=tracer)
    assert tel.profiled_session() is before
    assert {s.name for s in tracer.scopes} == {
        "serve.step", "serve.admit", "serve.prefill", "serve.cache_write",
        "serve.decode", "serve.commit"}
    assert tracer.check_integrity() == []


def test_k1_scope_carries_the_call(lm):
    fmt = get_format("bf16")
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 5, 130, generator=g)
    b = torch.randn(130, 7, generator=g)
    off = fused.fused_qmm(a, b, fmt=fmt, style="cascade")
    with profile(activities=[ProfilerActivity.CPU]):
        on = fused.fused_qmm(a, b, fmt=fmt, style="cascade")
        fused.fused_qmm(a[0], b, fmt=fmt)
    assert torch.equal(on, off)
    k1 = tel.profiled_session().scopes_named("k1")
    assert [s.attrs for s in k1] == [
        dict(nb=2, m=5, k=130, n=7, schedule="ref", bm=128, fmt="bf16",
             style="cascade"),
        dict(nb=1, m=5, k=130, n=7, schedule="ref", bm=128, fmt="bf16",
             style="fused")]
    # the attrs are plan_qmm's arguments: a card's plan of the same call
    s = k1[0].attrs
    plan = fused.plan_qmm(s["nb"], s["m"], s["n"], s["k"], 132)
    assert plan.schedule == "split_rows" and plan.bm == s["m"]


def test_scopes_convert_to_the_profiler_clock():
    x = torch.ones(16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(100):
            with tel.scope("probe"):
                x = x @ x * 0.01
    tr = tel.profiled_session()
    ranges = sorted(e.start_ns() for e in prof.profiler.kineto_results
                    .events() if e.name() == "fpmax.probe")
    starts = [tr.to_epoch_ns(s.start_ns) for s in tr.scopes_named("probe")]
    assert len(ranges) == len(starts) == 100
    gaps = np.abs(np.array(starts) - np.array(ranges)) / 1e3
    assert float(np.median(gaps)) < 50.0, gaps


def test_each_session_starts_its_own_tracer():
    with profile(activities=[ProfilerActivity.CPU]):
        with tel.scope("first"):
            pass
    one = tel.profiled_session()
    with profile(activities=[ProfilerActivity.CPU]):
        with tel.scope("second", note=1):
            pass
    two = tel.profiled_session()
    assert one is not two
    assert [s.name for s in two.scopes] == ["second"]
    assert two.scopes[0].attrs == {"note": 1}
    with tel.scope("outside") as sc:
        assert not sc.on
    assert tel.profiled_session() is two and len(two.scopes) == 1


def test_scopes_survive_the_exports(lm, tmp_path):
    tracer = tel.Tracer()
    serve(lm, 8, tracer=tracer)
    path = str(tmp_path / "t.jsonl")
    tel.write_jsonl(tracer, path)
    rows = [json.loads(line) for line in open(path)]
    assert sum(r["k"] == "clock" for r in rows) == 1
    assert sum(r["k"] == "scope" for r in rows) == len(tracer.scopes)
    back = tel.load_jsonl(path)
    assert back.clock_anchor == tracer.clock_anchor
    fields = ("scope_id", "parent_id", "name", "start_ns", "end_ns",
              "device_s", "attrs")
    assert [[getattr(s, f) for f in fields] for s in back.scopes] == \
        [[getattr(s, f) for f in fields] for s in tracer.scopes]
    assert len(back.spans) == len(tracer.spans)
    evs = tel.to_chrome_trace(tracer)["traceEvents"]
    scopes = [e for e in evs if e.get("cat") == "scope"]
    assert len(scopes) == len(tracer.scopes)
    assert len({e["pid"] for e in scopes}) == 1
    assert scopes[0]["pid"] not in {e["pid"] for e in evs
                                    if e.get("cat") in ("root", "attempt")}
    empty = str(tmp_path / "empty.jsonl")
    tel.write_jsonl(tel.Tracer(), empty)
    assert open(empty).read() == ""
    assert tel.to_chrome_trace(tel.Tracer())["traceEvents"] == []


def test_a_scope_off_costs_no_torch_call(monkeypatch):
    """With no tracer and no profiler, a scope is the shared no-op: it
    builds no scope and never reaches torch's profiler."""
    monkeypatch.setattr(tel.Tracer, "scope", None)
    t0 = time.perf_counter()
    for _ in range(1000):
        with tel.scope("k1", device=torch.device("cpu"), nb=1) as sc:
            sc.set(m=2)
    assert sc is tel.NULL_SCOPE and not sc.on
    assert time.perf_counter() - t0 < 0.5
