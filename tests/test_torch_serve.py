"""The port's serving engine against its own greedy decoder and the JAX one.

``BatchedServer`` (monolithic bucketed admission and chunked prefill, stop
tokens, slot churn) is held against the port's ``greedy_decode``, and the
port's ``greedy_decode`` against the JAX package's on weights exported with
``params_from_jax``.  Greedy argmax can flip on a near-tie when two sides
compute the logits in a different summation order (bucket padding changes
the matmul shapes; the two packages use different BLAS), so a token
mismatch counts as a fault only where the top-2 logit margin (the port's) at
that step exceeds ``MARGIN_BOUND``; after a legitimate flip the streams are
not compared further.  ``MARGIN_BOUND`` is ten times the 1e-4 logit
tolerance that tests/test_torch_model.py holds the two packages to.

The ssm family (falcon-mamba ``reduced()``) is served too: exact-length
batching (its states integrate pads), the chunked-prefill size rounded up
to ``cfg.ssm_scan_chunk``, and no prompt-length cap from a KV cache it does
not have.  Its server streams are held against the port's
``greedy_decode`` and against the JAX engine's streams, by the same rule.
So are the hybrid (zamba2, 5 layers), MoE (deepseek-moe) and ring
(mixtral, 16-token window) families' ``reduced()`` servers, monolithic and
chunked, against the JAX engine's streams.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import LM as JLM
from repro.serve import engine as jengine
from repro_torch.configs.base import get_config
from repro_torch.models import LM
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as tengine
from repro_torch.serve import (BatchedServer, Request, RequestRejected,
                               bucket_length, greedy_decode)

MARGIN_BOUND = 1e-3


class FakeClock:
    """Deterministic ``clock`` for the engine's deadlines."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


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


def _prompts(vocab, lens, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int64) for n in lens]


def _margins(model, params, prompt, n_new, max_len):
    """The port's greedy stream with the top-2 logit margin of each step."""
    tokens = torch.as_tensor(prompt[None])
    last, cache = model.prefill(params, tokens, max_len=max_len)
    toks, margins = [], []
    for step in range(n_new):
        top2 = torch.topk(last[0].float(), 2).values
        margins.append(float(top2[0] - top2[1]))
        toks.append(int(torch.argmax(last[0])))
        if step + 1 < n_new:
            logits, cache = model.decode_step(
                params, cache, torch.tensor([[toks[-1]]]))
            last = logits[:, -1]
    return toks, margins


def _assert_streams_agree(got, want, margins, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            assert margins[i] <= MARGIN_BOUND, (what, i, got, want, margins[i])
            return  # a near-tie flip: the streams legitimately diverge here
    assert len(got) == len(want), (what, got, want)


# ------------------------------------------------- port vs the JAX package
@pytest.fixture(scope="module")
def jax_streams(pair):
    """The JAX package's greedy streams of two prompts, 6 tokens each."""
    jm, jp, _, _ = pair
    prompts = _prompts(256, (5, 17))
    return [(p, jengine.greedy_decode(jm, jp, p.astype(np.int32), 6,
                                      max_len=32)) for p in prompts]


@pytest.mark.parametrize("with_stop", [False, True], ids=["plain", "stop"])
def test_greedy_decode_matches_jax(pair, jax_streams, with_stop):
    jm, jp, tm, tp = pair
    for prompt, want in jax_streams:
        stops = (want[2],) if with_stop else ()
        if with_stop:
            want = jengine.greedy_decode(jm, jp, prompt.astype(np.int32), 6,
                                         max_len=32, stop_tokens=stops)
            assert len(want) <= 3
        got = greedy_decode(tm, tp, prompt, 6, max_len=32, stop_tokens=stops)
        _, margins = _margins(tm, tp, prompt, 6, 32)
        _assert_streams_agree(got, want, margins, "port vs jax")


def test_bucket_length_matches_jax():
    for lo in (1, 8, 16):
        assert [bucket_length(n, lo=lo) for n in range(1, 300)] == \
            [jengine.bucket_length(n, lo=lo) for n in range(1, 300)]


# ------------------------------------------- the server vs greedy_decode
@pytest.fixture(scope="module")
def dense():
    """The reduced config in its own dtype (bfloat16), as the JAX serving
    tests run it, with weights drawn from a torch.Generator."""
    cfg = get_config("tinyllama-1.1b").reduced()
    model = LM(cfg, device="cpu")
    return cfg, model, model.init(seed=3)


@pytest.mark.parametrize("chunk,budget", [(None, None), (4, None), (3, 5)],
                         ids=["monolithic", "chunked", "chunked-budget"])
def test_server_matches_greedy_decode(dense, chunk, budget):
    """More requests than slots, prompts over three pad buckets, multi-token
    dispatches and a stop token that ends one request early."""
    cfg, model, params = dense
    lens, new = (3, 9, 17, 6, 12), (6, 4, 8, 1, 5)
    prompts = _prompts(cfg.vocab_size, lens)
    plain = greedy_decode(model, params, prompts[2], new[2], max_len=32)
    stops = (plain[3],)
    refs = [greedy_decode(model, params, p, n, max_len=32, stop_tokens=stops)
            for p, n in zip(prompts, new)]
    assert any(len(r) < n for r, n in zip(refs, new))  # the stop fired
    server = BatchedServer(model, params, slots=2, max_len=32,
                           dispatch_tokens=3, stop_tokens=stops,
                           prefill_chunk=chunk, prefill_token_budget=budget)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new))]
    for r in reqs:
        server.submit(r)
    finished = server.run(max_steps=200)
    assert sorted(r.uid for r in finished) == list(range(len(reqs)))
    for r, ref, p, n in zip(reqs, refs, prompts, new):
        assert r.done and not r.expired
        _, margins = _margins(model, params, p, n, 32)
        _assert_streams_agree(r.output, ref, margins, f"request {r.uid}")
    report = server.run_report()
    assert report["tokens_decoded"] == sum(len(r.output) for r in reqs)
    assert report["prefill_tokens"] == sum(lens)


def test_server_deadlines_and_rejects(dense):
    cfg, model, params = dense
    clock = FakeClock(10.0)
    server = BatchedServer(model, params, slots=2, max_len=16, clock=clock)
    p = _prompts(cfg.vocab_size, (4,))[0]
    late = Request(uid=0, prompt=p, max_new_tokens=4, deadline_s=5.0)
    live = Request(uid=1, prompt=p, max_new_tokens=4, deadline_s=50.0)
    server.submit(late)
    server.submit(live)
    done = server.run(max_steps=20)
    assert {r.uid for r in done} == {0, 1}
    assert late.expired and late.output == []  # expired in the queue
    assert not live.expired and len(live.output) == 4
    assert live.first_token_s == 10.0 and live.submitted_s == 10.0
    for bad, code in ((Request(2, p, 0), "bad_max_tokens"),
                      (Request(3, np.zeros((2, 2), np.int64), 2),
                       "bad_prompt"),
                      (Request(4, np.zeros(17, np.int64), 2),
                       "prompt_too_long")):
        with pytest.raises(RequestRejected, match=code):
            server.submit(bad)
        assert bad.rejected and bad in server.rejected


def test_server_chip_policy_waits_for_its_slice(dense):
    """The chip facade's slice has landed: a chip policy splits the slots
    into one fleet per decode unit, routes and charges each request
    (tests/test_torch_serve_chip.py holds it to the JAX engine)."""
    from repro_torch.core import chip
    from repro_torch.core import energy_model as em
    cfg, model, params = dense
    tech = em.TechParams(tuple(s[1] for s in em._PARAM_SPEC))
    policy = chip.ChipPolicy(chip.fabricated_chip("sp", tech), tech)
    server = BatchedServer(model, params, slots=2, max_len=16,
                           chip_policy=policy, deadline_routing=True)
    assert sorted(server.fleet_report()) == ["sp_cma", "sp_fma"]
    r = Request(uid=0, prompt=_prompts(cfg.vocab_size, (4,))[0],
                max_new_tokens=2)
    server.submit(r)
    server.run()
    assert r.routed_unit == "sp_fma" and len(r.output) == 2
    assert r.energy_j > 0 and sorted(r.unit_energy_j) == ["sp_fma"]


@pytest.mark.parametrize("chunk", [None, 4], ids=["monolithic", "chunked"])
def test_trace_events_match_jax(pair, chunk):
    """The engine's tracer hooks, recorded by the JAX package's ``Tracer``:
    the same requests give each request the same spans and events as the
    JAX ``BatchedServer``, and the port's trace passes the tracer's own
    integrity check."""
    from repro.telemetry.tracer import Tracer
    jm, jp, tm, tp = pair
    prompts = _prompts(256, (3, 9, 17, 6, 12))
    new = (6, 4, 8, 1, 5)

    def drive(server_cls, request_cls, model, params, dtype):
        tracer = Tracer()
        server = server_cls(model, params, slots=2, max_len=32,
                            dispatch_tokens=3, clock=FakeClock(1.0),
                            tracer=tracer, prefill_chunk=chunk)
        for i, (p, n) in enumerate(zip(prompts, new)):
            server.submit(request_cls(uid=i, prompt=p.astype(dtype),
                                      max_new_tokens=n,
                                      deadline_s=0.5 if i == 3 else None))
        with pytest.raises(ValueError, match="prompt_too_long"):
            server.submit(request_cls(uid=len(prompts),
                                      prompt=np.zeros(40, dtype),
                                      max_new_tokens=2))
        server.run(max_steps=200)
        return tracer

    want = drive(jengine.BatchedServer, jengine.Request, jm, jp, np.int32)
    got = drive(BatchedServer, Request, tm, tp, np.int64)
    assert got.check_integrity() == []
    for uid in range(len(prompts) + 1):  # one expires, the last is rejected
        assert [(s.name, s.status, s.prefill_tokens, s.decode_tokens)
                for s in got.spans_for(uid)] == \
            [(s.name, s.status, s.prefill_tokens, s.decode_tokens)
             for s in want.spans_for(uid)]
        assert [(e[0], e[2].get("tokens")) for e in got.events_for(uid)] == \
            [(e[0], e[2].get("tokens")) for e in want.events_for(uid)]


def test_reference_server_matches_jax(pair):
    """The per-token ``ReferenceServer`` (one host sync per token, the
    slot's cache lane rewritten at admission): the same tokens as the JAX
    package's on the same weights, with more requests than slots, and as
    the port's batched engine."""
    from repro_torch.serve import ReferenceServer
    jm, jp, tm, tp = pair
    prompts = _prompts(256, (3, 9, 17, 6, 12))
    new = (6, 4, 8, 1, 5)
    outs = {}
    for key, cls, req_cls, model, params, dtype in (
            ("jax", jengine.ReferenceServer, jengine.Request, jm, jp,
             np.int32),
            ("port", ReferenceServer, Request, tm, tp, np.int64),
            ("batched", BatchedServer, Request, tm, tp, np.int64)):
        server = cls(model, params, slots=2, max_len=32)
        reqs = [req_cls(uid=i, prompt=p.astype(dtype), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, new))]
        for r in reqs:
            server.submit(r)
        done = server.run()
        assert sorted(r.uid for r in done) == list(range(len(reqs)))
        outs[key] = [list(r.output) for r in reqs]
        assert server.tokens_decoded == sum(new)
    assert outs["port"] == outs["jax"]
    assert outs["port"] == outs["batched"]
    assert [len(o) for o in outs["port"]] == list(new)


def test_fleet_out_of_service_refuses_submits(dense):
    from repro_torch.faults import UnitFault
    cfg, model, params = dense
    server = BatchedServer(model, params, slots=2, max_len=16)
    p = _prompts(cfg.vocab_size, (4,))[0]
    server.set_fleet_in_service("", False)
    with pytest.raises(UnitFault):
        server.submit(Request(uid=0, prompt=p, max_new_tokens=2))
    with pytest.raises(KeyError):
        server.set_fleet_in_service("sp_fma", True)
    server.set_fleet_in_service("", True)
    server.submit(Request(uid=1, prompt=p, max_new_tokens=2))
    assert [len(r.output) for r in server.run()] == [2]


# ------------------------------------- drain / re-admission vs the JAX engine
MAX_DRAIN_LEN = 48


def _both(pair):
    """(engine module, model, params, prompt dtype) for each package."""
    jm, jp, tm, tp = pair
    return {"jax": (jengine, jm, jp, np.int32),
            "port": (tengine, tm, tp, np.int64)}


def _load_script(eng, model, params, dtype):
    """``load_report`` with a queued long prompt, a seated mid-prefill lane
    and the one fleet out of service."""
    busy, long_, chunky = [
        eng.Request(uid=i, prompt=p.astype(dtype), max_new_tokens=8)
        for i, p in enumerate(_prompts(256, (4, 30, 13)))]
    server = eng.BatchedServer(model, params, slots=1, max_len=48)
    server.submit(busy)
    server.step()  # occupies the only slot: the next submit stays queued
    reports = [server.load_report()]
    server.submit(long_)
    reports.append(server.load_report())
    server.set_fleet_in_service("", False)
    reports.append(server.load_report())
    chunked = eng.BatchedServer(model, params, slots=1, max_len=48,
                                prefill_chunk=4)
    chunked.submit(chunky)
    chunked.step()  # seated, one 4-token chunk done, 9 prompt tokens left
    reports.append(chunked.load_report())
    return reports


def test_load_report_matches_jax(pair):
    """The token-weighted backlog: a queued prompt adds its prompt and
    decode tokens, a mid-prefill lane its un-prefilled prompt tokens, and
    an out-of-service fleet's slots leave the divisor; every report equal
    to the JAX engine's."""
    got = _load_script(*_both(pair)["port"])
    want = _load_script(*_both(pair)["jax"])
    assert got == want
    assert got[1]["backlog_tokens"] - got[0]["backlog_tokens"] == 30 + 8
    assert got[2]["serving_slots"] == 0
    assert got[2]["load"] == got[2]["backlog_tokens"]
    assert got[3]["active"] == 1 and got[3]["backlog_tokens"] >= 9


def _evacuate_script(eng, model, params, dtype, where):
    """Evacuate a server mid-prefill (nothing committed) or mid-decode
    (tokens committed, one request still queued) and requeue the requests
    on a fresh server with another slot count."""
    if where == "mid_prefill":
        lens, new, kw, steps = (13,), (5,), dict(prefill_chunk=4), 1
    else:
        lens, new, kw, steps = (5, 11, 7), (14, 12, 10), {}, 2
    reqs = [eng.Request(uid=i, prompt=p.astype(dtype), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(256, lens, seed=5),
                                           new))]
    first = eng.BatchedServer(model, params, slots=2 if len(reqs) > 1
                              else 1, max_len=MAX_DRAIN_LEN, **kw)
    for r in reqs:
        first.submit(r)
    for _ in range(steps):
        first.step(2)
    at_drain = [list(r.output) for r in reqs]
    drained = first.evacuate()
    out = dict(at_drain=at_drain, drained=[r.uid for r in drained],
               idle=first.idle(), load=first.load_report(),
               mask=bool(np.asarray(first._active_mask).any()))
    second = eng.BatchedServer(model, params, slots=3, max_len=MAX_DRAIN_LEN,
                               **kw)
    out["fleets"] = [second.requeue(r) for r in drained]
    done = second.run(dispatch_tokens=2)
    out["done"] = sorted(r.uid for r in done)
    out["outputs"] = [list(r.output) for r in reqs]
    out["requeues"] = [r.requeues for r in reqs]
    out["state"] = [(r.done, r.expired) for r in reqs]
    return out


@pytest.mark.parametrize("where", ["mid_prefill", "mid_decode"])
def test_evacuate_and_requeue_match_jax(pair, where):
    """``evacuate`` hands every seated and queued request back untouched;
    ``requeue`` on a fresh server resumes each as a continuation (the
    committed tokens replayed through the decode path): the same streams
    as the JAX engine's and as an uninterrupted ``greedy_decode``."""
    both = _both(pair)
    got = _evacuate_script(*both["port"], where)
    want = _evacuate_script(*both["jax"], where)
    assert got == want
    assert got["idle"] and not got["mask"]
    assert got["load"]["active"] == got["load"]["queued"] == 0
    assert got["fleets"] == [""] * len(got["drained"])
    assert got["requeues"] == [1] * len(got["drained"])
    if where == "mid_prefill":
        assert got["at_drain"] == [[]]
    else:  # 5 and 7 share a pad bucket and are seated with tokens
        # committed; the 11-token prompt is still queued
        assert got["drained"] == [0, 2, 1]
        assert [len(o) > 0 for o in got["at_drain"]] == [True, False, True]
    _, tm, tp, _ = both["port"]
    lens = (13,) if where == "mid_prefill" else (5, 11, 7)
    new = (5,) if where == "mid_prefill" else (14, 12, 10)
    for p, n, out in zip(_prompts(256, lens, seed=5), new, got["outputs"]):
        assert out == greedy_decode(tm, tp, p, n, max_len=MAX_DRAIN_LEN)


def _force_drain_script(eng, model, params, dtype):
    """Force-drain (``requeue=False``) the one fleet mid-flight."""
    ps = _prompts(256, (4, 6, 5), seed=7)
    seated = [eng.Request(uid=i, prompt=p.astype(dtype), max_new_tokens=40)
              for i, p in enumerate(ps[:2])]
    queued = eng.Request(uid=2, prompt=ps[2].astype(dtype),
                         max_new_tokens=4)
    server = eng.BatchedServer(model, params, slots=2, max_len=MAX_DRAIN_LEN)
    for r in seated + [queued]:
        server.submit(r)
    server.step()
    server.step()
    before = [list(r.output) for r in seated]
    affected = server.drain_fleet("", requeue=False)
    return dict(
        before=before, affected=sorted(r.uid for r in affected),
        active=[a is None for a in server._active],
        mask=bool(np.asarray(server._active_mask).any()),
        outputs=[list(r.output) for r in seated + [queued]],
        state=[(r.done, r.expired) for r in seated + [queued]],
        finished=sorted(r.uid for r in server.finished),
        next_step=server.step(), load=server.load_report(),
        decoded=server.tokens_decoded)


def test_force_drain_matches_jax(pair):
    """Seated requests finish as expired with exactly the tokens they had,
    the queued one with none; host and device slot state is released and
    the next step does nothing.  Equal to the JAX engine's."""
    got = _force_drain_script(*_both(pair)["port"])
    want = _force_drain_script(*_both(pair)["jax"])
    assert got == want
    assert got["affected"] == got["finished"] == [0, 1, 2]
    assert got["active"] == [True, True] and not got["mask"]
    assert got["outputs"][:2] == got["before"] and got["outputs"][2] == []
    assert all(o for o in got["before"])
    assert got["state"] == [(True, True)] * 3 and got["next_step"] == 0


# ------------------------------------------------------------ ssm family
SSM_LENS, SSM_NEW = (9, 9, 70, 6, 130), (6, 4, 8, 1, 5)


@pytest.fixture(scope="module")
def ssm_pair():
    jcfg = dataclasses.replace(jget_config("falcon-mamba-7b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("falcon-mamba-7b").reduced(),
                              dtype="float32")
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(5))
    tm = LM(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def ssm_model():
    """falcon-mamba's reduced config in its own dtype (bfloat16)."""
    cfg = get_config("falcon-mamba-7b").reduced()
    model = LM(cfg, device="cpu")
    return cfg, model, model.init(seed=5)


def _serve(server, prompts, new, dtype=np.int64, request_cls=Request):
    reqs = [request_cls(uid=i, prompt=p.astype(dtype), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new))]
    for r in reqs:
        server.submit(r)
    server.run(max_steps=200)
    return reqs


@pytest.mark.parametrize("chunk,budget", [(None, None), (40, None),
                                          (40, 100)],
                         ids=["monolithic", "chunked", "chunked-budget"])
def test_ssm_server_matches_greedy_decode(ssm_model, chunk, budget):
    """Prompts longer than max_len (no KV cap), two of one length admitted
    in one exact-length batch, two of the chunked prompts spanning more
    than one 64-token scan chunk."""
    cfg, model, params = ssm_model
    prompts = _prompts(cfg.vocab_size, SSM_LENS, seed=12)
    refs = [greedy_decode(model, params, p, n)
            for p, n in zip(prompts, SSM_NEW)]
    server = BatchedServer(model, params, slots=2, max_len=32,
                           dispatch_tokens=3, prefill_chunk=chunk,
                           prefill_token_budget=budget)
    assert server.prefill_chunk == (None if chunk is None else 64)
    assert [server._bucket(n) for n in SSM_LENS] == list(SSM_LENS)
    reqs = _serve(server, prompts, SSM_NEW)
    for r, ref, p, n in zip(reqs, refs, prompts, SSM_NEW):
        assert r.done and not r.expired and len(r.output) == n
        _, margins = _margins(model, params, p, n, len(p) + n)
        _assert_streams_agree(r.output, ref, margins, f"request {r.uid}")
    report = server.run_report()
    assert report["prefill_tokens"] == sum(SSM_LENS)
    assert report["tokens_decoded"] == sum(SSM_NEW)


@pytest.mark.parametrize("chunk", [None, 40], ids=["monolithic", "chunked"])
def test_ssm_server_matches_jax(ssm_pair, chunk):
    """The port's and the JAX engine's streams for the same requests, on
    exported weights."""
    jm, jp, tm, tp = ssm_pair
    prompts = _prompts(256, SSM_LENS, seed=13)
    kw = dict(slots=2, max_len=32, dispatch_tokens=3, prefill_chunk=chunk)
    want = _serve(jengine.BatchedServer(jm, jp, **kw), prompts, SSM_NEW,
                  np.int32, jengine.Request)
    got = _serve(BatchedServer(tm, tp, **kw), prompts, SSM_NEW)
    for g, w, p, n in zip(got, want, prompts, SSM_NEW):
        assert len(w.output) == n
        _, margins = _margins(tm, tp, p, n, len(p) + n)
        _assert_streams_agree(g.output, w.output, margins,
                              f"request {g.uid}")


# ----------------------------------------- hybrid, MoE and ring families
#: two prompts of 9 tokens (one exact-length batch for the hybrid), and 40
#: tokens: longer than the reduced mixtral's 16-token window
FAMILY_LENS, FAMILY_NEW = (9, 9, 40, 6, 21), (6, 4, 8, 1, 5)
FAMILY_KW = {"zamba2-1.2b": dict(n_layers=5, ssm_scan_chunk=4),
             "deepseek-moe-16b": {}, "mixtral-8x7b": {}}


@functools.lru_cache(maxsize=None)
def _family_pair(arch):
    kw = dict(FAMILY_KW[arch], dtype="float32")
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(6))
    tm = LM(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("chunk", [None, 6], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("arch", sorted(FAMILY_KW))
def test_family_server_matches_jax(arch, chunk):
    """The hybrid, MoE and ring servers' streams against the JAX engine's
    on exported weights.  The hybrid batches at exact lengths and rounds
    a chunk of 6 up to its scan chunk (8, two carry points of 4); the
    ring caps no prompt length and keeps the 40-token prompt's last 16
    positions."""
    jm, jp, tm, tp = _family_pair(arch)
    prompts = _prompts(256, FAMILY_LENS, seed=14)
    kw = dict(slots=2, max_len=48, dispatch_tokens=3, prefill_chunk=chunk)
    want = _serve(jengine.BatchedServer(jm, jp, **kw), prompts, FAMILY_NEW,
                  np.int32, jengine.Request)
    server = BatchedServer(tm, tp, **kw)
    hybrid = arch == "zamba2-1.2b"
    assert server._len_cap == (None if tm.ring else 48)
    assert [server._bucket(n) for n in FAMILY_LENS] == (
        list(FAMILY_LENS) if hybrid
        else [min(b, server._len_cap or b) for b in (16, 16, 64, 8, 32)])
    if chunk:
        assert server.prefill_chunk == (8 if hybrid else 6)
    got = _serve(server, prompts, FAMILY_NEW)
    for g, w, p, n in zip(got, want, prompts, FAMILY_NEW):
        assert len(w.output) == n and g.done
        _, margins = _margins(tm, tp, p, n, 48)
        _assert_streams_agree(g.output, w.output, margins,
                              f"{arch} request {g.uid}")
