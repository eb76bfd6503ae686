"""The readers of the program's phase scopes (``repro_torch.telemetry.
profiled_session``): nothing where the program has no such accessor or
recorded nothing, values from a tiny traced serving run on the CPU, and on
the card the K1 scopes' device time against K1's kernels in the same
profile.

    python -m pytest -q perfbench/tests/test_program_spans.py
    python -m pytest -q -m cuda perfbench/tests/test_program_spans.py
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

SERVE = "chatglm3-6b.serve_longprompt"
EVAL = "starcoder2-7b.emulated_eval"
SERVING = ("admit_wait_p50_s.serve", "prefill_pad_share.serve",
           "engine_prefill_ms_per_ktok.serve", "engine_decode_step_ms.serve")
READERS = SERVING + ("k1_worst_roofline.eval",)


def reader(name):
    from perfbench import harness
    return harness.metric_reader(name)


@pytest.mark.parametrize("name", READERS)
def test_no_accessor_reads_nothing(name, monkeypatch):
    import repro_torch.telemetry as tel
    monkeypatch.delattr(tel, "profiled_session")
    assert reader(name)({}) is None
    monkeypatch.setattr(tel, "profiled_session", lambda: None,
                        raising=False)
    assert reader(name)({}) is None


def test_traced_serving_run_reads_the_engine(tiny_cell, monkeypatch):
    """A traced run of the serving cell at the test size: each serving
    reader gives a value, and the padding share equals the count from the
    prompt lengths of the batches prefilled in the window (the steps after
    the warm-up's)."""
    from perfbench import harness
    from repro_torch.serve.engine import BatchedServer, bucket_length
    cell = tiny_cell(SERVE)
    lo = int(cell.traffic["min_bucket"])
    steps, prefilled = [], []
    step, admit = BatchedServer.step, BatchedServer._admit_batch

    def counted_step(self, *args):
        steps.append(1)
        return step(self, *args)

    def counted(self, reqs, slot_ids, bucket):
        if len(steps) > cell.traffic["warmup_steps"]:
            prefilled.extend(len(r.prompt) for r in reqs)
        return admit(self, reqs, slot_ids, bucket)

    monkeypatch.setattr(BatchedServer, "step", counted_step)
    monkeypatch.setattr(BatchedServer, "_admit_batch", counted)
    out = harness.execute(cell, 2**31 + 5, 1.0, True, torch.device("cpu"),
                          time.perf_counter())
    assert out.correct, out.checks
    values = {name: reader(name)(out.record) for name in READERS}
    assert all(values[n] is not None and values[n] > 0 for n in SERVING), \
        values
    assert values["k1_worst_roofline.eval"] is None  # no K1 scope here
    buckets = [bucket_length(n, lo=lo) for n in prefilled]
    assert values["prefill_pad_share.serve"] == pytest.approx(
        100.0 * (sum(buckets) - sum(prefilled)) / sum(buckets), rel=1e-12)


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:.*Profiler clears events:UserWarning")
def test_k1_scopes_time_the_kernels_on_the_card():
    """One traced forward of the eval cell's model cut to two layers, at
    its widths and shape: the ``k1`` scopes' event time within 2% of K1's
    kernels in the same profile, their attrs ``plan_qmm``'s, and their
    starts on the profiler's clock within 50 us of their ranges'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from perfbench import counting, generate, harness
    from repro_torch import telemetry as tel
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.fused import plan_qmm
    from repro_torch.models.numerics import EmulatedPolicy
    cell = harness.resolve_cell(EVAL)
    cfg = dict(cell.config, num_hidden_layers=2)
    tr, dev = cell.traffic, torch.device("cuda", 0)
    fam = harness.family(cfg)
    model = fam.program(cfg, dev)
    weights = fam.make_weights(cfg, 2**31 + 3, dev)
    policy = EmulatedPolicy(tr["format"], tr["accum_style"])
    tokens = generate.token_batch(2**31 + 3, 0, tr["batch"], tr["seq_len"],
                                  cfg["vocab_size"], dev)
    with torch.no_grad():
        model.apply(weights, tokens, policy=policy)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.apply(weights, tokens, policy=policy)
            torch.cuda.synchronize()
    session = tel.profiled_session()
    k1 = session.scopes_named("k1")
    events = list(prof.profiler.kineto_results.events())
    kernel_s = sum(e.duration_ns() for e in events
                   if str(e.device_type()).endswith("CUDA")
                   and counting.is_k1(e.name())) * 1e-9
    scope_s = sum(s.device_s for s in k1)
    assert k1 and abs(scope_s - kernel_s) <= 0.02 * kernel_s, \
        (scope_s, kernel_s)
    for s in k1:
        a = s.attrs
        assert a["schedule"] == plan_qmm(a["nb"], a["m"], a["n"], a["k"],
                                         sm_count(dev)).schedule
    ranges = sorted(e.start_ns() for e in events if e.name() == "fpmax.k1"
                    and not str(e.device_type()).endswith("CUDA"))
    starts = [session.to_epoch_ns(s.start_ns) for s in k1]
    assert len(ranges) == len(starts)
    gaps = np.abs(np.array(starts) - np.array(ranges)) / 1e3
    assert float(np.median(gaps)) < 50.0, gaps
