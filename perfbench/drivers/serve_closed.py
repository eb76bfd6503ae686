"""Traffic kind ``serve_closed``: ``BatchedServer`` under a closed loop of
clients, each of which submits its next request when its last one
finishes.

The server runs the native path (no numerics policy), greedy, with
``slots`` lanes, ``dispatch_tokens`` decode steps a dispatch and a
``max_len`` that holds the largest prompt bucket plus the longest output;
there are no stop tokens.  It stamps submissions and first tokens with the
benchmark's own host clock (``time.perf_counter``, passed as its clock).
Set-up makes the weights and runs ``warmup_steps`` steps of the same loop,
which warms the prompt buckets and the decode step and brings the loop to
its steady state; the window then runs whole steps until ``--seconds``
have passed.  A traced run profiles the last warm-up step too.

Numbers compared (``limits/<cell>.json``), over a sample drawn from the
seed of the requests finished in the window, the longest among them, of
at least ``check_tokens`` served tokens: ``served_gap``, the widest gap by
which a served token's reference logit lies below the reference's best at
its position, over that position's largest |reference logit| (the
reference runs once over each prompt with its served tokens), and
``short_outputs``, the requests finished in the window with another
number of tokens than they asked for (limit 0).  With ``control``
(calibration only) the tokens judged are those the lower-precision
reference puts first at the same positions, in place of the served ones,
so ``served_gap`` reads the control and ``correct`` comes out false.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import counting, generate, harness
from perfbench.trace import DeviceTrace


def window_work(fam, cfg: dict, reqs, out_at_start: dict) -> dict:
    """Prompt tokens prefilled, tokens decoded and the model FLOPs, by the
    family ``fam``'s count, of the outputs committed between the window's
    start and end (output 0 comes from the prompt's forward; output k >= 1
    from a decode step over P + k keys)."""
    prompt = decoded = pairs = 0
    for req in reqs:
        P = len(req.prompt)
        k0, k1 = out_at_start.get(req.uid, 0), len(req.output)
        if k0 == 0 and k1 > 0:
            prompt += P
            pairs += counting.causal_pairs(P)
        a = max(k0, 1)
        if k1 > a:
            decoded += k1 - a
            pairs += (k1 - a) * P + (k1 - 1 + a) * (k1 - a) // 2
    return {"prompt_tokens": prompt, "decoded_tokens": decoded,
            "model_flops": fam.model_flops(cfg, prompt + decoded, pairs)}


def sample(reqs, seed: int, want_tokens: int):
    """The longest finished request and others drawn from the seed until
    their outputs hold ``want_tokens`` tokens."""
    order = sorted(range(len(reqs)),
                   key=lambda i: -(len(reqs[i].prompt) + len(reqs[i].output)))
    first, rest = order[0], order[1:]
    rng = np.random.default_rng(generate.seed_seq(seed, 5))
    picked, total = [first], len(reqs[first].output)
    for i in rng.permutation(rest):
        if total >= want_tokens:
            break
        picked.append(int(i))
        total += len(reqs[i].output)
    return [reqs[i] for i in picked]


def gap(fam, cfg, weights, req, dev, control: bool) -> float:
    """The widest gap by which the judged tokens' reference logits lie
    below the reference's best, over each position's largest |reference
    logit|.  The judged tokens are the served ones or, with ``control``,
    those the fp8 reference puts first at the same positions."""
    P, out = len(req.prompt), list(req.output)
    seq = np.concatenate([np.asarray(req.prompt), np.asarray(out[:-1],
                                                             np.int64)])
    toks = torch.as_tensor(seq, device=dev)[None]
    rows = torch.arange(P - 1, P - 1 + len(out), device=dev)
    want = fam.reference_logits(cfg, weights, toks, rows=rows)[0]
    if control:
        judged = fam.reference_logits(cfg, weights, toks, rows=rows,
                                      fp8=True)[0].argmax(-1)
    else:
        judged = torch.as_tensor(out, device=dev)
    best, scale = want.max(-1).values, want.abs().max(-1).values
    return float(((best - want.gather(-1, judged[:, None])[:, 0])
                  / scale).max())


def run(r: harness.Run) -> harness.Outcome:
    from repro_torch.serve.engine import BatchedServer, Request, bucket_length
    cfg, tr, dev = r.cell.config, r.cell.traffic, r.device
    fam = harness.family(cfg)
    model = fam.program(cfg, dev)
    weights = fam.make_weights(cfg, r.seed, dev)
    V = cfg["vocab_size"]
    max_len = bucket_length(int(tr["prompt_len"]["hi"]),
                            lo=int(tr["min_bucket"])) \
        + int(tr["output_len"]["hi"])
    spans = harness.Spans(dev, r.trace)
    if r.trace:  # synchronised spans around the model's two entry points
        spans.wrap(model, "prefill_batched",
                   lambda params, tokens, true_lens, **kw: {
                       "real_tokens": int(true_lens.sum()),
                       "padded_tokens": tokens.numel()})
        spans.wrap(model, "decode_scan",
                   lambda params, cache, tok, active, budget, n_steps, **kw:
                   {"steps": int(n_steps)})
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    server = BatchedServer(
        model, weights, slots=int(tr["slots"]), max_len=max_len,
        dispatch_tokens=int(tr["dispatch_tokens"]), clock=time.perf_counter,
        flops_per_token=0.0, min_bucket=int(tr["min_bucket"]))
    stream = generate.requests(tr, r.seed, V)
    reqs, finished_in_window = [], []

    def submit():
        g = next(stream)
        req = Request(uid=g.index, prompt=g.prompt,
                      max_new_tokens=g.max_new_tokens)
        server.submit(req)
        reqs.append(req)

    def step(window: bool):
        server.step(int(tr["dispatch_tokens"]))
        done, server.finished = server.finished, []
        for req in done:
            if window:
                finished_in_window.append(req)
            submit()

    trace = DeviceTrace(dev, r.trace)
    with torch.no_grad():
        for _ in range(int(tr["clients"])):
            submit()
        warmup = int(tr["warmup_steps"])
        for i in range(warmup):
            if i == warmup - 1:
                # before the last warm-up step, so that the requests it
                # submits, which the window's first step admits, do not
                # wait for the profiler's start-up
                trace.start()
            step(False)
        if not warmup:
            trace.start()
        harness.sync(dev)
        spans.items.clear()
        out_at_start = {req.uid: len(req.output) for req in reqs}
        n_before = len(reqs)
        tok0, rejected0 = server.tokens_decoded, len(server.rejected)
        t0 = time.perf_counter()
        while True:
            step(True)
            now = time.perf_counter()
            if now - t0 >= r.seconds:
                break
        trace.stop()
    window_s = now - t0
    setup_s = t0 - r.t_start
    delivered = server.tokens_decoded - tok0
    ttft = [q.first_token_s - q.submitted_s for q in reqs
            if q.first_token_s is not None and t0 <= q.first_token_s <= now]
    work = window_work(fam, cfg, reqs, out_at_start)
    failed = len(server.rejected) - rejected0 + sum(
        1 for q in finished_in_window if q.expired)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the check, outside the window: the server and its cache freed first
    del server, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    short = sum(1 for q in finished_in_window
                if len(q.output) != q.max_new_tokens)
    picked = sample(finished_in_window, r.seed, int(tr["check_tokens"]))
    with torch.no_grad():
        served_gap = max(gap(fam, cfg, weights, q, dev, r.control)
                         for q in picked)
    lim = r.cell.limits
    extra = {"sampled_requests": len(picked),
             "sampled_tokens": sum(len(q.output) for q in picked),
             "judged": "fp8 reference" if r.control else "served"}
    record = {
        "config": cfg, "traffic": tr, "window_s": window_s,
        "ttft_s": ttft, "spans": spans.items, "profile": trace.summary,
        "delivered_tokens": delivered, **work}
    return harness.Outcome(
        attempted=len(reqs) - n_before, failed=failed,
        metrics={"served_tok_s": delivered / window_s, "setup_s": setup_s},
        checks={"served_gap": (served_gap, lim["served_gap"]),
                "short_outputs": (short, lim["short_outputs"])},
        memory_peak_bytes=int(peak), record=record, extra=extra)
