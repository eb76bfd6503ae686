"""Traffic kind ``eval``: teacher-forced evaluation under an emulated FPU
format.

Set-up makes the weights and warms one forward at the cell's shape.  The
window runs whole forwards, ``LM.apply(params, tokens, policy=
EmulatedPolicy(format, accum_style))`` on a fresh seeded batch each, and
scores each position's next-token log-probability on the device, until
``--seconds`` have passed; the rate is every scored token over all the
elapsed time, the last forward included.  One forward, drawn from the seed
by reservoir sampling, keeps its logits; after the window the plain
float32 reference recomputes them from the same weights and tokens.

Numbers compared (``limits/<cell>.json``): ``logit_gap``, the largest
|program - reference| logit over the forward's largest |reference logit|,
and ``nonfinite_rows``, the sequences of the window with a scored
log-probability that is not finite (limit 0).  With ``control`` the
forward runs under ``control_format`` instead (calibration only).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import counting, generate, harness
from perfbench.trace import DeviceTrace

#: what this driver needs of a family beyond ``harness.FAMILY_NEEDS``
FAMILY_NEEDS = ("k1_forward_bound_s",)


def score(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Each position's log-probability of the next token (B, S - 1)."""
    lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    return lp.gather(-1, tokens[:, 1:, None])[..., 0]


def run(r: harness.Run) -> harness.Outcome:
    from repro_torch.models.numerics import EmulatedPolicy
    cfg, tr, dev = r.cell.config, r.cell.traffic, r.device
    fam = harness.family(cfg)
    model = fam.program(cfg, dev)
    weights = fam.make_weights(cfg, r.seed, dev)
    fmt = tr["control_format"] if r.control else tr["format"]
    policy = EmulatedPolicy(fmt, tr["accum_style"])
    B, S, V = tr["batch"], tr["seq_len"], cfg["vocab_size"]

    def forward(tokens):
        return model.apply(weights, tokens, policy=policy)[0][..., :V]

    spans = harness.Spans(dev, r.trace)
    trace = DeviceTrace(dev, r.trace)

    def one(index: int):
        """Forward and score batch ``index``: (tokens, logits, the rows
        with a log-probability that is not finite)."""
        tokens = generate.token_batch(r.seed, index, B, S, V, dev)
        with spans.span("forward", tokens=B * S):
            out = forward(tokens)
        with spans.span("score", tokens=B * (S - 1)):
            bad = int((~torch.isfinite(score(out, tokens))).any(-1).sum())
        return tokens, out, bad  # the int above synchronised

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        one(-1)  # warm-up: the window's own code on a batch of its own
        spans.items.clear()
        picker = np.random.default_rng(generate.seed_seq(r.seed, 4))
        kept = None
        bad_rows = n = 0
        trace.start()  # its start-up before the window
        t0 = time.perf_counter()
        while True:
            tokens, out, bad = one(n)
            if picker.random() < 1.0 / (n + 1):  # a uniform draw of one
                kept = (n, tokens, out)
            del out
            bad_rows += bad
            n += 1
            now = time.perf_counter()
            if now - t0 >= r.seconds:
                break
        trace.stop(forwards=n, tokens=n * B * S,
                   scored_tokens=n * B * (S - 1))
    window_s = now - t0
    setup_s = t0 - r.t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the check, outside the window: the program's state freed first
    idx, tokens, got = kept
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        want = fam.reference_logits(cfg, weights, tokens)
        scale = float(want.abs().max())
        gap = float((got.to(torch.float32) - want).abs().max()) / scale
    lim = r.cell.limits
    scored = n * B * (S - 1)
    record = {
        "config": cfg, "traffic": tr, "window_s": window_s,
        "forwards": n, "scored_tokens": scored, "tokens": n * B * S,
        "model_flops": n * fam.model_flops(
            cfg, B * S, B * counting.causal_pairs(S)),
        "k1_bound_s_per_forward": fam.k1_forward_bound_s(cfg, B * S),
        "spans": spans.items, "profile": trace.summary}
    return harness.Outcome(
        attempted=n * B, failed=bad_rows,
        metrics={"emulated_tok_s": scored / window_s, "setup_s": setup_s},
        checks={"logit_gap": (gap, lim["logit_gap"]),
                "nonfinite_rows": (bad_rows, lim["nonfinite_rows"])},
        memory_peak_bytes=int(peak), record=record,
        extra={"kept_forward": idx, "format": fmt})
