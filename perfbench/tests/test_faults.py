"""A run with the timed path broken underneath comes out not correct, and
the lower-precision control does too; a sound run comes out correct.

Each test drives a whole run of a cell at the test size on the CPU (the
look for a card is ``run.py``'s and is skipped here), with one fault of
the kinds the cell can have planted in the program: an answer or token
altered where it is produced, half of the batch left out (the other half
standing in for it), and a step that leaves its state unchanged.  The
exchange between chips does not exist in these one-chip cells.
"""
from __future__ import annotations

import time

import pytest
import torch

from repro_torch.models.model import LM

EVALS = ["starcoder2-7b.emulated_eval", "chatglm3-6b.emulated_eval"]
SERVE = "chatglm3-6b.serve_longprompt"


def on_each_eval(values, ids):
    """(value, cell) cases over every eval cell; the first cell's cases
    keep the bare ids they had when it was the only one."""
    return [pytest.param(v, cell, id=i if cell == EVALS[0] else
                         f"{i}-{cell}")
            for cell in EVALS for v, i in zip(values, ids)]


def run(cell, control=False, seed=2**31 + 11):
    """A whole run of ``cell`` with a 1-s window: long enough, on a loaded
    CPU too, for the serving loop to finish some hundreds of tokens."""
    from perfbench import harness
    return harness.execute(cell, seed, 1.0, False, torch.device("cpu"),
                           time.perf_counter(), control=control)


@pytest.mark.parametrize("name", EVALS + [SERVE])
def test_sound_run_is_correct(tiny_cell, name):
    out = run(tiny_cell(name))
    assert out.correct, out.checks
    assert out.failed == 0 and out.attempted > 0


# ------------------------------------------------------------- eval faults
def eval_altered(apply):
    def broken(self, params, tokens, **kw):
        logits, *rest = apply(self, params, tokens, **kw)
        logits = logits.clone()
        mid = tokens.shape[1] // 2
        logits[0, mid] = logits[0, mid].roll(1)
        return (logits, *rest)
    return broken


def eval_half_batch(apply):
    def broken(self, params, tokens, **kw):
        half = tokens.shape[0] // 2
        logits, *rest = apply(self, params, tokens[:half], **kw)
        return (torch.cat([logits, logits]), *rest)
    return broken


def eval_unchanged(apply):
    first = {}

    def broken(self, params, tokens, **kw):
        out = apply(self, params, tokens, **kw)
        return first.setdefault("out", out)  # every forward returns the first
    return broken


EVAL_FAULTS = [eval_altered, eval_half_batch, eval_unchanged]


@pytest.mark.parametrize("fault,name", on_each_eval(
    EVAL_FAULTS, [f.__name__ for f in EVAL_FAULTS]))
def test_eval_fault_is_not_correct(tiny_cell, monkeypatch, fault, name):
    monkeypatch.setattr(LM, "apply", fault(LM.apply))
    out = run(tiny_cell(name))
    assert not out.correct, out.checks


# ------------------------------------------------------------ serve faults
def serve_altered(scan):
    def broken(self, *args, **kw):
        cache, tok, active, budget, toks, emitted = scan(self, *args, **kw)
        toks = toks.clone()
        toks[0] = (toks[0] + 1) % self.cfg.vocab_size
        return cache, tok, active, budget, toks, emitted
    return broken


def serve_half_batch(scan):
    def broken(self, *args, **kw):
        cache, tok, active, budget, toks, emitted = scan(self, *args, **kw)
        toks = toks.clone()
        half = toks.shape[1] // 2
        toks[:, half:2 * half] = toks[:, :half]
        return cache, tok, active, budget, toks, emitted
    return broken


def serve_unchanged(prefill):
    def broken(self, params, tokens, true_lens, **kw):
        logits, kv, states = prefill(self, params, tokens, true_lens, **kw)
        return logits, tuple(torch.zeros_like(t) for t in kv), states
    return broken


@pytest.mark.parametrize("fault,method", [
    (serve_altered, "decode_scan"), (serve_half_batch, "decode_scan"),
    (serve_unchanged, "prefill_batched")])
def test_serve_fault_is_not_correct(tiny_cell, monkeypatch, fault, method):
    monkeypatch.setattr(LM, method, fault(getattr(LM, method)))
    out = run(tiny_cell(SERVE))
    assert not out.correct, out.checks


# ---------------------------------------------------------------- controls
@pytest.mark.parametrize("seed,name", on_each_eval([1, 2, 3],
                                                   ["1", "2", "3"]))
def test_eval_control_is_not_correct(tiny_cell, seed, name):
    """The program's own fp8_e4m3 path in place of bf16."""
    out = run(tiny_cell(name), control=True, seed=seed)
    assert out.extra["format"] == "fp8_e4m3"
    assert not out.correct, out.checks


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serve_control_is_not_correct(tiny_cell, seed):
    """The tokens the reference's float8_e4m3fn matmuls put first, judged
    in place of the served ones, fail the limit."""
    out = run(tiny_cell(SERVE), control=True, seed=seed)
    assert out.extra["judged"] == "fp8 reference"
    assert not out.correct, out.checks
