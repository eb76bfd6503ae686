"""Counts by family: the drivers take model FLOPs and K1's bound from the
configuration's family, the dense family's are ``counting``'s to the bit,
a family that lacks one is refused when its cell is resolved, and a
family whose file has none of the dense keys runs through both drivers."""
from __future__ import annotations

import dataclasses
import sys
import time
import types

import pytest
import torch

from perfbench import counting, harness
from perfbench.tests import fixture_family

EVAL = "starcoder2-7b.emulated_eval"
SERVE = "chatglm3-6b.serve_longprompt"
#: one forward of the eval mix (2 x 2048), each count as the parent
#: commit's ``counting`` gave it, and a serving window's work
PARENT = {
    "starcoder2-7b": {"forward": 61230261731328.0,
                      "k1_bound": 0.05940864773435794,
                      "serve": 100301876822016.0},
    "chatglm3-6b": {"forward": 50887712047104.0,
                    "k1_bound": 0.04968690037148116,
                    "serve": 79539465289728.0},
}
SERVE_WORK = (1500 + 13 * 32, 123456789)  # tokens, (query, key) pairs


@pytest.mark.parametrize("name", [EVAL, SERVE])
def test_dense_counts_are_countings_to_the_bit(name):
    cfg = harness.resolve_cell(name).config
    fam = harness.family(cfg)
    assert fam.model_flops is counting.model_flops
    assert fam.k1_forward_bound_s is counting.k1_forward_bound_s
    want = PARENT[cfg["name"]]
    B, S = 2, 2048
    assert fam.model_flops(cfg, B * S, B * counting.causal_pairs(S)) \
        == want["forward"]
    assert fam.k1_forward_bound_s(cfg, B * S) == want["k1_bound"]
    assert fam.model_flops(cfg, *SERVE_WORK) == want["serve"]


def run(cell, seed=2**31 + 23):
    return harness.execute(cell, seed, 1.0, False, torch.device("cpu"),
                           time.perf_counter())


def test_eval_record_counts_are_countings(tiny_cell):
    cell = tiny_cell(EVAL)
    out = run(cell)
    cfg, rec = cell.config, out.record
    B, S = cell.traffic["batch"], cell.traffic["seq_len"]
    assert rec["model_flops"] == rec["forwards"] * counting.model_flops(
        cfg, B * S, B * counting.causal_pairs(S))
    assert rec["k1_bound_s_per_forward"] == counting.k1_forward_bound_s(
        cfg, B * S)


# ------------------------------------------------- refused at resolve time
def without(name):
    """The dense family with ``name`` taken out."""
    from perfbench.families import dense
    mod = types.ModuleType(dense.__name__)
    mod.__dict__.update({k: v for k, v in vars(dense).items()
                         if k != name})
    return mod


@pytest.mark.parametrize("missing,cell", [
    ("model_flops", EVAL), ("model_flops", SERVE),
    ("k1_forward_bound_s", EVAL), ("program", SERVE),
    ("reference_logits", EVAL)])
def test_a_family_without_a_function_fails_at_resolve(monkeypatch, missing,
                                                      cell):
    monkeypatch.setitem(sys.modules, "perfbench.families.dense",
                        without(missing))
    with pytest.raises(AttributeError) as err:
        harness.resolve_cell(cell)
    assert missing in str(err.value)
    assert "perfbench/families/dense.py" in str(err.value)


def test_serving_needs_no_k1_bound(monkeypatch):
    monkeypatch.setitem(sys.modules, "perfbench.families.dense",
                        without("k1_forward_bound_s"))
    assert harness.resolve_cell(SERVE).name == SERVE


# --------------------------------------- a family with none of the dense keys
@pytest.fixture
def fixture_cell(tiny_cell, monkeypatch):
    """A tiny cell of ``name``'s mix and limits whose configuration is the
    fixture family's, with a record of each count the family gave."""
    calls = {"model_flops": [], "k1_forward_bound_s": []}
    fam = types.ModuleType("perfbench.families.fixture")
    fam.__dict__.update(vars(fixture_family))
    for fn in calls:
        def spy(*args, _fn=getattr(fixture_family, fn), _log=calls[fn]):
            _log.append((args[1:], _fn(*args)))
            return _log[-1][1]
        setattr(fam, fn, spy)
    monkeypatch.setitem(sys.modules, "perfbench.families.fixture", fam)

    def make(name):
        cell = tiny_cell(name)
        return dataclasses.replace(cell, config=dict(fixture_family.CONFIG))
    return make, calls


def test_the_fixture_has_no_dense_key():
    cfg = fixture_family.CONFIG
    assert not {"head_dim", "intermediate_size", "block"} & set(cfg)
    with pytest.raises(KeyError):
        counting.model_flops(cfg, 1, 1)
    with pytest.raises(KeyError):
        counting.k1_forward_bound_s(cfg, 1)


def test_fixture_family_through_the_eval_driver(fixture_cell):
    make, calls = fixture_cell
    cell = make(EVAL)
    harness.check_family(cell.config, cell.traffic)
    out = run(cell)
    assert out.correct, out.checks
    rec = out.record
    B, S = cell.traffic["batch"], cell.traffic["seq_len"]
    (args, flops), = calls["model_flops"]
    assert args == (B * S, B * counting.causal_pairs(S))
    assert rec["model_flops"] == rec["forwards"] * flops \
        == rec["forwards"] * fixture_family.model_flops(cell.config, *args)
    (args, bound), = calls["k1_forward_bound_s"]
    assert args == (B * S,)
    assert rec["k1_bound_s_per_forward"] == bound > 0
    assert harness.metric_reader("mfu.eval")(rec) > 0


def test_fixture_family_through_the_serving_driver(fixture_cell):
    make, calls = fixture_cell
    cell = make(SERVE)
    harness.check_family(cell.config, cell.traffic)
    out = run(cell)
    assert out.correct, out.checks
    rec = out.record
    (args, flops), = calls["model_flops"]
    assert args[0] == rec["prompt_tokens"] + rec["decoded_tokens"] > 0
    assert rec["model_flops"] == flops > 0
    assert not calls["k1_forward_bound_s"]
