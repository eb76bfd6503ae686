"""The plain float32 reference against the port's ``LM.apply`` on reduced
configurations of both dense configs, on the benchmark's own weights."""
from __future__ import annotations

import pytest
import torch

from perfbench import generate, harness
from perfbench.reference import dense as ref
from perfbench.tests.conftest import tiny

CELLS = ["starcoder2-7b.emulated_eval", "chatglm3-6b.serve_longprompt"]


def setup(name, dtype):
    cfg = tiny(harness.resolve_cell(name)).config
    cfg["dtype"] = cfg["kv_cache_dtype"] = dtype
    fam = harness.family(cfg)
    weights = fam.make_weights(cfg, 2**31 + 7, "cpu")
    tokens = generate.token_batch(5, 0, 2, 40, cfg["vocab_size"], "cpu")
    return cfg, fam, weights, tokens


def rel_gap(got, want):
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_port_in_float32(name):
    """In float32 the port and the reference differ by summation order."""
    cfg, fam, w, toks = setup(name, "float32")
    with torch.no_grad():
        got = fam.program(cfg, "cpu").apply(w, toks)[0]
        want = ref.reference_logits(cfg, w, toks)
    assert got.shape == want.shape
    assert rel_gap(got, want) < 1e-5


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("policy", [None, "bf16"])
def test_reference_matches_port_in_bf16(name, policy):
    """bf16 activations (native, or under the emulating policy) stay
    within 4 * 2^-8 of the float32 reference's largest logit."""
    from repro_torch.models.numerics import EmulatedPolicy
    cfg, fam, w, toks = setup(name, "bfloat16")
    pol = EmulatedPolicy(policy, "fused") if policy else None
    with torch.no_grad():
        got = fam.program(cfg, "cpu").apply(w, toks, policy=pol)[0]
        want = ref.reference_logits(cfg, w, toks)
    assert rel_gap(got, want) < 4 * 2**-8


def test_rows_pick_positions():
    cfg, fam, w, toks = setup(CELLS[1], "float32")
    rows = torch.tensor([3, 17, 39])
    full = ref.reference_logits(cfg, w, toks)
    assert torch.equal(ref.reference_logits(cfg, w, toks, rows=rows),
                       full[:, rows])


def test_fp8_control_departs():
    """The lower-precision control moves the logits well beyond bf16."""
    cfg, fam, w, toks = setup(CELLS[0], "bfloat16")
    want = ref.reference_logits(cfg, w, toks)
    assert rel_gap(ref.reference_logits(cfg, w, toks, fp8=True), want) > 0.05


def test_weights_deterministic_per_seed():
    cfg, fam, w, _ = setup(CELLS[0], "bfloat16")
    again = fam.make_weights(cfg, 2**31 + 7, "cpu")
    other = fam.make_weights(cfg, 2**31 + 8, "cpu")
    assert torch.equal(w["layers"]["wq"], again["layers"]["wq"])
    assert not torch.equal(w["layers"]["wq"], other["layers"]["wq"])
    assert w["layers"]["wq"].dtype == torch.bfloat16
