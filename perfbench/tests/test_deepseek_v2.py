"""The DeepSeek-V2 family through the serving driver at a tiny size: a
sound run comes out correct, a run whose decode alters a served token
comes out not correct (``test_faults.py``'s ``serve_altered``), and the
family's counts are the hand sums; on the card, the cell once through
``run.py`` (``test_card.py``'s check):

    python -m pytest -q -m cuda perfbench/tests/test_deepseek_v2.py
"""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import test_card
from perfbench.tests.test_faults import serve_altered
from repro_torch.models.model import LM

CELL = "deepseek-v2-lite.serve_longprompt"
#: the MLA and expert widths cut with the rest (``conftest.tiny`` cuts the
#: keys the dense family shares)
TINY_MLA = {"kv_lora_rank": 32, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 16, "v_head_dim": 16, "n_routed_experts": 8,
            "num_experts_per_tok": 2, "n_shared_experts": 1,
            "moe_intermediate_size": 32}


@pytest.fixture
def cell(tiny_cell):
    c = tiny_cell(CELL)
    return dataclasses.replace(c, config={**c.config, **TINY_MLA})


def run(cell, seed=2**31 + 29):
    return harness.execute(cell, seed, 1.0, False, torch.device("cpu"),
                           time.perf_counter())


def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out.correct, out.checks
    assert out.failed == 0 and out.attempted > 0
    assert out.record["decoded_tokens"] > 0


def test_altered_token_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(LM, "decode_scan", serve_altered(LM.decode_scan))
    out = run(cell)
    assert not out.correct, out.checks


def test_counts_by_hand():
    cfg = harness.resolve_cell(CELL).config
    fam = harness.family(cfg)
    assert fam.matmul_params(cfg) == 2_451_308_544
    assert fam.model_flops(cfg, 3, 5) == 2.0 * 2_451_308_544 * 3 \
        + (2 * 16 * 192 + 2 * 16 * 128) * 27 * 5
    assert not hasattr(fam, "k1_forward_bound_s")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(trace):
    test_card.test_cell_on_the_card(CELL, trace, 12)
