"""CPU tests of the benchmark at a size a test run holds.

``tiny_cell`` builds a cell from the benchmark's own files with the
configuration cut to a few small layers and the traffic to short
sequences; the drivers then run on the CPU (no look for a card), K1's
plain version standing in for the kernel.
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: the tiny widths the tests run at (the cells run the published ones)
TINY = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "head_dim": 16, "intermediate_size": 96, "vocab_size": 256}
TINY_TRAFFIC = {
    "emulated_eval": {"batch": 2, "seq_len": 24},
    "serve_longprompt": {
        "clients": 6, "slots": 4, "dispatch_tokens": 4, "block": 6,
        "prompt_len": {"dist": "loguniform", "lo": 5, "hi": 40},
        "output_len": {"dist": "uniform", "lo": 3, "hi": 9},
        "warmup_steps": 2, "check_tokens": 1000},
}


def tiny(cell):
    """``cell`` (a ``harness.Cell``) cut to the test size."""
    cell = copy.deepcopy(cell)
    kv = cell.config["num_key_value_heads"] * 4 \
        // cell.config["num_attention_heads"]
    cell.config.update(TINY, num_key_value_heads=max(kv, 1))
    for name, over in TINY_TRAFFIC.items():
        if cell.name.endswith("." + name):
            cell.traffic.update(copy.deepcopy(over))
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads a test: under several test workers more threads only
    contend, and a serving window then finishes few requests."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def tiny_cell():
    from perfbench import harness
    return lambda name: tiny(harness.resolve_cell(name))
