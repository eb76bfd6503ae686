"""Each cell once on the card through ``run.py``, with a short window:
the result line's keys, ``correct`` and the device.  Needs a CUDA device:

    python -m pytest -q -m cuda perfbench/tests/test_card.py
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("name,trace,seconds", [
    ("starcoder2-7b.emulated_eval", 0, 3),
    ("starcoder2-7b.emulated_eval", 1, 3),
    ("chatglm3-6b.emulated_eval", 0, 3),
    # a serving window checks the requests that finish in it: its first
    # step (~3 s) finishes none, so it needs a few
    ("chatglm3-6b.serve_longprompt", 0, 12)])
def test_cell_on_the_card(name, trace, seconds):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         str(2**31 + 77), "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
