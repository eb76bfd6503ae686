"""What a run loads: nothing whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package; ``repro_torch`` is the port and
another name), and a reference that loads nothing of the port."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def imported_tops(path: Path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        bad = imported_tops(path) & set(harness.FORBIDDEN_MODULES)
        assert not bad, f"{path} imports {bad}"


def test_forbidden_names_compare_whole():
    assert harness.FORBIDDEN_MODULES == ("jax", "jaxlib", "flax", "repro")
    sys.modules.setdefault("repro_torch_lookalike_for_test", sys)
    try:
        assert "repro_torch_lookalike_for_test" not in \
            harness.forbidden_loaded()
    finally:
        sys.modules.pop("repro_torch_lookalike_for_test", None)


def run_py(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)


def test_a_cpu_run_of_each_cell_loads_nothing_forbidden():
    code = """
import json, sys, time, torch
sys.path.insert(0, 'perfbench/tests')
from conftest import tiny
from perfbench import harness
for w in json.load(open('BENCHMARK.json'))['workloads']:
    name = w['name']
    cell = tiny(harness.resolve_cell(name))
    out = harness.execute(cell, 1, 0.2, True, torch.device('cpu'),
                          time.perf_counter())
    harness.per_layer_metrics(cell, out.record)
print(json.dumps(harness.forbidden_loaded()))
"""
    res = run_py(code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_the_reference_loads_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert not imported_tops(path) & {"repro_torch", "repro", "jax"}
    res = run_py("import sys, perfbench.reference.dense; print(sorted("
                 "m for m in sys.modules if m.split('.')[0].startswith("
                 "'repro')))")
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "[]"


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "starcoder2-7b.emulated_eval", "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300)
    assert res.returncode != 0
    assert '"correct"' not in res.stdout


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "chatglm3-6b.serve_longprompt", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        timeout=300)
    assert res.returncode != 0
    assert '"correct"' not in res.stdout
