"""The port's dry run (``launch/dryrun.py``) and hillclimb
(``launch/hillclimb.py``) against the JAX package's, on reduced cells.

The JAX side runs in one subprocess with 8 forced host devices on a (2, 4)
mesh of Auto axes, ``get_config`` and ``SHAPES`` patched in
``repro.launch.specs`` so that its ``make_cell`` builds the reduced cells;
each cell is lowered and compiled as the JAX driver does and its HLO
counted by ``analyze_hlo``.  The port runs the same cells on a fake world
of 8 ranks at (data=2, model=4), counted by ``roofline.op_cost``.

Per-device flops agree within 2%, the JAX package's tolerance for its own
analyzer (tests/test_roofline.py), for reduced tinyllama with 2 kv heads
(train, prefill, decode; exact for prefill and decode), deepseek-moe train
and falcon-mamba decode.  One gap is traced and stated: the JAX package's
prefill of the ssm and hybrid families runs a second, stateful pass over
the mamba layers for the decode states (``_prefill_ssm_states``), which
the port takes from the first pass (the same numbers without an emulating
policy), so zamba2's JAX count is the port's plus that pass: per layer
in_proj, out_proj and the scan's readout at their local shapes.  Traffic
and collective bytes differ by construction (an eager port, another
partitioner) and are not compared.

Also: ``model_flops`` equal, the rows carry the JAX rows' keys, the port's
``measured_utilizations`` and ``profile_from_config`` read the port's rows,
``fused_model.scoped_traffic`` on ``flash_attention_trainable``'s gradient
at tests/test_ssm_kernel.py's shapes, and one ``hillclimb.measure`` row.
"""
import concurrent.futures
import dataclasses
import json
import multiprocessing

import numpy as np
import pytest
import torch

from helpers import run_multidevice
import test_torch_dist_ranks as ranks
from repro_torch.configs.base import get_config
from repro_torch.core.energy_model import calibrate
from repro_torch.models.flash_vjp import flash_attention_trainable
from repro_torch.roofline import fused_model
from repro_torch.roofline.analysis import measured_utilizations
from repro_torch.roofline.op_cost import count

CELLS = {
    "tinyllama/prefill": ["tinyllama-1.1b", "prefill", ranks.UNEVEN, 32, 8],
    "tinyllama/decode": ["tinyllama-1.1b", "decode", ranks.UNEVEN, 32, 8],
    "tinyllama/train": ["tinyllama-1.1b", "train", ranks.UNEVEN, 32, 8],
    "deepseek-moe/train": ["deepseek-moe-16b", "train", {}, 32, 8],
    "falcon-mamba/decode": ["falcon-mamba-7b", "decode", {}, 32, 8],
    "zamba2/prefill": ["zamba2-1.2b", "prefill", {}, 32, 8],
}
#: the JAX dry run's row keys (src/repro/launch/dryrun.py)
JAX_ROW_KEYS = {
    "arch", "shape", "mesh", "chips", "flops_per_device", "bytes_per_device",
    "collective_bytes_per_device", "collective_breakdown", "model_flops",
    "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
    "useful_flop_ratio", "roofline_fraction", "kind", "fpu_unit",
    "chip_energy", "memory", "bytes_per_device_hbm", "lower_s", "compile_s",
    "status"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes"}

_JAX = """
import dataclasses, json
import jax
from jax.sharding import AxisType
import repro.launch.specs as specs
from repro.configs.base import ShapeSpec, get_config
from repro.parallel import sharding as sh
from repro.roofline.analysis import model_flops_estimate
from repro.roofline.hlo_parse import analyze_hlo

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
ctx = sh.make_context(mesh)
out = {}
for key, (arch, kind, over, seq, batch) in CELLS.items():
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    shape = ShapeSpec(kind, seq, batch, kind)
    specs.get_config = lambda a, cfg=cfg: cfg
    specs.SHAPES = {kind: shape}
    with sh.use_mesh(ctx):
        cell = specs.make_cell(arch, kind, ctx)
        donate = (0,) if cell.kind == "train" else \\
            ((1,) if cell.kind == "decode" else ())
        compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                           donate_argnums=donate).lower(
            *cell.arg_shapes).compile()
    cost = analyze_hlo(compiled.as_text())
    out[key] = dict(flops=cost.flops, traffic=cost.traffic_bytes,
                    collectives=cost.collective_bytes,
                    model_flops=model_flops_estimate(cfg, shape))
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    """(the JAX counts, the port's rows, the port's hillclimb row)."""
    tech = calibrate(device="cpu")
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ThreadPoolExecutor(1) as threads, \
            concurrent.futures.ProcessPoolExecutor(
                1, mp_context=ctx, max_tasks_per_child=1) as procs:
        jax_side = threads.submit(run_multidevice,
                                  f"CELLS = {CELLS!r}\n" + _JAX, 8)
        rows, climb = procs.submit(ranks.fake_dryrun_rows, CELLS,
                                   tech.values).result(timeout=400)
        ref = json.loads(jax_side.result().split("JSON", 1)[1])
    return ref, rows, climb


def _second_pass_flops(arch):
    """Per-device flops of one pass over the reduced config's mamba layers
    at the cells' (seq 32, batch 8) on (2, 4): in_proj, out_proj and the
    scan's readout at their local shapes (Mamba-2)."""
    cfg = get_config(arch).reduced()
    tokens = 32 * 8 // 2
    d, d_in, n = cfg.d_model, cfg.ssm_expand * cfg.d_model, 4
    heads = d_in // cfg.ssm_head_dim
    cols = (2 * d_in + 2 * cfg.ssm_state + heads) // n
    per_layer = (2 * tokens * d * cols + 2 * tokens * (d_in // n) * d
                 + 2 * tokens * (d_in // n) * cfg.ssm_state)
    return cfg.n_layers * per_layer


@pytest.mark.parametrize("cell", list(CELLS))
def test_flops_per_device_match_analyze_hlo(runs, cell):
    ref, rows, _ = runs
    port = rows[cell]["flops_per_device"]
    want = ref[cell]["flops"]
    if cell == "zamba2/prefill":  # the JAX prefill's second pass
        port += _second_pass_flops("zamba2-1.2b")
    assert abs(port / want - 1) < 0.02, (port, want)


def test_prefill_and_decode_flops_are_exact(runs):
    ref, rows, _ = runs
    for cell in ("tinyllama/prefill", "tinyllama/decode",
                 "falcon-mamba/decode"):
        assert rows[cell]["flops_per_device"] == ref[cell]["flops"], cell
    # the quoted readings
    assert ref["tinyllama/prefill"]["flops"] == 5_275_648
    assert ref["tinyllama/decode"]["flops"] == 196_608


@pytest.mark.parametrize("cell", list(CELLS))
def test_model_flops_equal(runs, cell):
    ref, rows, _ = runs
    assert rows[cell]["model_flops"] == ref[cell]["model_flops"]


def test_traffic_and_collectives_differ_by_construction(runs):
    """The port's eager traffic and DTensor's collectives against XLA's
    fused traffic and GSPMD's schedule, for reduced tinyllama's prefill
    (printed with ``-s``): the same order of magnitude, other kinds and
    sizes (neither is compared cell by cell)."""
    ref, rows, _ = runs
    port, xla = rows["tinyllama/prefill"], ref["tinyllama/prefill"]
    print("traffic bytes per device: port", port["bytes_per_device"],
          "XLA", xla["traffic"])
    print("collective bytes per device: port", port["collective_breakdown"],
          "XLA", xla["collectives"])
    assert 0.1 < port["bytes_per_device"] / xla["traffic"] < 10
    kinds = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute"}
    assert set(port["collective_breakdown"]) <= kinds
    assert set(xla["collectives"]) <= kinds
    assert port["collective_breakdown"] != {
        k: int(v) for k, v in xla["collectives"].items()}


def test_rows_carry_the_jax_keys(runs):
    _, rows, _ = runs
    for cell, row in rows.items():
        assert JAX_ROW_KEYS <= set(row), cell
        assert set(row["memory"]) == MEMORY_KEYS, cell
        assert row["status"] == "ok"
        assert row["chips"] == 8 and row["mesh"] == "data2xmodel4"
        assert row["bytes_per_device_hbm"] == (
            row["memory"]["argument_size_in_bytes"]
            + row["memory"]["temp_size_in_bytes"])
        assert row["chip_energy"]["unit"] == row["fpu_unit"]
        assert row["counted_depths"] == [row["n_layers"]]
    # the decode cache and the train state are donated
    assert rows["tinyllama/decode"]["memory"]["alias_size_in_bytes"] > 0
    assert rows["tinyllama/prefill"]["memory"]["alias_size_in_bytes"] == 0


def test_measured_utilizations_read_the_port_rows(runs, tmp_path):
    from repro_torch.core.autotune import profile_from_config
    _, rows, _ = runs
    train, decode = rows["tinyllama/train"], rows["tinyllama/decode"]
    (tmp_path / "dryrun_pod16x16.json").write_text(json.dumps({
        "tinyllama-1.1b|train_4k": train,
        "tinyllama-1.1b|decode_32k": decode,
        "zamba2-1.2b|train_4k": {"status": "FAIL: x"}}))
    got = measured_utilizations(str(tmp_path))
    assert got == {("tinyllama-1.1b", "train_4k"): train["roofline_fraction"],
                   ("tinyllama-1.1b", "decode_32k"):
                       decode["roofline_fraction"]}
    prof = profile_from_config("tinyllama-1.1b", "train_4k",
                               results_dir=str(tmp_path))
    assert prof.activity == float(np.clip(train["roofline_fraction"],
                                          0.01, 1.0))


def test_hillclimb_row(runs):
    _, rows, climb = runs
    assert climb["microbatches"] == 2 and climb["label"] == "mb2"
    for key in ("t_compute", "t_memory", "t_collective", "bottleneck",
                "roofline_fraction", "t_memory_fused",
                "roofline_fraction_fused", "removed_gb", "hbm_gb",
                "fits_h100_80gb"):
        assert key in climb, key
    # the fused term takes the flash scopes' traffic out
    assert climb["removed_gb"] > 0
    assert climb["t_memory_fused"] < climb["t_memory"]
    assert climb["fits_h100_80gb"] is True
    # twice the microbatches: the same model flops
    assert climb["roofline_fraction"] > 0


def test_scoped_traffic_of_the_flash_gradient():
    """tests/test_ssm_kernel.py's test_fused_traffic_model_attribution on
    the port: the flash scopes of the forward and the backward hold
    traffic, and the interface estimate is below it."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 128, 4, 16), generator=gen, requires_grad=True)
    k = torch.randn((2, 128, 2, 16), generator=gen, requires_grad=True)
    v = torch.randn((2, 128, 2, 16), generator=gen, requires_grad=True)

    def grads():
        out = flash_attention_trainable(q, k, v, block_q=32, block_k=32)
        loss = torch.sum(out.to(torch.float32) ** 2)
        return torch.autograd.grad(loss, (q, k, v))

    _, cost = count(grads)
    info = fused_model.scoped_traffic(cost)
    scoped = info["scoped"]["flash_attention_kernel"]
    assert scoped > 0
    assert info["interface"]["flash_attention_kernel"] < scoped
    assert info["scoped"]["selective_scan_kernel"] == 0
    # the backward opens its own scope: the forward's alone holds less
    with torch.no_grad():
        _, fwd = count(flash_attention_trainable, q, k, v, block_q=32,
                       block_k=32)
    assert 0 < fwd.scope_traffic["flash_attention_kernel"] < scoped
