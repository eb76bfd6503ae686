"""Multi-pod dry run: every (arch x shape x mesh) cell's step counted on a
fake world of 256 or 512 ranks (counterpart of ``repro.launch.dryrun``).

Run it as a module, in a process of its own: it makes the process rank 0
of a fake process group (``launch.mesh.fake_world``), which stands in for
the JAX driver's forced host-device count, and a process has one default
group.

Per cell: ``launch.specs.make_cell`` builds the step and its arguments'
shapes and shardings; each argument is placed as a DTensor from a ``meta``
stand-in of its local shard (``DTensor.from_local``: no scatter, no
memory); the step runs once, eagerly, under ``roofline.op_cost.count``,
which counts each rank's flops, traffic and collective bytes at its local
shapes; and the row records the ``RooflineReport``, the chip unit the
cell's phase routes to with its body-bias energy telemetry
(``ChipPolicy.step_energy_telemetry``), and the per-device memory under
``memory_analysis()``'s keys:

  * ``argument_size_in_bytes``: the local bytes of the step's arguments;
  * ``output_size_in_bytes``: the local bytes of its results;
  * ``temp_size_in_bytes``: the most bytes the step's own allocations held
    at once (``OpCost.peak_live_bytes``);
  * ``alias_size_in_bytes``: the local bytes of the donated argument (the
    train state, the decode cache), as the JAX driver donates them.  The
    decode step writes the cache in place; the train step builds a new
    state, so its temporaries hold both.

``lower_s`` is the seconds spent building the cell and placing its
stand-ins, ``compile_s`` the seconds of the counted run (the JAX driver's
lowering and compilation have no counterpart in an eager port).

A cell may be counted at a reduced depth (``--depth`` d, 3 by default) and
extrapolated to the config's ``n_layers``: from the third layer on each
layer adds the same counts, so the row is the count at depth d plus
(n_layers - d) times the difference between the counts at depths d + 1 and
d.  ``tests/test_torch_op_cost.py`` shows for each family that this equals
the count at full depth; the hybrid is counted at full depth.  The row
says at what depths it was counted (``counted_depths``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
      --shape train_4k --depth 0
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.specs import make_cell
from repro_torch.parallel import sharding as sh
from repro_torch.roofline import op_cost
from repro_torch.roofline.analysis import analyze
from repro_torch.train import tree as tree_util

# Per-arch gradient-accumulation defaults, kept as the JAX driver's table:
# it was sized so that the remat carries and optimizer state fit a 16 GB
# TPU chip, and stays here only as the same cells' defaults.
MICROBATCHES = {
    "falcon-mamba-7b": 1,
    "deepseek-67b": 4,
    "chatglm3-6b": 4,
    "starcoder2-7b": 4,
    "mixtral-8x7b": 4,
}
MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}
#: the default counted depth: from the third layer on, each layer's count
#: is the same (tests/test_torch_op_cost.py)
DEPTH = 3


def depths(cfg, depth: int):
    """The depths a cell is counted at: ``depth`` and ``depth + 1``, to
    extrapolate to ``n_layers``, or ``n_layers`` alone (``depth`` 0, a
    stack no deeper, or the hybrid, whose segments of
    ``shared_attn_every`` layers leave little to save).  The first layers
    meet other layouts than the steady ones (the embedding's, the
    optimizer's stacks of one or two layers), so ``depth`` should be at
    least ``DEPTH``."""
    n = cfg.n_layers
    if not depth or depth + 1 >= n or cfg.family == "hybrid":
        return (n,)
    return (depth, depth + 1)


def place(tree, shardings, device="meta"):
    """Each leaf of a ``meta`` tree as a DTensor on its sharding, built from
    a stand-in of this rank's local shard: ``meta``, or zeros on
    ``device``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def one(t, s):
        pl = s.placements
        local, _ = compute_local_shape_and_global_offset(t.shape, s.mesh, pl)
        return DTensor.from_local(
            torch.zeros(local, dtype=t.dtype, device=device), s.mesh, pl,
            run_check=False, shape=t.shape, stride=t.stride())

    return tree_util.map(one, tree, shardings)


def _local_bytes(tree) -> int:
    out = 0
    for t in tree_util.leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if sh.is_dtensor(t) else t
            out += t.numel() * t.element_size()
    return out


def count_cell(arch, shape_name, mesh, *, cfg=None, shape=None,
               microbatches: int = 1, triangle_skip: bool = False,
               chip_policy=None, device="meta"):
    """(cell, OpCost, memory dict, lower_s, compile_s) of one cell run on
    ``mesh`` from meta stand-ins (or from zeros on ``device``, a check that
    the counts do not depend on the stand-ins)."""
    ctx = sh.make_context(mesh)
    t0 = time.perf_counter()
    with sh.use_mesh(ctx):
        cell = make_cell(arch, shape_name, ctx, cfg=cfg, shape=shape,
                         microbatches=microbatches,
                         triangle_skip=triangle_skip,
                         chip_policy=chip_policy,
                         device=None if device == "meta" else device)
        args = [place(a, s, device) for a, s in zip(cell.arg_shapes,
                                                    cell.in_shardings)]
        arg_bytes = _local_bytes(args)
        donated = {"train": 0, "decode": 1}.get(cell.kind)
        alias = 0 if donated is None else _local_bytes(args[donated])
        t1 = time.perf_counter()
        out, cost = op_cost.count(cell.fn, *args)
        t2 = time.perf_counter()
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": _local_bytes(out),
           "temp_size_in_bytes": int(cost.peak_live_bytes),
           "alias_size_in_bytes": alias}
    return cell, cost, mem, t1 - t0, t2 - t1


def _extrapolate(counts, n):
    """The count at depth ``n`` from counts at two depths (linear in the
    depth), or the one count."""
    if len(counts) == 1:
        return counts[0][1]
    (d1, c1), (d2, c2) = counts
    f = (n - d1) / (d2 - d1)
    out = op_cost.OpCost()
    for c, times in ((c1, 1.0 - f), (c2, f)):
        out.add(c, times)
    return out


def _extrapolate_memory(mems, n):
    """Each memory figure at depth ``n``, linear in the depth as the
    counts are."""
    if len(mems) == 1:
        return mems[0][1]
    (d1, m1), (d2, m2) = mems
    return {k: int(round(m1[k] + (m2[k] - m1[k]) * (n - d1) / (d2 - d1)))
            for k in m1}


def run_cell(arch: str, shape_name: str, **kw):
    """One dry-run row (``cell_row``'s keywords)."""
    return cell_row(arch, shape_name, **kw)[0]


def cell_row(arch: str, shape_name: str, *, multi_pod: bool = False,
             microbatches: Optional[int] = None, triangle_skip: bool = False,
             verbose: bool = True, depth: int = DEPTH, device=None,
             tech=None, mesh=None, cfg=None, shape=None):
    """(the dry-run row, its ``OpCost``).  ``mesh``: the production mesh by
    default (the process must be rank 0 of a fake world of its size);
    ``cfg`` and ``shape`` override the registry's; ``depth`` is the
    counted depth (0: full); ``device`` is where the chip policy's
    telemetry runs (the card by default) and ``tech`` its calibration
    (calibrated once per process when None)."""
    from repro_torch.core.chip import default_policy
    if microbatches is None:
        microbatches = MICROBATCHES.get(arch, 4)
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        mesh_name = MESH_NAMES[multi_pod]
    else:
        mesh_name = "x".join(f"{a}{n}" for a, n in
                             sh.mesh_axes(mesh).items())
    chips = mesh.size()
    chip_policy = default_policy(cfg.numerics_precision, params=tech,
                                 device=device)
    counts, lower_s, compile_s = [], 0.0, 0.0
    for d in depths(cfg, depth):
        cell, cost, mem, lo, co = count_cell(
            arch, shape_name, mesh,
            cfg=dataclasses.replace(cfg, n_layers=d), shape=shape,
            microbatches=microbatches, triangle_skip=triangle_skip,
            chip_policy=chip_policy)
        counts.append((d, cost, mem))
        lower_s += lo
        compile_s += co
    cost = _extrapolate([(d, c) for d, c, _ in counts], cfg.n_layers)
    mem = _extrapolate_memory([(d, m) for d, _, m in counts], cfg.n_layers)
    report = analyze(arch, shape_name, mesh_name, chips, cost, cfg, shape)
    energy = chip_policy.step_energy_telemetry(
        shape.kind, achieved_flops=report.model_flops,
        step_time_s=report.step_time_bound_s,
        peak_flops=report.chips * report.peak_flops,
        precision=cfg.numerics_precision)
    row = report.as_dict()
    row.update({
        "kind": cell.kind,
        "fpu_unit": cell.unit,
        "chip_energy": energy,
        "memory": mem,
        "bytes_per_device_hbm": (mem["argument_size_in_bytes"]
                                 + mem["temp_size_in_bytes"]),
        "counted_depths": [d for d, _, _ in counts],
        "n_layers": cfg.n_layers,
        "lower_s": round(lower_s, 1),
        "compile_s": round(compile_s, 1),
        "status": "ok",
    })
    if verbose:
        print(f"[{mesh_name}] {arch} x {shape_name}: OK "
              f"(lower {lower_s:.0f}s count {compile_s:.0f}s at depths "
              f"{row['counted_depths']}, bottleneck={row['bottleneck']}, "
              f"roofline_frac={row['roofline_fraction']:.3f}, "
              f"unit={cell.unit})", flush=True)
        print(f"  memory: {mem}", flush=True)
        print(f"  cost: flops/dev={row['flops_per_device']:.3e} "
              f"bytes/dev={row['bytes_per_device']:.3e} "
              f"coll/dev={row['collective_bytes_per_device']:.3e}",
              flush=True)
    return row, cost


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--out", default="results")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--triangle-skip", action="store_true")
    ap.add_argument("--depth", type=int, default=DEPTH,
                    help="count at this depth and the next and extrapolate "
                         "to n_layers (0: count at full depth)")
    ap.add_argument("--device", default=None,
                    help="where the chip policy runs (default: the card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card and no --device: raise here
    if args.mesh == "both":
        return _both(argv)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    multi_pod = args.mesh == "multi"
    mesh_lib.fake_world(512 if multi_pod else 256)
    mesh_name = MESH_NAMES[multi_pod]
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"dryrun_{mesh_name}.json")
    results = {}
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    for arch in archs:
        shape_names = cells(arch)
        if args.shape:
            if args.shape not in shape_names:
                print(f"[{mesh_name}] {arch} x {args.shape}: SKIPPED "
                      f"(no sub-quadratic path)")
                continue
            shape_names = [args.shape]
        for shape_name in shape_names:
            key = f"{arch}|{shape_name}"
            if results.get(key, {}).get("status") == "ok":
                print(f"[{mesh_name}] {key}: cached")
                continue
            try:
                results[key] = run_cell(
                    arch, shape_name, multi_pod=multi_pod,
                    microbatches=args.microbatches,
                    triangle_skip=args.triangle_skip, depth=args.depth,
                    device=args.device)
            except Exception as e:  # noqa: BLE001 - record and go on
                traceback.print_exc()
                results[key] = {"status": f"FAIL: {type(e).__name__}: {e}"}
            with open(path, "w") as f:
                json.dump(results, f, indent=1)
    ok = sum(1 for v in results.values() if v.get("status") == "ok")
    print(f"{mesh_name}: {ok}/{len(results)} cells OK")
    return 0


def _both(argv) -> int:
    """Both meshes, each in a child process of its own (a fake world has
    one size), run side by side; the exit code is the first failure's."""
    import subprocess
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--mesh") if "--mesh" in argv else None
    if i is not None:
        del argv[i:i + 2]
    argv = [a for a in argv if not a.startswith("--mesh=")]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, "-m",
                               "repro_torch.launch.dryrun", "--mesh", m]
                              + argv, env=env)
             for m in ("single", "multi")]
    try:
        codes = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return next((c for c in codes if c), 0)


if __name__ == "__main__":
    raise SystemExit(main())
