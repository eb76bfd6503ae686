"""Perf hillclimb driver: hypothesis -> change -> re-count -> record, for
three train cells (counterpart of ``repro.launch.hillclimb``).

Each row re-runs a dry-run cell (``launch.dryrun``) on the single-pod mesh
with another microbatch count and records the three roofline terms and the
fused-kernel memory term (``roofline.fused_model``), appended to
``results/perf_iterations.json``.

Run it as a module, in a process of its own: it makes the process rank 0
of a fake world of 256 ranks (``launch.mesh.fake_world``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch._device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import DEPTH, cell_row
from repro_torch.roofline.analysis import (H100_HBM_BYTES,
                                           H100_PEAK_FLOPS_BF16)
from repro_torch.roofline.fused_model import fused_memory_term

#: (arch, shape, microbatches, label, hypothesis), the JAX driver's plan
PLAN = [
    ("deepseek-67b", "train_4k", 16, "baseline",
     "paper-faithful framework baseline"),
    ("deepseek-67b", "train_4k", 4, "mb4",
     "collective bytes ~ mb x layers x dW: 4x fewer microbatches cuts "
     "the dW all-reduce term ~4x"),
    ("deepseek-67b", "train_4k", 2, "mb2",
     "continue halving mb until memory budget binds"),
    ("mixtral-8x7b", "train_4k", 8, "baseline", ""),
    ("mixtral-8x7b", "train_4k", 4, "mb4",
     "same dW-reduce scaling as deepseek"),
    ("mixtral-8x7b", "train_4k", 2, "mb2", "knee check"),
    ("falcon-mamba-7b", "train_4k", 8, "baseline", ""),
    ("falcon-mamba-7b", "train_4k", 2, "mb2",
     "memory term dominated by per-pass state expansion; fewer "
     "microbatches reduce remat multiplicity"),
    ("falcon-mamba-7b", "train_4k", 1, "mb1", "knee check"),
]


def measure(arch: str, shape: str, *, microbatches: int, label: str,
            hypothesis: str = "", triangle_skip: bool = False,
            depth: int = DEPTH, device=None, tech=None, mesh=None, cfg=None,
            shape_spec=None):
    """One hillclimb row: the cell's roofline terms, its fused memory term,
    and whether its per-device memory fits one H100's HBM3.  ``mesh``,
    ``cfg`` and ``shape_spec`` override the single-pod mesh and the
    registry's config and shape, as ``dryrun.run_cell``'s do."""
    t0 = time.perf_counter()
    row, cost = cell_row(arch, shape, microbatches=microbatches,
                         triangle_skip=triangle_skip, verbose=False,
                         depth=depth, device=device, tech=tech, mesh=mesh,
                         cfg=cfg, shape=shape_spec)
    t_mem_fused, fused = fused_memory_term(row["bytes_per_device"], cost)
    bound_fused = max(row["t_compute_s"], t_mem_fused, row["t_collective_s"])
    peak = row["chips"] * H100_PEAK_FLOPS_BF16
    hbm = row["bytes_per_device_hbm"] / 1e9
    out = dict(
        arch=arch, shape=shape, label=label, hypothesis=hypothesis,
        microbatches=microbatches,
        t_compute=row["t_compute_s"], t_memory=row["t_memory_s"],
        t_collective=row["t_collective_s"], bottleneck=row["bottleneck"],
        roofline_fraction=row["roofline_fraction"],
        t_memory_fused=t_mem_fused,
        roofline_fraction_fused=(row["model_flops"] / (peak * bound_fused)
                                 if bound_fused else 0.0),
        removed_gb=fused["removed_bytes"] / 1e9,
        hbm_gb=hbm, counted_depths=row["counted_depths"],
        compile_s=round(time.perf_counter() - t0, 1),
        fits_h100_80gb=hbm * 1e9 <= H100_HBM_BYTES)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/perf_iterations.json")
    ap.add_argument("--depth", type=int, default=DEPTH)
    ap.add_argument("--device", default=None,
                    help="where the chip policy runs (default: the card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card and no --device: raise here
    mesh_lib.fake_world(256)
    rows = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f)
    done = {(r["arch"], r["shape"], r["label"]) for r in rows}
    for arch, shape, mb, label, hyp in PLAN:
        if (arch, shape, label) in done:
            continue
        try:
            rows.append(measure(arch, shape, microbatches=mb, label=label,
                                hypothesis=hyp, depth=args.depth,
                                device=args.device))
        except Exception as e:  # noqa: BLE001 - record and go on
            rows.append(dict(arch=arch, shape=shape, label=label,
                             error=f"{type(e).__name__}: {e}"))
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
