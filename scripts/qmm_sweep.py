#!/usr/bin/env python3
"""K1 (``csrc/qmm.cu``) at tinyllama-1.1b's and starcoder2-7b's projection
shapes under schedules, row tiles and planner thresholds other than
``plan_qmm``'s defaults: the readings that ``WHOLE_MIN_FILL``,
``TILE_ROWS`` and ``SPLIT_WAVES`` rest on.  Needs one
CUDA card and ``nvcc``; imports no JAX.

    PYTHONPATH=src python scripts/qmm_sweep.py [--parts decode,host,prefill]
        [--parent DIR] [--tag NAME] [--out FILE]

One JSON line per reading:
  - ``decode``: one decode forward (155 launches at M=4, the unembed once)
    in bf16 and fp8_e4m3, fused, for ``SPLIT_WAVES`` in 1, 2 and 4; each
    timed as ``chip_smoke.py`` times (L2 flushed before each call, median
    of 10) and again with a spin kernel on the card ahead of each call, so
    that host dispatch cannot show in the time;
  - ``host``: the host's time per K1 call and per library call
    (``torch.matmul(a.float(), b.float())``) at wk's decode shape, from 200
    calls enqueued back to back;
  - ``prefill``: tinyllama's projections at M=512 (and K3's bf16 cascade at
    wq's shape), and wq, w_gate and w_down at M = 1024, 2048 and 4096, on
    whole and split_tile with each row tile (128 and 64) forced; and
    starcoder2-7b's five shapes at M = 4096 (its eval cell's) on whole with
    each row tile; each with the tile grid's fill, the plan the defaults
    pick, and whether every output is bitwise equal to the first.
``--parent`` names a ``csrc`` directory of an earlier checkout whose
``qmm.cu`` takes the 64-row tile only: its build (on the default plan's
schedule) and this build's default plan are timed beside each prefill
reading, in turns (parent, this build, this build, parent).  The card's
name and power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# a spin of this many cycles (~0.2 ms) ahead of a timed call
SPIN_CYCLES = 400_000


def time_ms(fn, flush, spin, reps=10, warm=2):
    """Median time of ``fn`` over ``reps`` calls between CUDA events, the
    L2 flushed before each; with ``spin`` a sleep kernel holds the card
    while the host enqueues the call."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def build_parent(src, like):
    """Build an earlier ``qmm.cu`` into its own library; returns a stand-in
    for ``fused._entry`` that gives its entry point, typed as ``like``."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "qmm_sweep" / "libparent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-o", str(out), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(out)).repro_fused_qmm
    fn.argtypes, fn.restype = like.argtypes, like.restype
    return lambda: fn


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parts", default="decode,host,prefill",
                        help="comma list of the readings to take")
    parser.add_argument("--parent", help="csrc directory of an earlier "
                        "qmm.cu, timed beside each prefill reading")
    parser.add_argument("--tag", default="", help="label of every line")
    parser.add_argument("--out", help="also append the lines to this file")
    args = parser.parse_args()
    parts = set(args.parts.split(","))
    if not torch.cuda.is_available():
        print("qmm_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # model_shapes, qmm_operands
    from repro_torch.configs.base import get_config
    from repro_torch.core import formats as F
    from repro_torch.kernels import fused
    from repro_torch.kernels.fma_emu import fma_emu_matmul

    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps({"tag": args.tag, **rec})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    emit({"what": "card", "card": smi})
    cfg = get_config(cs.ARCH)
    shapes = cs.model_shapes(cfg)
    sms = fused.sm_count(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 1)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    whole_min, split_waves = fused.WHOLE_MIN_FILL, fused.SPLIT_WAVES

    this_entry = fused._entry

    # decode: one forward's launches under each SPLIT_WAVES
    ops = {name: cs.qmm_operands(gen, 4, k, n, dev, name == "unembed")
           for name, (k, n) in shapes.items()}
    if "decode" in parts:
        reps = {name: 1 if name == "unembed" else cfg.n_layers
                for name in shapes}
        for fmt in (F.BF16, F.FP8_E4M3):
            for waves in (1.0, 2.0, 4.0):
                fused.SPLIT_WAVES = waves
                for spin in (False, True):
                    per = {name: time_ms(
                        lambda: fused.fused_qmm(a, b, fmt=fmt), flush, spin)
                        for name, (a, b) in ops.items()}
                    emit({"what": "decode", "m": 4, "fmt": fmt.name,
                          "style": "fused", "split_waves": waves,
                          "spin": spin,
                          "forward_ms": sum(reps[n] * per[n] for n in per),
                          "per_launch_ms": per,
                          "bn": {name: fused.plan_qmm(1, 4, n, k, sms).bn
                                 for name, (k, n) in shapes.items()}})
        fused.SPLIT_WAVES = split_waves

    # host: calls enqueued back to back, the card kept busy ahead of them
    if "host" in parts:
        a, b = ops["wk"]
        for what, fn in (("fused_qmm", lambda: fused.fused_qmm(a, b,
                                                               fmt=F.BF16)),
                         ("library", lambda: torch.matmul(a.float(),
                                                          b.float()))):
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(50 * SPIN_CYCLES)
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            emit({"what": "host", "call": what, "m": 4, "weight": "wk",
                  "us_per_call": host_us})

    # prefill: whole against split_tile on each row tile
    cases = [(512, name, "fused", fused.fused_qmm, shapes)
             for name in shapes if name != "unembed"]
    cases += [(512, "wq", "cascade", fma_emu_matmul, shapes)]
    cases += [(m, name, "fused", fused.fused_qmm, shapes)
              for m in (1024, 2048, 4096)
              for name in ("wq", "w_gate", "w_down")]
    eval_shapes = cs.model_shapes(get_config("starcoder2-7b"))
    cases += [(4096, name, "fused", fused.fused_qmm, eval_shapes)
              for name in ("wq", "wk", "w_up", "w_down", "unembed")]
    if "prefill" not in parts:
        cases = []
    tile_rows = fused.TILE_ROWS
    per_sm = dict(tile_rows)

    def forced(schedule, bm):
        """Set the planner so that it picks ``schedule`` on ``bm`` rows."""
        fused.WHOLE_MIN_FILL = 0.0 if schedule == "whole" else math.inf
        fused.TILE_ROWS = ((bm, per_sm[bm]),)

    def restore():
        fused.WHOLE_MIN_FILL = whole_min
        fused.TILE_ROWS = tile_rows

    parent = None
    if args.parent and cases:
        parent = build_parent(Path(args.parent) / "qmm.cu", this_entry())
    for m, name, style, fn, table in cases:
        k, n = table[name]
        unembed = name == "unembed"
        a, b = cs.qmm_operands(gen, m, k, n, dev, unembed)
        default = fused.plan_qmm(1, m, n, k, sms)
        run = lambda: fn(a, b, fmt=F.BF16, style=style)  # noqa: E731
        variants = [(sch, bm) for sch in ("whole", "split_tile")
                    for bm, _ in tile_rows]
        if table is eval_shapes:  # the planner keeps whole k at M = 4096
            variants = [v for v in variants if v[0] == "whole"]
        ms, outs = {}, {}
        for schedule, bm in variants:
            forced(schedule, bm)
            plan = fused.plan_qmm(1, m, n, k, sms)
            assert (plan.schedule, plan.bm) == (schedule, bm)
            key = f"{schedule}_{bm}"
            outs[key] = run()
            ms[key] = time_ms(run, flush, False)
        restore()
        if parent is not None:
            # the parent's kernel on 64-row tiles and the default plan's
            # schedule (its own planner's at these shapes), this build on
            # the default plan
            times = {"parent": [], "default": []}
            for which in ("parent", "default", "default", "parent"):
                if which == "parent":
                    forced(default.schedule, 64)
                fused._entry = parent if which == "parent" else this_entry
                times[which].append(time_ms(run, flush, False))
                if which == "parent":
                    outs["parent"] = run()
                fused._entry = this_entry
                restore()
            ms.update(times)
        first = next(iter(outs.values()))
        fills = {bm: fused.tile_fill(-(-m // bm) * -(-n // 128), sms, ps)
                 for bm, ps in tile_rows}
        emit({"what": "prefill", "m": m, "k": k, "n": n, "weight": name,
              "model": "starcoder2-7b" if table is eval_shapes
              else cs.ARCH, "style": style, "fill": fills,
              "default": [default.schedule, default.bm], "ms": ms,
              "equal": all(torch.equal(o, first) for o in outs.values())})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
