#!/usr/bin/env python3
"""K1 (``csrc/qmm.cu``) at tinyllama-1.1b's projection shapes under
schedules and planner thresholds other than ``plan_qmm``'s defaults: the
readings that ``WHOLE_MIN_FILL`` and ``SPLIT_WAVES`` rest on.  Needs one
CUDA card and ``nvcc``; imports no JAX.

    PYTHONPATH=src python scripts/qmm_sweep.py [--tag NAME] [--out FILE]

One JSON line per reading:
  - ``decode``: one decode forward (155 launches at M=4, the unembed once)
    in bf16 and fp8_e4m3, fused, for ``SPLIT_WAVES`` in 1, 2 and 4; each
    timed as ``chip_smoke.py`` times (L2 flushed before each call, median
    of 10) and again with a spin kernel on the card ahead of each call, so
    that host dispatch cannot show in the time;
  - ``host``: the host's time per K1 call and per library call
    (``torch.matmul(a.float(), b.float())``) at wk's decode shape, from 200
    calls enqueued back to back;
  - ``prefill``: each projection at M=512 (and K3's bf16 cascade at wq's
    shape), and wq, w_gate and w_down at M = 1024, 2048 and 4096, with the
    whole-k schedule and with split_tile forced, whether the two outputs
    are bitwise equal, and the schedule the default plan picks.
The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tag", default="", help="label of every line")
    parser.add_argument("--out", help="also append the lines to this file")
    args = parser.parse_args()
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

    # decode: one forward's launches under each SPLIT_WAVES
    ops = {name: cs.qmm_operands(gen, 4, k, n, dev, name == "unembed")
           for name, (k, n) in shapes.items()}
    reps = {name: 1 if name == "unembed" else cfg.n_layers
            for name in shapes}
    for fmt in (F.BF16, F.FP8_E4M3):
        for waves in (1.0, 2.0, 4.0):
            fused.SPLIT_WAVES = waves
            for spin in (False, True):
                per = {name: time_ms(lambda: fused.fused_qmm(a, b, fmt=fmt),
                                     flush, spin)
                       for name, (a, b) in ops.items()}
                emit({"what": "decode", "m": 4, "fmt": fmt.name,
                      "style": "fused", "split_waves": waves, "spin": spin,
                      "forward_ms": sum(reps[n] * per[n] for n in per),
                      "per_launch_ms": per,
                      "bn": {name: fused.plan_qmm(1, 4, n, k, sms).bn
                             for name, (k, n) in shapes.items()}})
    fused.SPLIT_WAVES = split_waves

    # host: calls enqueued back to back, the card kept busy ahead of them
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

    # prefill: whole against split_tile
    cases = [(512, name, "fused", fused.fused_qmm) for name in shapes
             if name != "unembed"] + [(512, "wq", "cascade", fma_emu_matmul)]
    cases += [(m, name, "fused", fused.fused_qmm) for m in (1024, 2048, 4096)
              for name in ("wq", "w_gate", "w_down")]
    for m, name, style, fn in cases:
        k, n = shapes[name]
        a, b = cs.qmm_operands(gen, m, k, n, dev, False)
        default = fused.plan_qmm(1, m, n, k, sms)
        ms, outs = {}, {}
        for schedule, threshold in (("whole", 0.0), ("split_tile", math.inf)):
            fused.WHOLE_MIN_FILL = threshold
            assert fused.plan_qmm(1, m, n, k, sms).schedule == schedule
            outs[schedule] = fn(a, b, fmt=F.BF16, style=style)
            ms[schedule] = time_ms(lambda: fn(a, b, fmt=F.BF16, style=style),
                                   flush, False)
        fused.WHOLE_MIN_FILL = whole_min
        tiles = -(-m // fused.TILE_BM) * -(-n // 128)
        emit({"what": "prefill", "m": m, "k": k, "n": n, "weight": name,
              "style": style, "tiles": tiles, "waves": tiles / sms,
              "fill": fused.tile_fill(tiles, sms),
              "default": default.schedule, "ms": ms,
              "equal": torch.equal(outs["whole"], outs["split_tile"])})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
