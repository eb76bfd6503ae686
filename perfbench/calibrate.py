"""Read the numbers a cell compares over many seeds, and its control's, in
one process, for setting the limits in ``limits/<cell>.json``.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 20

Each seed runs the cell's driver as a benchmark run does (set-up, a window
of ``--seconds``, the check) and prints one JSON line of the numbers
compared; a control seed runs it with the lower-precision control and
prints the control's reading.  The benchmark's own runs never run the
control.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve_cell(args.workload)
    dev = torch.device("cuda", 0)
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t = time.perf_counter()
        out = harness.execute(cell, seed, args.seconds, False, dev, t,
                              control=control)
        print(json.dumps({
            "cell": cell.name, "seed": seed, "control": control,
            "checks": {k: v for k, (v, _) in out.checks.items()},
            "metrics": out.metrics, "extra": out.extra,
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
