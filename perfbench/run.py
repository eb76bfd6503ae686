"""Run one benchmark cell on the card and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with its limit); the checks are also the last lines of standard
error.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics from a profiled run.  Exits non-zero, with no result
line, without a CUDA device (or fewer than the cell asks for), or if the
JAX package or JAX was loaded.  The port builds its kernels once into
``build/kernels/`` of the checkout and keeps no other cache.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness
    cell = harness.resolve_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = power_limit()
    print(f"perfbench: {cell.name} seed {args.seed} on {smi}",
          file=sys.stderr, flush=True)
    out = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                          device, T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    if args.trace:
        metrics = harness.per_layer_metrics(cell, out.record)
    else:
        metrics = harness.end_to_end_metrics(cell, out.metrics)
    result = {
        "correct": out.correct, "attempted": out.attempted,
        "failed": out.failed, "metrics": metrics,
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips,
                   "memory_peak_bytes": out.memory_peak_bytes,
                   "power": smi}}
    prof = out.record.get("profile")
    if args.trace and prof:
        print(f"perfbench: profiler start-up {prof['start_s']:.3f} s, "
              f"reduction {prof['reduce_s']:.3f} s", file=sys.stderr)
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = harness.checks_line(out.checks)
    for name, (value, limit) in out.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
