#!/usr/bin/env python3
"""K5/K6 (``csrc/ssm_scan.cu``) at falcon-mamba-7b layer 0's scan shape,
(2, 256, 8192, 16) f32: the committed kernel beside the kernel of an
earlier checkout, and at ring depths and rows per block other than the
committed ones.  Needs one CUDA card and ``nvcc``; imports no JAX.

    PYTHONPATH=src python scripts/scan_sweep.py [--parent DIR] \\
        [--depths 2,4,8] [--out FILE]

``--parent`` names a ``csrc`` directory whose ``ssm_scan.cu`` has the
entry point without the ``rows`` argument (the one-thread-a-row kernel it
replaced).  One JSON line per reading, the card's name and power limit
first:
  - ``parent``: K6 and K5 (fmt none, bf16, fp8_e4m3) of the committed
    build and the parent's, timed in turns (parent, committed, committed,
    parent) as ``chip_smoke.py`` times (L2 flushed before each call, median
    of 10), with each build's outputs bitwise equal to the committed one's;
  - ``depth``: the same calls on builds with ``SSM_SCAN_DEPTH`` set to each
    of ``--depths``;
  - ``rows``: the committed build at 8, 16 and 32 rows a block (the
    planner's choice at this shape is 32).
Operands: a in (0.5, 1), b and c standard normal, from seed 0.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (2, 256, 8192, 16)
FMTS = ("none", "bf16", "fp8_e4m3")


def build(nvcc, flags, src, out, defines=()):
    """Start one ``nvcc`` of ``src`` into ``out``; returns the process."""
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc, *flags, *(f"-D{d}" for d in defines), "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def entry(lib_path, with_rows):
    fn = ctypes.CDLL(str(lib_path)).repro_ssm_scan
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, *[i] * (9 if with_rows else 8), p]
    fn.restype = ctypes.c_int
    return fn


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="csrc directory of the kernel "
                        "before the redesign")
    parser.add_argument("--depths", default="2,4,8",
                        help="ring depths to build and time")
    parser.add_argument("--out", help="also append the lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("scan_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # time_ms, HBM_BYTES_PER_S
    from repro_torch.core import formats as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan as sk

    out = open(args.out, "a") if args.out else None

    def emit(record):
        line = json.dumps(record)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")

    # every build at once, one nvcc each
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    bdir = ROOT / "build" / "scan_sweep"
    src = _build.CSRC / "ssm_scan.cu"
    procs = {}
    if args.parent:
        procs["parent"] = build(nvcc, flags, Path(args.parent) /
                                "ssm_scan.cu", bdir / "libparent.so")
    depths = [int(d) for d in args.depths.split(",") if d]
    for d in depths:
        procs[f"depth{d}"] = build(nvcc, flags, src, bdir / f"libd{d}.so",
                                   (f"SSM_SCAN_DEPTH={d}",))
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"scan_sweep: nvcc failed for {name}:\n{log}",
                  file=sys.stderr)
            return 1
    committed = sk._entry()

    B, S, D, N = SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.rand(SHAPE, generator=gen, device=dev) * 0.5 + 0.5
    b = torch.randn(SHAPE, generator=gen, device=dev)
    c = torch.randn((B, S, N), generator=gen, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    byts = 4 * (2 * B * S * D * N + B * S * N + B * S * D + B * D * N)
    stream = torch.cuda.current_stream(dev).cuda_stream
    planned = sk.plan_scan(SHAPE, _build.sm_count(dev)).rows

    def caller(fn, fmt, rows=None):
        """A call of one build's entry; returns (run, outputs)."""
        y = torch.empty((B, S, D), device=dev)
        h = torch.zeros((B, D, N), device=dev)
        e, m = (8, 23) if fmt == "none" else (F.REGISTRY[fmt].exp_bits,
                                              F.REGISTRY[fmt].man_bits)
        tail = [] if rows is None else [rows]

        def run():
            _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                            y.data_ptr(), h.data_ptr(), B, S, D, N, e, m,
                            0, 0, *tail, stream), "ssm_scan")
        return run, (y, h)

    def same(outs, ref):
        return all(torch.equal(o.nan_to_num(), r.nan_to_num())
                   for o, r in zip(outs, ref))

    refs = {}
    for fmt in FMTS:
        run, outs = caller(committed, fmt, planned)
        run()
        torch.cuda.synchronize()
        refs[fmt] = tuple(t.clone() for t in outs)

    def reading(kind, label, fn, rows, turns=None):
        for fmt in FMTS:
            run, outs = caller(fn, fmt, rows)
            if turns is None:
                ms = cs.time_ms(run, flush)
                rec = {"ms": ms}
            else:  # the other build, then this one, twice, then the other
                base, _ = caller(committed, fmt, planned)
                seq = [run, base, base, run]
                t = [cs.time_ms(f, flush) for f in seq]
                rec = {"ms_turns": [t[0], t[3]], "committed_ms_turns":
                       [t[1], t[2]], "ms": (t[0] + t[3]) / 2,
                       "committed_ms": (t[1] + t[2]) / 2}
            torch.cuda.synchronize()
            emit({"kind": kind, label[0]: label[1], "fmt": fmt,
                  "kernel": "K6" if fmt == "none" else "K5",
                  "shape": list(SHAPE), **rec,
                  "achieved_bytes_per_s": byts / (rec["ms"] * 1e-3),
                  "bytes_ms": 1e3 * byts / cs.HBM_BYTES_PER_S,
                  "equal_to_committed": same(outs, refs[fmt]),
                  "card": smi})

    if args.parent:
        reading("parent", ("build", "parent"),
                entry(bdir / "libparent.so", with_rows=False), None,
                turns=True)
    for d in depths:
        reading("depth", ("depth", d),
                entry(bdir / f"libd{d}.so", with_rows=True), planned)
    for rows in (8, 16, 32):
        reading("rows", ("rows", rows), committed, rows)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
