"""predict / measure / validate: the generated-kernel model check
(counterpart of ``repro.benchgen.bench``).

``predict`` prices a ``KernelSpec``'s analytic op counts through a
``MachineModel`` and wraps the result in a ``roofline.analysis
.RooflineReport``.  ``measure`` runs the generated kernel; ``validate``
holds the two against each other under a multiplicative tolerance and
reports the fraction of specs whose measured time lands within it.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional, Sequence

from repro_torch._device import resolve_device
from repro_torch.benchgen.machine import MachineModel, _sync, calibrate
from repro_torch.benchgen.spec import KernelSpec, build, make_inputs, op_counts
from repro_torch.roofline.analysis import RooflineReport

#: measured/predicted must land in [1/tol, tol] (the JAX package's value)
DEFAULT_TOL = 6.0


def predict(spec: KernelSpec, machine: MachineModel) -> RooflineReport:
    """Analytic time bound for ``spec`` on ``machine`` as a RooflineReport.

    The compute term sums the four pipe times (dot, round-to-format,
    elementwise, exp).  ``peak_flops`` is back-derived so the report's
    ``t_compute`` property reproduces the summed bound exactly.
    """
    c = op_counts(spec)
    t_pipes = (c["dot_flops"] / machine.mxu_flops
               + c["quant_elems"] / machine.quant_rate
               + c["vpu_flops"] / machine.vpu_flops
               + c["exp_elems"] / machine.exp_rate)
    t_pipes = max(t_pipes, 1e-12)
    flops = max(c["dot_flops"] + c["vpu_flops"], 1.0)
    return RooflineReport(
        arch=spec.fmt, shape=spec.name, mesh=machine.name, chips=1,
        flops_per_device=flops,
        bytes_per_device=c["hbm_bytes"],
        collective_bytes_per_device=0.0, collective_breakdown={},
        model_flops=c["useful_flops"],
        peak_flops=flops / t_pipes,  # t_compute == summed pipe bound
        hbm_bw=machine.hbm_bw)


def measure(spec: KernelSpec, impl: str = "auto", *, seed: int = 0,
            n: int = 5, device=None) -> float:
    """Median wall-clock seconds of the generated kernel (warm path) on
    ``device`` (default CUDA), each run synchronised."""
    dev = resolve_device(device)
    fn = build(spec, impl, device=dev)
    args = make_inputs(spec, seed, device=dev)
    fn(*args)  # build + warm
    _sync(dev)
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def validate(specs: Sequence[KernelSpec],
             machine: Optional[MachineModel] = None, *,
             tol: float = DEFAULT_TOL, impl: str = "auto", n: int = 5,
             device=None) -> Dict:
    """Measure every spec on ``device`` (default CUDA) and compare against
    its prediction.

    Returns ``{"machine": ..., "tol": ..., "rows": [...], "summary": {...}}``
    where each row carries the predicted bound, the measured time, their
    ratio and the within-tolerance verdict.
    """
    dev = resolve_device(device)
    if machine is None:
        machine = calibrate(device=dev)
    rows: List[Dict] = []
    for spec in specs:
        rep = predict(spec, machine)
        t_pred = rep.step_time_bound_s
        t_meas = measure(spec, impl, n=n, device=dev)
        ratio = t_meas / max(t_pred, 1e-12)
        rows.append({
            "spec": spec.as_dict(),
            "t_pred_s": t_pred,
            "t_meas_s": t_meas,
            "ratio": ratio,
            "within_tol": bool(1.0 / tol <= ratio <= tol),
            "bottleneck": rep.bottleneck,
            "useful_gflops": rep.model_flops / max(t_meas, 1e-12) / 1e9,
        })
    within = sum(r["within_tol"] for r in rows)
    ratios = [r["ratio"] for r in rows]
    return {
        "machine": machine.as_dict(),
        "tol": tol,
        "rows": rows,
        "summary": {
            "n_specs": len(rows),
            "frac_within_tol": within / len(rows) if rows else 1.0,
            "worst_ratio": max((max(r, 1.0 / r) for r in ratios),
                               default=1.0),
            "geomean_ratio": (statistics.geometric_mean(ratios)
                              if ratios else 1.0),
        },
    }


def default_specs() -> List[KernelSpec]:
    """The JAX package's sweep: every op, the format ladder, all accum
    styles."""
    return [
        KernelSpec("qmm", "bf16", (256, 256, 256), "fused"),
        KernelSpec("qmm", "tf32", (256, 256, 256), "cascade_fwd"),
        KernelSpec("qmm", "fp8_e4m3", (256, 256, 256), "cascade",
                   scaled=True),
        KernelSpec("flash", "bf16", (1, 2, 256, 64)),
        KernelSpec("flash", "fp8_e5m2", (1, 2, 256, 64), scaled=True),
        KernelSpec("ssm_scan", "fp8_e4m3", (1, 128, 256, 16)),
        KernelSpec("quantize", "bf16", (1024, 1024)),
    ]
