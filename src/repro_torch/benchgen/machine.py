"""Machine model: sustained per-pipe rates the predictions divide by
(counterpart of ``repro.benchgen.machine``).

A ``MachineModel`` is the benchgen analogue of the paper's synthesis corner:
the handful of sustained rates that turn a spec's analytic op counts into a
time.  ``calibrate()`` *measures* them with PyTorch on a device with four
probes (dot / elementwise / round-to-format / exp) plus a streaming copy,
so predictions and measurements share one clock and the validate() ratio is
machine-normalized.  ``paper_machine()`` is the H100 data-sheet corner, for
offline what-if reports.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.roofline.analysis import H100_HBM_BW, H100_PEAK_FLOPS_BF16


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Sustained rates: flops/s, elements/s, bytes/s — all f32 pipes."""

    name: str
    mxu_flops: float    # dot-product contraction flops/s
    vpu_flops: float    # elementwise mul/add flops/s
    quant_rate: float   # round-to-format elements/s (the quantize() chain)
    exp_rate: float     # transcendental exp() elements/s
    hbm_bw: float       # streaming interface bytes/s

    def as_dict(self) -> Dict[str, float]:
        return dict(name=self.name, mxu_flops=self.mxu_flops,
                    vpu_flops=self.vpu_flops, quant_rate=self.quant_rate,
                    exp_rate=self.exp_rate, hbm_bw=self.hbm_bw)


def paper_machine() -> MachineModel:
    """Nominal NVIDIA H100 SXM corner from its data sheet: dense bf16
    tensor-core peak (989 TFLOP/s) and HBM3 rate (3.35 TB/s).

    The elementwise rate is ~1/50 of the contraction peak, the
    round-to-format chain ~12 elementwise ops per element and exp ~8: the
    ratios of the JAX package's ``paper_machine`` docstring, kept as they
    are.  Indicative only — use ``calibrate()`` on the card.
    """
    vpu = H100_PEAK_FLOPS_BF16 / 50.0
    return MachineModel(name="h100_datasheet",
                        mxu_flops=H100_PEAK_FLOPS_BF16, vpu_flops=vpu,
                        quant_rate=vpu / 12.0, exp_rate=vpu / 8.0,
                        hbm_bw=H100_HBM_BW)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rate(fn: Callable, work: float, *args, device: torch.device,
          n: int = 5) -> float:
    """work-units/s for ``fn``: warm once, median of ``n`` synchronised
    runs."""
    fn(*args)
    _sync(device)
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        samples.append(time.perf_counter() - t0)
    return work / max(statistics.median(samples), 1e-12)


def calibrate(seed: int = 0, n: int = 5, device=None) -> MachineModel:
    """Measure the five pipe rates with PyTorch on ``device`` (default
    CUDA; raises if it is absent)."""
    from repro_torch.core.formats import BF16
    from repro_torch.numerics.emulate import quantize_tensor

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sq = torch.from_numpy(rng.standard_normal((512, 512)).astype(
        np.float32)).to(dev)
    big = torch.from_numpy(rng.standard_normal((2048, 2048)).astype(
        np.float32)).to(dev)

    mxu = _rate(lambda a, b: a @ b, 2.0 * 512 ** 3, sq, sq, device=dev, n=n)

    reps = 16  # chained multiply-adds so dispatch overhead amortizes out

    def _fma_chain(x):
        y = x
        for _ in range(reps):
            y = y * 1.0009765625 + 0.5  # exact-f32 constants
        return y

    vpu = _rate(_fma_chain, 2.0 * reps * big.numel(), big, device=dev, n=n)

    q_impl = "pallas" if dev.type == "cuda" else "ref"
    quant = _rate(lambda x: quantize_tensor(x, fmt=BF16, impl=q_impl,
                                            device=dev),
                  float(big.numel()), big, device=dev, n=n)

    expr = _rate(torch.exp, float(big.numel()), big, device=dev, n=n)

    hbm = _rate(lambda x: x + 1.0, 2.0 * 4.0 * big.numel(), big, device=dev,
                n=n)

    return MachineModel(
        name=f"calibrated:{dev.type}", mxu_flops=mxu, vpu_flops=vpu,
        quant_rate=quant, exp_rate=expr, hbm_bw=hbm)
