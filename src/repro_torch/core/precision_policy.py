"""DEPRECATED compatibility shim over ``repro_torch.core.chip`` (counterpart
of ``repro.core.precision_policy``).

Everything this module used to do — workload -> FPU design selection, the
numerics policy for the model layers, per-step energy telemetry — now lives
behind the chip-level facade (``ChipSpec`` / ``ChipPolicy`` / ``tune_chip``),
which routes *per execution phase* on a heterogeneous die instead of handing
out one unit at a time.  See docs/chip.md for the migration guide.

The old entry points keep the JAX package's return values (``select_fpu``
resolves through the default 2-unit chip, whose units are the
``dse.best_throughput_design`` / ``dse.best_latency_design`` picks) and emit
``DeprecationWarning``.  Where a call calibrates (no ``params`` given), the
fit and the default die's sweeps run on ``device``: the card unless the
caller passes ``device='cpu'``, as every entry point of the port does.
"""
from __future__ import annotations

import warnings
from typing import Optional

from repro_torch.core.chip import (NumericsPolicy, default_policy,  # noqa: F401
                                   kernel_style_for, unit_energy_telemetry)
from repro_torch.core.energy_model import TechParams, calibrate
from repro_torch.core.formats import BF16, FP32, FloatFormat
from repro_torch.core.fpu_arch import FABRICATED, FPUDesign

__all__ = ["NumericsPolicy", "select_fpu", "policy_for_shape",
           "fabricated_policy", "step_energy_telemetry"]


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.core.precision_policy.{old} is deprecated; use "
        f"repro_torch.core.chip.{new} (see docs/chip.md)",
        DeprecationWarning, stacklevel=3)


def select_fpu(workload: str, precision: str = "sp",
               params: Optional[TechParams] = None,
               device=None) -> FPUDesign:
    """DSE-pick the FPU for a workload class ('throughput' | 'latency').

    Deprecated: ask the chip — ``chip.default_policy(precision)
    .unit_for_phase(phase).design``.
    """
    _deprecated("select_fpu", "ChipPolicy.unit_for_phase")
    return default_policy(precision, params,
                          device=device).select_fpu(workload)


def policy_for_shape(shape_kind: str, precision: str = "sp",
                     fmt: FloatFormat = BF16, device=None) -> NumericsPolicy:
    """Map an input-shape kind to its numerics policy.

    Deprecated: ``chip.default_policy(precision)
    .numerics_for_phase(shape_kind, fmt=fmt)``.
    """
    _deprecated("policy_for_shape", "ChipPolicy.numerics_for_phase")
    return default_policy(precision, device=device).numerics_for_phase(
        shape_kind, fmt=fmt)


def fabricated_policy(name: str, fmt: FloatFormat = FP32) -> NumericsPolicy:
    """Policy modeling one of the four FPMax silicon units by name.

    Deprecated: ``chip.fabricated_chip().unit(name).numerics(fmt=fmt)``.
    """
    _deprecated("fabricated_policy", "fabricated_chip().unit(name).numerics")
    d = FABRICATED[name]
    return NumericsPolicy(fmt=fmt, accum_style=kernel_style_for(d),
                          fpu_design=d)


def step_energy_telemetry(design: FPUDesign, *, achieved_flops: float,
                          step_time_s: float, peak_flops: float,
                          adaptive_bb: bool = True,
                          params: Optional[TechParams] = None,
                          device=None) -> dict:
    """Per-step energy report for the training loop.

    Deprecated: ``chip.ChipPolicy.step_energy_telemetry(phase, ...)`` routes
    the phase to its unit and tags the report; this shim keeps the old
    design-scoped call (nominal V_DD, full forward bias).
    """
    _deprecated("step_energy_telemetry", "ChipPolicy.step_energy_telemetry")
    return unit_energy_telemetry(design, params or calibrate(device=device),
                                 achieved_flops=achieved_flops,
                                 step_time_s=step_time_s,
                                 peak_flops=peak_flops,
                                 adaptive_bb=adaptive_bb)
