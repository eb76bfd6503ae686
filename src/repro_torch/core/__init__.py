"""Core of the port (counterpart of ``repro.core``): formats and
round-to-format, and the paper's DSE stack.

formats.py      — parameterized binary float formats, RNE and stochastic
                  rounding
softfloat.py    — bit-exact FMA/CMA semantics (fused vs cascade vs fwd) in
                  float64 torch
fpu_arch.py     — FPGen microarchitecture design space (FPUDesign)
energy_model.py — analytical energy/area/delay model calibrated to Table I
                  (batched float64 torch evaluation, float32 autograd fit)
latency_sim.py  — dependency-trace average-latency-penalty simulator
                  (Fig. 2c), every (trace, configuration) pair in one loop
dse.py          — design-space explorer + Pareto frontiers (Fig. 3/4)
objective.py    — shared objective/constraint API
autotune.py     — workload-aware autotuner over SweepResult (Table I)
body_bias.py    — static/adaptive body-bias energy policies (Fig. 4)
localsearch.py  — greedy hillclimbing with a recorded trajectory
trace.py        — dependency profiles from the aten ops of a call
chip.py         — chip-level heterogeneous-fleet API (ChipSpec / ChipPolicy /
                  tune_chip)

The consumer-facing format/emulation/accuracy surface is
``repro_torch.numerics`` (registry, emulated_matmul / emulated_dot,
AccuracyModel).
"""
from repro_torch.core.formats import (  # noqa: F401
    BF16, FP8_E4M3, FP8_E5M2, FP16, FP32, FP64, TF32, FloatFormat,
    get_format, quantize,
)
