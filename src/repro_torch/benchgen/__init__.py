"""``repro_torch.benchgen`` — generated, roofline-checked kernel
microbenchmarks (counterpart of ``repro.benchgen``).

A ``KernelSpec`` (op x format x shape x accumulation style) generates a
runnable microbenchmark over the port's kernels *and* an analytic prediction
from its op counts; ``validate()`` holds the two against each other under a
machine-model tolerance.

  * ``spec``    — ``KernelSpec`` + ``op_counts`` + ``make_inputs`` +
                  ``build``;
  * ``machine`` — ``MachineModel`` with ``calibrate()`` measuring a device
                  and ``paper_machine()`` the H100 data-sheet corner;
  * ``bench``   — ``predict`` (a ``roofline.analysis.RooflineReport``),
                  ``measure``, ``validate`` and ``default_specs``.
"""
from repro_torch.benchgen.bench import (  # noqa: F401
    default_specs, measure, predict, validate,
)
from repro_torch.benchgen.machine import (  # noqa: F401
    MachineModel, calibrate, paper_machine,
)
from repro_torch.benchgen.spec import (  # noqa: F401
    OPS, KernelSpec, build, make_inputs, op_counts,
)

__all__ = [
    "KernelSpec", "OPS", "op_counts", "make_inputs", "build",
    "MachineModel", "calibrate", "paper_machine",
    "predict", "measure", "validate", "default_specs",
]
