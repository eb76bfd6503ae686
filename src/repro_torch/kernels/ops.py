"""Public kernel-level entry points — adapters only (counterpart of
``repro.kernels.ops``); the logic lives in ``repro_torch.numerics.emulate``.
"""
from __future__ import annotations

from repro_torch.numerics.emulate import (  # noqa: F401
    emulated_matmul, matmul_for_policy, quantize_tensor,
)

__all__ = ["emulated_matmul", "matmul_for_policy", "quantize_tensor"]
