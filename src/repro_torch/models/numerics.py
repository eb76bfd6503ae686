"""Numerics-policy-aware matmul: where the FPMax technique meets the models
(counterpart of ``repro.models.numerics``).

Adapter only: the emulation path lives in ``repro_torch.numerics``.  Under
an emulating policy every projection and the unembed go through
``emulated_matmul``, which on CUDA tensors launches the K1 kernel.
"""
from __future__ import annotations

from repro_torch.numerics import policy_matmul


def matmul(x, w, policy=None):
    """x: (..., K) @ w: (K, N) under an optional numerics policy."""
    return policy_matmul(x, w, policy)


class EmulatedPolicy:
    """Marks an ad-hoc (fmt, accumulation style) pair as active for model
    matmuls."""

    emulate = True

    def __init__(self, fmt, accum_style: str):
        self.fmt = fmt
        self.accum_style = accum_style
