"""Numerics-policy-aware matmul: where the FPMax technique meets the models
(counterpart of ``repro.models.numerics``).

Adapter only: the emulation path lives in ``repro_torch.numerics``.  Under
an emulating policy every projection and the unembed go through
``emulated_matmul``, which on CUDA tensors launches the K1 kernel, and
``policy_ssm_scan`` goes through ``emulated_ssm_scan`` (K5).
"""
from __future__ import annotations

from repro_torch.numerics import emulated_ssm_scan, policy_matmul


def matmul(x, w, policy=None):
    """x: (..., K) @ w: (K, N) under an optional numerics policy."""
    return policy_matmul(x, w, policy)


def policy_ssm_scan(a, b, c, policy=None, **kw):
    """Selective scan under an optional numerics policy, on a's device.

    Inert policies (or ``policy=None``) keep full-precision operands
    (``fmt=None`` runs the same K5 schedule without rounding); emulating
    policies round the per-token operands to the policy's format."""
    fmt = policy.fmt if (policy is not None
                         and getattr(policy, "emulate", False)) else None
    return emulated_ssm_scan(a, b, c, fmt=fmt, device=a.device, **kw)


class EmulatedPolicy:
    """Marks an ad-hoc (fmt, accumulation style) pair as active for model
    matmuls."""

    emulate = True

    def __init__(self, fmt, accum_style: str):
        self.fmt = fmt
        self.accum_style = accum_style
