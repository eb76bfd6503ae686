"""Numerics-policy-aware matmul: where the FPMax technique meets the models
(counterpart of ``repro.models.numerics``).

Adapter only: the emulation path lives in ``repro_torch.numerics``; this
module resolves *which* policy applies — an explicit numerics policy, or
the one the chip facade routes for an execution phase (``chip_matmul``).
Under an emulating policy every projection and the unembed go through
``emulated_matmul``, which on CUDA tensors launches the K1 kernel,
``policy_flash_attention`` goes through ``emulated_flash_attention`` (K4)
and ``policy_ssm_scan`` through ``emulated_ssm_scan`` (K5).
"""
from __future__ import annotations

from repro_torch.numerics import (emulated_flash_attention,
                                  emulated_ssm_scan, get_format,
                                  policy_matmul)


def matmul(x, w, policy=None):
    """x: (..., K) @ w: (K, N) under an optional numerics policy."""
    return policy_matmul(x, w, policy)


def policy_flash_attention(q, k, v, policy=None, **kw):
    """Flash attention under an optional numerics policy, on q's device.

    Inert policies (or ``policy=None``) run the plain blockwise path
    (``attention.flash_attention``, not K4); emulating policies route
    through ``emulated_flash_attention`` with the policy's operand format
    (per-block rounding and dequant, the K4 kernel on CUDA tensors)."""
    if policy is None or not getattr(policy, "emulate", False):
        from repro_torch.models.attention import flash_attention
        return flash_attention(q, k, v, **kw)
    return emulated_flash_attention(q, k, v, fmt=policy.fmt,
                                    device=q.device, **kw)


def policy_ssm_scan(a, b, c, policy=None, **kw):
    """Selective scan under an optional numerics policy, on a's device.

    Inert policies (or ``policy=None``) keep full-precision operands
    (``fmt=None`` runs the same K5 schedule without rounding); emulating
    policies round the per-token operands to the policy's format."""
    fmt = policy.fmt if (policy is not None
                         and getattr(policy, "emulate", False)) else None
    return emulated_ssm_scan(a, b, c, fmt=fmt, device=a.device, **kw)


def chip_matmul(x, w, chip_policy, phase: str, fmt=None,
                precision: str | None = None):
    """Matmul under the numerics of the chip unit routed for ``phase``.

    ``chip_policy`` is a ``core.chip.ChipPolicy``; the routed unit's
    format / accumulation-style policy is applied through the emulated
    kernel semantics (``emulate=True``: K1 on CUDA tensors).  ``fmt=None``
    uses the routed unit's tuned operand format (bf16 fallback)."""
    fmt = get_format(fmt) if fmt is not None else None
    pol = chip_policy.numerics_for_phase(phase, fmt=fmt,
                                         precision=precision, emulate=True)
    return policy_matmul(x, w, pol)


class EmulatedPolicy:
    """Marks an ad-hoc (fmt, accumulation style) pair as active for model
    matmuls."""

    emulate = True

    def __init__(self, fmt, accum_style: str):
        self.fmt = fmt
        self.accum_style = accum_style
