"""``repro_torch.numerics`` — formats, the format registry and the emulation
entry points of the port: matmul, quantize, the selective scan and flash
attention (counterpart of ``repro.numerics``; the softfloat scalar
semantics, the accuracy oracle and ``emulated_dot`` are not ported yet)."""
from repro_torch.core.formats import (  # noqa: F401
    BF16, FP8_E4M3, FP8_E5M2, FP16, FP32, FP64, TF32, FloatFormat, quantize,
)
from repro_torch.numerics.emulate import (  # noqa: F401
    STYLES, accum_style_for, emulated_flash_attention, emulated_matmul,
    emulated_ssm_scan, matmul_for_policy, policy_matmul, quantize_tensor,
)
from repro_torch.numerics.registry import (  # noqa: F401
    REGISTRY, FormatRegistry, FormatSpec, fpgen_format, get_format,
    native_format, register_format,
)

__all__ = [
    "FloatFormat", "FP64", "FP32", "TF32", "BF16", "FP16", "FP8_E4M3",
    "FP8_E5M2", "quantize",
    "FormatRegistry", "FormatSpec", "REGISTRY", "get_format",
    "register_format", "fpgen_format", "native_format",
    "STYLES", "accum_style_for", "emulated_matmul",
    "emulated_flash_attention", "emulated_ssm_scan", "matmul_for_policy",
    "policy_matmul", "quantize_tensor",
]
