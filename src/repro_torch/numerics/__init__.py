"""``repro_torch.numerics`` — formats, the format registry, the emulation
entry points of the port (matmul, dot, quantize, the selective scan and
flash attention), the bit-exact softfloat scalar semantics and the
exact-``Fraction`` accuracy oracle (counterpart of ``repro.numerics``)."""
from repro_torch.core.formats import (  # noqa: F401
    BF16, FP8_E4M3, FP8_E5M2, FP16, FP32, FP64, TF32, FloatFormat, quantize,
    quantize_stochastic,
)
from repro_torch.core.softfloat import (  # noqa: F401
    dot, dot_cascade, dot_fused, dp_add, dp_cma, dp_fma, dp_mul,
    quantize64, sf_add, sf_cma, sf_fma, sf_mul,
)
from repro_torch.numerics.accuracy import (  # noqa: F401
    DEFAULT_ACCURACY_MODEL, AccuracyModel, dot_exact_steps, rne_fraction,
)
from repro_torch.numerics.emulate import (  # noqa: F401
    STYLES, accum_style_for, emulated_dot, emulated_flash_attention,
    emulated_matmul, emulated_ssm_scan, matmul_for_policy, policy_matmul,
    quantize_tensor,
)
from repro_torch.numerics.registry import (  # noqa: F401
    REGISTRY, FormatRegistry, FormatSpec, fpgen_format, get_format,
    native_format, register_format,
)

__all__ = [
    # formats
    "FloatFormat", "FP64", "FP32", "TF32", "BF16", "FP16", "FP8_E4M3",
    "FP8_E5M2", "quantize", "quantize_stochastic",
    # registry
    "FormatRegistry", "FormatSpec", "REGISTRY", "get_format",
    "register_format", "fpgen_format", "native_format",
    # emulation
    "STYLES", "accum_style_for", "emulated_matmul", "emulated_dot",
    "emulated_flash_attention", "emulated_ssm_scan",
    "matmul_for_policy", "policy_matmul", "quantize_tensor",
    "quantize64", "sf_mul", "sf_add", "sf_fma", "sf_cma",
    "dp_mul", "dp_add", "dp_cma", "dp_fma",
    "dot", "dot_fused", "dot_cascade",
    # accuracy
    "AccuracyModel", "DEFAULT_ACCURACY_MODEL", "dot_exact_steps",
    "rne_fraction",
]
