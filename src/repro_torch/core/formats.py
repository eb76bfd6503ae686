"""Floating-point format definitions and round-to-format (RNE) in PyTorch.

Counterpart of ``repro.core.formats``.  ``quantize`` is the plain PyTorch
version of the rounding that the CUDA kernels share (``csrc/quantize.cuh``):
f32 arithmetic plus integer bit operations, op for op the JAX function, so
the two agree bitwise on every input whose f32 encoding is not subnormal
(XLA:CPU treats f32 subnormals as zero; IEEE PyTorch and CUDA round them).

Exactness domain: any finite f32 input is RNE-rounded onto the grid of every
format with exp_bits <= 8 and man_bits <= 23; NaN and +-inf pass through,
signed zero is preserved, and values that round above ``max_finite`` become
+-inf.  Target-format subnormals are supported by the exponent clamp.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """A binary floating-point format (IEEE-754 style, with inf/NaN)."""

    exp_bits: int
    man_bits: int
    name: str = ""

    def __post_init__(self):
        if not (1 <= self.exp_bits <= 11):
            raise ValueError(f"exp_bits out of range: {self.exp_bits}")
        if not (0 <= self.man_bits <= 52):
            raise ValueError(f"man_bits out of range: {self.man_bits}")
        if not self.name:
            object.__setattr__(self, "name", f"e{self.exp_bits}m{self.man_bits}")

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def emax(self) -> int:
        """Largest unbiased exponent of a normal number (top exp reserved)."""
        return self.bias

    @property
    def emin(self) -> int:
        """Unbiased exponent of the smallest normal number."""
        return 1 - self.bias

    @property
    def max_finite(self) -> float:
        return float((2.0 - 2.0 ** (-self.man_bits)) * 2.0 ** self.emax)

    @property
    def min_normal(self) -> float:
        return float(2.0 ** self.emin)

    @property
    def min_subnormal(self) -> float:
        return float(2.0 ** (self.emin - self.man_bits))

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    def ulp(self, exponent: int) -> float:
        return float(2.0 ** (max(exponent, self.emin) - self.man_bits))

    def __repr__(self) -> str:
        return f"FloatFormat({self.name})"


FP32 = FloatFormat(8, 23, "fp32")
TF32 = FloatFormat(8, 10, "tf32")
BF16 = FloatFormat(8, 7, "bf16")
FP16 = FloatFormat(5, 10, "fp16")
# IEEE-style e4m3 with +-inf (max_finite 240): NOT torch.float8_e4m3fn,
# which tops out at 448 and has no inf — never round by a dtype cast
FP8_E4M3 = FloatFormat(4, 3, "fp8_e4m3")
FP8_E5M2 = FloatFormat(5, 2, "fp8_e5m2")
FP64 = FloatFormat(11, 52, "fp64")

REGISTRY: Dict[str, FloatFormat] = {
    f.name: f for f in (FP32, TF32, BF16, FP16, FP8_E4M3, FP8_E5M2, FP64)
}


def get_format(name: str) -> FloatFormat:
    """Resolve a builtin format name; FPGen points registered in the
    ``repro_torch.numerics`` registry resolve here too."""
    if name in REGISTRY:
        return REGISTRY[name]
    from repro_torch.numerics.registry import REGISTRY as _EXT
    if name in _EXT:
        return _EXT.format(name)
    raise KeyError(f"unknown format {name!r}; have {sorted(REGISTRY)} "
                   f"plus the repro_torch.numerics registry "
                   f"{sorted(set(_EXT.names()) - set(REGISTRY))}")


def _unbiased_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """floor(log2|x|) for normal f32 as int32; -127 for zeros/subnormals."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127


def _pow2_from_exp(e: torch.Tensor) -> torch.Tensor:
    """2**e as f32, built from exponent bits (e in [-126, 127], int32)."""
    return ((e + 127) << 23).view(torch.float32)


def quantize(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """RNE-round f32 values onto ``fmt``'s grid; result returned as f32."""
    if fmt.exp_bits > 8 or fmt.man_bits > 23:
        raise ValueError(f"f32 quantize path supports sub-f32 formats, got {fmt}")
    x = x.to(torch.float32)
    if fmt.exp_bits == 8 and fmt.man_bits == 23:
        return x  # identity: fmt == f32

    e = _unbiased_exp_f32(x)
    q_exp = e.clamp(fmt.emin, fmt.emax)
    # 2**scale_exp may be f32-subnormal for extreme formats; build it as the
    # product of two normal powers so every step stays exact
    scale_exp = q_exp - fmt.man_bits
    half_lo = scale_exp.clamp(-126, 127)
    half_hi = scale_exp - half_lo
    scale_lo = _pow2_from_exp(half_lo)
    scale_hi = _pow2_from_exp(half_hi)
    q = torch.round(x / scale_lo / scale_hi)  # round half to even
    y = q * scale_lo * scale_hi
    y = torch.where(y.abs() > fmt.max_finite,
                    torch.copysign(torch.full_like(y, float("inf")), y), y)
    y = torch.where(torch.isfinite(x), y, x)
    return torch.where(x == 0, x, y)


def quantize_stochastic(x: torch.Tensor, fmt: FloatFormat,
                        generator: torch.Generator | None = None, *,
                        u: torch.Tensor | None = None) -> torch.Tensor:
    """Stochastic rounding onto ``fmt`` (used by the compressed-gradient
    path): floor(x / ulp + u) * ulp with ``u`` uniform in [0, 1).

    ``u`` (f32, x's shape) is drawn from ``generator`` on x's device unless
    the caller passes it; given the JAX package's uniforms for its key, the
    result is op for op the reference's.  The ulp is an exact power of two
    built from exponent bits (as float64, then float32: powers below 2**-126
    become f32 subnormals, exactly).
    """
    x = x.to(torch.float32)
    if u is None:
        u = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                       device=x.device)
    e = _unbiased_exp_f32(x)
    q_exp = e.clamp(fmt.emin, fmt.emax)
    k = (q_exp - fmt.man_bits).to(torch.int64).clamp(-1022, 1023)
    scale = ((k + 1023) << 52).view(torch.float64).to(torch.float32)
    q = torch.floor(x / scale + u.to(torch.float32))
    y = (q * scale).clamp(-fmt.max_finite, fmt.max_finite)
    y = torch.where(torch.isfinite(x), y, x)
    return torch.where(x == 0, x, y)
