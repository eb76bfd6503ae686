"""Named transprecision format registry (counterpart of
``repro.numerics.registry``).

Format lookup and FPGen (exp, man) points.  The per-format energy, area and
delay scales of the JAX registry come from the calibrated energy model and
arrive with the DSE slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

from repro_torch.core.formats import (BF16, FP8_E4M3, FP8_E5M2, FP16, FP32,
                                      FP64, TF32, FloatFormat)


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """One registered format: the numeric grid plus its host precision
    class (the narrowest fabricated datapath family, sp or dp)."""

    fmt: FloatFormat
    precision_class: str

    @property
    def name(self) -> str:
        return self.fmt.name

    @property
    def bits(self) -> int:
        return self.fmt.bits

    @property
    def is_native(self) -> bool:
        """True for the class-native formats (fp32 on sp, fp64 on dp)."""
        native_sig = 24 if self.precision_class == "sp" else 53
        native_exp = 8 if self.precision_class == "sp" else 11
        return (self.fmt.man_bits + 1 == native_sig
                and self.fmt.exp_bits == native_exp)


def _class_of(fmt: FloatFormat) -> str:
    return "sp" if (fmt.man_bits <= 23 and fmt.exp_bits <= 8) else "dp"


class FormatRegistry:
    """Name -> ``FormatSpec`` mapping with FPGen-point registration."""

    def __init__(self, specs: Tuple[FormatSpec, ...] = ()):
        self._specs: Dict[str, FormatSpec] = {s.name: s for s in specs}

    def register(self, fmt: FloatFormat,
                 precision_class: Optional[str] = None) -> FormatSpec:
        """Register (or return the existing spec for) ``fmt``."""
        hit = self._specs.get(fmt.name)
        if hit is not None:
            if hit.fmt != fmt:
                raise ValueError(
                    f"format name {fmt.name!r} already registered as "
                    f"{hit.fmt!r}, refusing to rebind to {fmt!r}")
            return hit
        spec = FormatSpec(fmt, precision_class or _class_of(fmt))
        self._specs[fmt.name] = spec
        return spec

    def fpgen(self, exp_bits: int, man_bits: int) -> FormatSpec:
        """Register an arbitrary FPGen (exp, man) point (named eXmY)."""
        return self.register(FloatFormat(exp_bits, man_bits))

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __iter__(self) -> Iterator[FormatSpec]:
        return iter(self._specs.values())

    def names(self) -> Tuple[str, ...]:
        return tuple(self._specs)

    def get(self, name: str) -> FormatSpec:
        if name not in self._specs:
            raise KeyError(f"unknown format {name!r}; registered: "
                           f"{sorted(self._specs)} (register FPGen points "
                           f"with REGISTRY.fpgen(exp, man))")
        return self._specs[name]

    def format(self, fmt: "FloatFormat | str") -> FloatFormat:
        """Resolve a name or pass a ``FloatFormat`` through."""
        if isinstance(fmt, FloatFormat):
            return fmt
        return self.get(fmt).fmt

    def native(self, precision: str) -> FloatFormat:
        """The class-native operand format of a precision class."""
        return FP32 if precision == "sp" else FP64

    def formats_for(self, precision: str,
                    include_native: bool = True) -> Tuple[FloatFormat, ...]:
        """Candidate operand formats hostable on a ``precision`` datapath,
        widest first, the native format leading."""
        out = [s for s in self._specs.values()
               if s.precision_class == precision or precision == "dp"]
        out.sort(key=lambda s: (-s.bits, s.name))
        fmts = [s.fmt for s in out]
        native = self.native(precision)
        if native in fmts:
            fmts.remove(native)
        return ((native,) if include_native else ()) + tuple(fmts)


#: the process-default registry: IEEE tiers + the transprecision ladder
REGISTRY = FormatRegistry()
for _f in (FP64, FP32, TF32, BF16, FP16, FP8_E4M3, FP8_E5M2):
    REGISTRY.register(_f)
del _f


def get_format(fmt: "FloatFormat | str") -> FloatFormat:
    """Resolve a format name through the default registry."""
    return REGISTRY.format(fmt)


def register_format(fmt: FloatFormat,
                    precision_class: Optional[str] = None) -> FormatSpec:
    return REGISTRY.register(fmt, precision_class)


def fpgen_format(exp_bits: int, man_bits: int) -> FloatFormat:
    """Arbitrary FPGen (exp, man) point, registered in the default registry."""
    return REGISTRY.fpgen(exp_bits, man_bits).fmt


def native_format(precision: str) -> FloatFormat:
    return REGISTRY.native(precision)
