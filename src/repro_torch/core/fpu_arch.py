"""FPGen microarchitecture design space (counterpart of
``repro.core.fpu_arch``, copied: it is pure Python).

An ``FPUDesign`` is one point in the space FPGen searches: precision, FMAC
style (fused vs cascade), pipeline partition, Booth radix, reduction-tree
topology, plus the two electrical knobs UTBB FDSOI exposes (V_DD, body bias).

The four fabricated FPMax units (paper Table I) are provided as constants,
with their measured silicon numbers attached for calibration/validation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

PRECISIONS = ("sp", "dp")
STYLES = ("fma", "cma")
TREES = ("wallace", "array", "zm")
BOOTH_RADICES = (2, 3)


@dataclasses.dataclass(frozen=True)
class FPUDesign:
    """One FPGen design point."""

    precision: str  # 'sp' | 'dp'
    style: str  # 'fma' | 'cma'
    stages: int  # total pipeline stages
    mul_stages: int  # multiplier pipe depth
    add_stages: int  # adder pipe depth (CMA only; 0 for FMA)
    booth: int  # Booth encoding radix exponent: 2 or 3 (radix-4 / radix-8)
    tree: str  # 'wallace' | 'array' | 'zm'
    vdd: float = 1.0  # supply voltage (V)
    vbb: float = 0.0  # forward body bias (V)
    forwarding: bool = True  # internal un-rounded-result bypass [Trong'07]
    name: str = ""
    # transprecision datapath narrowing (FPGen supports arbitrary (exp, man)
    # formats): when set, the significand/exponent widths override the
    # precision-class defaults and the structural feature model scales the
    # whole datapath (multiplier array, CPAs, registers) to the new width.
    # ``precision`` keeps naming the host datapath *class* (sp/dp routing).
    sig_override: Optional[int] = None
    exp_override: Optional[int] = None

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision {self.precision!r}")
        if self.style not in STYLES:
            raise ValueError(f"style {self.style!r}")
        if self.booth not in BOOTH_RADICES:
            raise ValueError(f"booth {self.booth!r}")
        if self.tree not in TREES:
            raise ValueError(f"tree {self.tree!r}")
        if self.stages < 2 or self.stages > 10:
            raise ValueError(f"stages {self.stages}")
        # floors of 1 admit every legal FloatFormat (man_bits=0 formats
        # have a 1-bit significand incl. the hidden bit; exp_bits >= 1)
        if self.sig_override is not None and not (
                1 <= self.sig_override <= 53):
            raise ValueError(f"sig_override {self.sig_override}")
        if self.exp_override is not None and not (
                1 <= self.exp_override <= 11):
            raise ValueError(f"exp_override {self.exp_override}")

    # --- structural quantities --------------------------------------------
    @property
    def sig_bits(self) -> int:
        """Significand width incl. hidden bit."""
        if self.sig_override is not None:
            return self.sig_override
        return 24 if self.precision == "sp" else 53

    @property
    def exp_bits(self) -> int:
        if self.exp_override is not None:
            return self.exp_override
        return 8 if self.precision == "sp" else 11

    @property
    def is_transprecision(self) -> bool:
        """True when the datapath is narrowed below the class-native width."""
        return self.sig_override is not None or self.exp_override is not None

    def with_format(self, fmt) -> "FPUDesign":
        """The same structure with its datapath sized for ``fmt`` (a
        ``repro_torch.core.formats.FloatFormat``).

        A format matching the current datapath widths (in particular the
        class-native format on an un-narrowed structure) returns ``self``
        unchanged, so native-format sweeps stay bitwise identical to the
        pre-transprecision paths; any other format renames the design
        ``<base>@<fmt>`` (re-deriving the base of an already-narrowed
        variant, so the call is idempotent) — the silicon anchor
        corrections (keyed by fabricated-unit name) never apply to a
        narrowed variant.
        """
        sig, exp = fmt.man_bits + 1, fmt.exp_bits
        if sig == self.sig_bits and exp == self.exp_bits:
            return self
        base = (self.name or self.style).split("@")[0]
        return dataclasses.replace(
            self, sig_override=sig, exp_override=exp,
            name=f"{base}@{fmt.name}")

    @property
    def n_partial_products(self) -> int:
        """Booth radix-2^b encoding of a (w+2)-bit multiplicand."""
        return math.ceil((self.sig_bits + 2) / self.booth)

    @property
    def tree_depth_levels(self) -> float:
        """3:2-compressor levels to reduce n_pp partial products to 2."""
        n = self.n_partial_products
        if self.tree == "wallace":
            # log_{3/2} reduction
            return math.ceil(math.log(n / 2.0) / math.log(1.5))
        if self.tree == "zm":
            # Zuras-McAllister higher-order array: between log and linear
            return math.ceil(2.0 * math.sqrt(n)) - 2
        # simple linear array
        return n - 2

    def with_voltage(self, vdd: float, vbb: float) -> "FPUDesign":
        return dataclasses.replace(self, vdd=vdd, vbb=vbb)

    def latency_cycles(self) -> int:
        return self.stages

    @property
    def accum_latency_cycles(self) -> int:
        """Cycles a dependent accumulation stalls for (see latency_sim)."""
        if self.style == "cma" and self.forwarding:
            # un-rounded result bypassed into the adder input stage
            return self.add_stages
        if self.style == "fma" and self.forwarding:
            return self.stages - 1  # skip the rounding stage
        return self.stages

    @property
    def mul_dep_latency_cycles(self) -> int:
        """Cycles a dependent multiplication stalls for."""
        if self.forwarding:
            if self.style == "cma":
                return self.mul_stages + self.add_stages  # bypass round stage
            return self.stages - 1
        return self.stages


# ---------------------------------------------------------------------------
# The four fabricated FPMax units (paper Table I), with measured silicon.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SiliconMeasurement:
    area_mm2: float
    freq_ghz: float
    leak_mw: float
    power_mw: float  # total at 100% activity, nominal point
    vdd: float
    vbb: float
    # normalized (nominal-point) efficiencies quoted in Table I
    gflops_per_mm2: float
    gflops_per_w: float
    # peak values across operating points (Fig. 3 endpoints)
    max_gflops_per_mm2: float
    max_gflops_per_w: float
    norm_delay_ns: float
    min_delay_ns: float


DP_CMA = FPUDesign("dp", "cma", stages=5, mul_stages=2, add_stages=2,
                   booth=3, tree="wallace", vdd=0.9, vbb=1.2, name="dp_cma")
DP_FMA = FPUDesign("dp", "fma", stages=6, mul_stages=2, add_stages=0,
                   booth=3, tree="array", vdd=0.8, vbb=1.2, name="dp_fma")
SP_CMA = FPUDesign("sp", "cma", stages=6, mul_stages=3, add_stages=2,
                   booth=2, tree="wallace", vdd=0.8, vbb=1.2, name="sp_cma")
SP_FMA = FPUDesign("sp", "fma", stages=4, mul_stages=2, add_stages=0,
                   booth=3, tree="zm", vdd=0.9, vbb=1.2, name="sp_fma")

FABRICATED: Dict[str, FPUDesign] = {
    d.name: d for d in (DP_CMA, DP_FMA, SP_CMA, SP_FMA)
}

TABLE_I: Dict[str, SiliconMeasurement] = {
    "dp_cma": SiliconMeasurement(0.032, 1.19, 8.4, 66.0, 0.9, 1.2,
                                 74.6, 36.0, 87.5, 128.0, 1.39, 1.18),
    "dp_fma": SiliconMeasurement(0.024, 0.910, 3.8, 41.0, 0.8, 1.2,
                                 74.6, 43.7, 111.0, 117.0, 2.79, 1.88),
    "sp_cma": SiliconMeasurement(0.018, 1.36, 3.3, 25.0, 0.8, 1.2,
                                 151.0, 110.0, 165.0, 314.0, 1.42, 1.30),
    "sp_fma": SiliconMeasurement(0.0081, 0.910, 1.6, 17.0, 0.9, 1.2,
                                 217.0, 106.0, 278.0, 289.0, 1.77, 1.39),
}


def get_design(name: str) -> FPUDesign:
    if name not in FABRICATED:
        raise KeyError(f"unknown FPU design {name!r}; have {sorted(FABRICATED)}")
    return FABRICATED[name]
