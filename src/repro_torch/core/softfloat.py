"""Bit-exact software FPU semantics: fused (FMA) vs cascade (CMA)
multiply-add, in float64 PyTorch (counterpart of ``repro.core.softfloat``).

FPMax fabricates four FMAC units; their *numeric* difference is where
rounding happens:

  * FMA  (fused):    r = RNE_F( a*b + c )               -- one rounding
  * CMA  (cascade):  r = RNE_F( RNE_F(a*b) + c )        -- two roundings
  * CMA + internal forwarding: the un-rounded result of a dependent op is
    forwarded into the next op, i.e. the accumulator is held in extended
    precision and rounded once at the end of the dependence chain.

Formats with man_bits <= 23 (incl. IEEE SP) go through f64 arithmetic plus
round-to-odd double-rounding protection; IEEE DP goes through error-free
transformations (Dekker TwoProduct + Knuth TwoSum + Boldo-Melquiond
round-to-odd FMA emulation).

Exactness arguments, as in the JAX package:
  * mul: a,b in F (man<=23) => the product has <=48 significand bits, exact
    in f64; ``quantize64`` rounds it once.
  * add: double rounding through f64 (53 bits) then to F (<=24 bits) is
    innocuous because 53 >= 2*24 + 2.
  * fma: the 48-bit product plus a 24-bit addend is NOT double-rounding
    safe through 53 bits, so TwoSum + round-to-odd precede the final RNE.
  * DP fused fma: Boldo-Melquiond emulation, exact barring extreme
    over/underflow.

Every multiply and every add or subtract is its own tensor operation: the
error-free transformations are wrong under contraction into a fused
multiply-add, so nothing here uses ``addcmul``, ``lerp``, ``torch.compile``
or a custom kernel.  Bit work runs on an ``int64`` view.  The operations
run on the operands' device (tensors) or, for other inputs, on ``device``
(the card unless the caller passes ``device='cpu'``).

Subnormals: IEEE PyTorch and CUDA keep f64 subnormals, where XLA:CPU
flushes them (DAZ/FTZ on float64 too), so parity with the JAX package holds
on normal-range operands whose products and sums stay normal.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.core.formats import FP32, FloatFormat

F64 = torch.float64


def _f64(*xs, device=None):
    """The operands as float64 tensors on one device: the first tensor's,
    else ``device``."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    if dev is None:
        dev = resolve_device(device)
    # dtype at conversion: a Python float or list would otherwise pass
    # through torch's default float32 first
    return tuple(torch.as_tensor(x, dtype=F64, device=dev) for x in xs)


# ---------------------------------------------------------------------------
# f64 quantizer (exact RNE for man_bits <= 51)
# ---------------------------------------------------------------------------
def _pow2_f64(e: torch.Tensor) -> torch.Tensor:
    """Exact 2**e for integer e in (-1022, 1024), via exponent bits."""
    return ((e.to(torch.int64) + 1023) << 52).view(F64)


def quantize64(x, fmt: FloatFormat, device=None) -> torch.Tensor:
    """RNE-round f64 values onto fmt's grid (result f64)."""
    x, = _f64(x, device=device)
    bits = x.view(torch.int64)
    e = ((bits >> 52) & 0x7FF) - 1023
    q_exp = torch.clamp(e, fmt.emin, fmt.emax)
    scale = _pow2_f64(q_exp - fmt.man_bits)
    q = torch.round(x / scale)  # ties to even; division by pow2 exact
    y = q * scale
    inf = torch.full_like(y, float("inf"))
    y = torch.where(torch.abs(y) > fmt.max_finite, torch.sign(y) * inf, y)
    y = torch.where(torch.isfinite(x), y, x)
    return torch.where(x == 0, x, y)


# ---------------------------------------------------------------------------
# Error-free transformations (f64)
# ---------------------------------------------------------------------------
def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (no branches)."""
    s = a + b
    bp = s - a
    ap = s - bp
    e = (a - ap) + (b - bp)
    return s, e


#: 2**27 + 1, Dekker's split constant for f64
_SPLIT = 134217729.0


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def _two_product(a, b):
    """Dekker TwoProduct: p + e == a * b exactly (assuming no overflow)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _round_to_odd(s, e):
    """Given s = RNE(x), e = x - s exact: return RTO(x) (round-to-odd)."""
    lsb_even = (s.view(torch.int64) & 1) == 0
    inexact = e != 0
    inf = torch.full_like(s, float("inf"))
    toward = torch.where(e > 0, inf, -inf)
    nudged = torch.nextafter(s, toward)
    return torch.where(inexact & lsb_even, nudged, s)


# ---------------------------------------------------------------------------
# Sub-f32 formats (man_bits <= 23): exact scalar/elementwise ops
# ---------------------------------------------------------------------------
def sf_mul(a, b, fmt: FloatFormat, device=None) -> torch.Tensor:
    """Exact RNE multiply in fmt (inputs assumed on fmt's grid)."""
    a, b = _f64(a, b, device=device)
    return quantize64(a * b, fmt).float()  # the product is exact


def sf_add(a, b, fmt: FloatFormat, device=None) -> torch.Tensor:
    """Exact RNE add in fmt (double rounding through f64 is innocuous)."""
    a, b = _f64(a, b, device=device)
    return quantize64(a + b, fmt).float()


def sf_fma(a, b, c, fmt: FloatFormat, device=None) -> torch.Tensor:
    """Exact fused multiply-add in fmt: RNE_F(a*b + c), single rounding."""
    a, b, c = _f64(a, b, c, device=device)
    p = a * b  # exact: <= 48 significand bits
    s, e = _two_sum(p, c)
    s_odd = _round_to_odd(s, e)  # 53-bit round-to-odd of the exact sum
    return quantize64(s_odd, fmt).float()


def sf_cma(a, b, c, fmt: FloatFormat, device=None) -> torch.Tensor:
    """Cascade multiply-add: round the product, then round the sum."""
    a, b, c = _f64(a, b, c, device=device)
    p = quantize64(a * b, fmt)
    return quantize64(p + c, fmt).float()


# ---------------------------------------------------------------------------
# IEEE DP (binary64) ops: the paper's DP CMA / DP FMA units
# ---------------------------------------------------------------------------
def dp_mul(a, b, device=None) -> torch.Tensor:
    a, b = _f64(a, b, device=device)
    return a * b


def dp_add(a, b, device=None) -> torch.Tensor:
    a, b = _f64(a, b, device=device)
    return a + b


def dp_cma(a, b, c, device=None) -> torch.Tensor:
    """DP cascade: the f64 multiply and add ARE the two RNE roundings."""
    a, b, c = _f64(a, b, c, device=device)
    p = a * b
    return p + c


def dp_fma(a, b, c, device=None) -> torch.Tensor:
    """Correctly-rounded DP fused multiply-add (Boldo-Melquiond)."""
    a, b, c = _f64(a, b, c, device=device)
    ph, pl = _two_product(a, b)  # ph + pl == a*b exactly
    sh, se = _two_sum(ph, c)  # sh + se == ph + c exactly
    # exact low-order sum, rounded to odd to protect the final RNE
    t, te = _two_sum(pl, se)
    t_odd = _round_to_odd(t, te)
    return sh + t_odd


# ---------------------------------------------------------------------------
# Dot-product / accumulation semantics (the framework-facing policies)
# ---------------------------------------------------------------------------
def dot_fused(a_vec, b_vec, fmt: FloatFormat, device=None) -> torch.Tensor:
    """Sequential fused accumulation: acc = RNE_F(acc + a_k*b_k) per step,
    what a single FMA unit computes for a dot product.
    Shapes: a_vec, b_vec: (..., K) -> (...,), f32."""
    a, b = _f64(a_vec, b_vec, device=device)
    acc = torch.zeros(a.shape[:-1], dtype=F64, device=a.device)
    for k in range(a.shape[-1]):
        p = a[..., k] * b[..., k]
        s, e = _two_sum(p, acc)
        acc = quantize64(_round_to_odd(s, e), fmt)
    return acc.float()


def dot_cascade(a_vec, b_vec, fmt: FloatFormat, forwarding: bool = False,
                device=None) -> torch.Tensor:
    """Sequential cascade accumulation (CMA unit).

    forwarding=False: p = RNE_F(a*b); acc = RNE_F(acc + p) (2 roundings/step)
    forwarding=True : the accumulator is held in f64 (the un-rounded
      intermediate the hardware forwards) and rounded to F once at the end.
    """
    a, b = _f64(a_vec, b_vec, device=device)
    acc = torch.zeros(a.shape[:-1], dtype=F64, device=a.device)
    for k in range(a.shape[-1]):
        p = quantize64(a[..., k] * b[..., k], fmt)  # the multiplier rounds
        acc = acc + p
        if not forwarding:
            acc = quantize64(acc, fmt)
    out = quantize64(acc, fmt) if forwarding else acc
    return out.float()


def dot(a_vec, b_vec, fmt: FloatFormat = FP32, style: str = "fma",
        forwarding: bool = False, device=None) -> torch.Tensor:
    """Dispatch on FMAC style: the four FPMax units as dot-product
    semantics."""
    if style == "fma":
        return dot_fused(a_vec, b_vec, fmt, device=device)
    if style == "cma":
        return dot_cascade(a_vec, b_vec, fmt, forwarding=forwarding,
                           device=device)
    raise ValueError(f"unknown FMAC style {style!r}")
