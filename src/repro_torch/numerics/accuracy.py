"""Exact-rational accuracy oracle for (format, accumulation-style) pairs
(counterpart of ``repro.numerics.accuracy``, pure Python on the host).

Accuracy-constrained tuning needs a *trustworthy* number for "how wrong is a
dot product computed in bf16 with cascade accumulation": a float-based
estimate would be circular (it would itself round).  This module simulates
the unit semantics with ``fractions.Fraction`` — every rounding is the exact
RNE of an exact rational, mirroring ``softfloat``'s bit-exact step functions
— on sampled dot-product workloads, and reports normwise relative errors.

``AccuracyModel.rel_err(fmt, style)`` is the scalar the tuner consumes: the
RMS normwise relative error over sampled K-length dot products.  It feeds
``core.objective.accuracy_constraint`` so ``autotune`` /
``tune_chip`` can search formats under an ``accuracy_slo`` ceiling.

The per-step semantics match ``softfloat`` / ``emulated_dot`` exactly:

  * ``fused``        : acc = RNE_F(acc + a_k * b_k)       one rounding/step
  * ``cascade``      : p = RNE_F(a*b); acc = RNE_F(acc+p) two roundings/step
  * ``cascade_fwd``  : p = RNE_F(a*b); acc += p exact; final RNE_F(acc)
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.formats import FloatFormat
from repro_torch.numerics.emulate import STYLES
from repro_torch.numerics.registry import get_format

_HALF = Fraction(1, 2)


def _rne_int(q: Fraction) -> int:
    """Round a rational to the nearest integer, ties to even (exact)."""
    fl = q.numerator // q.denominator
    rem = q - fl
    if rem > _HALF:
        return fl + 1
    if rem < _HALF:
        return fl
    return fl if fl % 2 == 0 else fl + 1


def rne_fraction(v: Fraction, fmt: FloatFormat) -> Fraction:
    """Exact RNE of a rational onto ``fmt``'s grid, from first principles.

    Semantics mirror ``softfloat.quantize64``: the exponent clamp makes the
    grid flush to the fixed subnormal quantum, IEEE overflow rounds past
    ``max_finite`` to infinity (returned as ``Fraction`` cannot hold inf,
    so overflow raises ``OverflowError`` — callers treat it as a failed
    sample for the format).
    """
    if v == 0:
        return Fraction(0)
    av = abs(v)
    # exact binade: largest e with 2**e <= |v|
    e = math.frexp(float(av))[1] - 1 if av < Fraction(2) ** 1024 \
        else fmt.emax + 1
    while Fraction(2) ** e > av:
        e -= 1
    while Fraction(2) ** (e + 1) <= av:
        e += 1
    q_exp = min(max(e, fmt.emin), fmt.emax)
    scale = Fraction(2) ** (q_exp - fmt.man_bits)
    y = _rne_int(v / scale) * scale
    if abs(y) > Fraction(fmt.max_finite):
        raise OverflowError(f"{float(v)} overflows {fmt.name}")
    return y


def dot_exact_steps(a, b, fmt: FloatFormat, style: str) -> Fraction:
    """Dot product under the exact per-step rounding schedule of ``style``.

    ``a``/``b`` are sequences of rationals already on ``fmt``'s grid; the
    result is the exact rational value the hardware unit would return.
    """
    if style not in STYLES:
        raise ValueError(f"style must be one of {STYLES}, got {style!r}")
    acc = Fraction(0)
    for ak, bk in zip(a, b):
        if style == "fused":
            acc = rne_fraction(acc + ak * bk, fmt)
        elif style == "cascade":
            acc = rne_fraction(acc + rne_fraction(ak * bk, fmt), fmt)
        else:  # cascade_fwd: rounded product, extended accumulator
            acc = acc + rne_fraction(ak * bk, fmt)
    if style == "cascade_fwd":
        acc = rne_fraction(acc, fmt)
    return acc


class AccuracyModel:
    """Sampled-workload accuracy oracle, cached per (format, style).

    ``k`` is the dot length (the dependence-chain depth a unit accumulates
    over before results are combined at higher precision — one kernel k-block
    is 128; the default 64 is a conservative mid-size reduction), and
    ``n_samples`` standard-normal operand vectors are drawn once (fixed
    seed) and quantized onto each format's grid before simulation, so every
    format is scored on the same underlying workload.
    """

    def __init__(self, k: int = 64, n_samples: int = 24, seed: int = 0):
        self.k = int(k)
        self.n_samples = int(n_samples)
        self.seed = int(seed)
        self._raw = None  # lazily drawn (n_samples, 2, k) float64
        self._cache: Dict[Tuple[str, str], Dict[str, float]] = {}

    def _samples(self) -> np.ndarray:
        if self._raw is None:
            rng = np.random.default_rng(self.seed)
            self._raw = rng.standard_normal((self.n_samples, 2, self.k))
        return self._raw

    def evaluate(self, fmt: "FloatFormat | str",
                 style: str = "fused") -> Dict[str, float]:
        """Error statistics of ``fmt`` x ``style`` on the sampled workload.

        Returns ``rel_err_rms`` / ``rel_err_max`` (normwise: error over
        ``sum_k |a_k b_k|``, stable when the exact dot nearly cancels),
        ``accuracy_bits`` (-log2 of the RMS) and ``overflow_frac`` (samples
        whose accumulation left the format's finite range — such a format
        is infinitely wrong for the workload: rel_err inf).
        """
        fmt = get_format(fmt)
        key = (fmt.name, style)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        errs, overflows = [], 0
        for pair in self._samples():
            try:
                # operand quantization can itself overflow a narrow-range
                # format (e.g. an fp4 FPGen point vs a 3-sigma draw): that
                # is an overflow sample, not a crash
                a = [rne_fraction(Fraction(float(x)), fmt) for x in pair[0]]
                b = [rne_fraction(Fraction(float(x)), fmt) for x in pair[1]]
                got = dot_exact_steps(a, b, fmt, style)
            except OverflowError:
                overflows += 1
                continue
            exact = sum((ak * bk for ak, bk in zip(a, b)), Fraction(0))
            norm = sum((abs(ak * bk) for ak, bk in zip(a, b)), Fraction(0))
            errs.append(float(abs(got - exact) / norm) if norm else 0.0)
        if overflows == self.n_samples:
            rms = emax = math.inf
        else:
            rms = float(np.sqrt(np.mean(np.square(errs))))
            emax = float(np.max(errs))
            if overflows:
                rms = emax = math.inf  # any overflow disqualifies the format
        out = dict(rel_err_rms=rms, rel_err_max=emax,
                   accuracy_bits=(-math.log2(rms) if 0 < rms < math.inf
                                  else (math.inf if rms == 0 else 0.0)),
                   overflow_frac=overflows / self.n_samples)
        self._cache[key] = out
        return out

    def rel_err(self, fmt: "FloatFormat | str",
                style: str = "fused") -> float:
        """The scalar the tuner constrains: RMS normwise relative error."""
        return self.evaluate(fmt, style)["rel_err_rms"]

    def accuracy_bits(self, fmt: "FloatFormat | str",
                      style: str = "fused") -> float:
        return self.evaluate(fmt, style)["accuracy_bits"]


#: process-default oracle; autotune/chip consult it unless handed another
DEFAULT_ACCURACY_MODEL = AccuracyModel()
