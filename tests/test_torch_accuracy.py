"""The port's exact-rational accuracy oracle against the JAX package's.

``numerics/accuracy`` is pure Python ``fractions.Fraction`` arithmetic on
the host, so the port's copy must give the reference's results float for
float.  The reference values are computed in one subprocess that restores
``jax.experimental.enable_x64`` (dropped in jax 0.9.0) before importing the
JAX package's numerics, and pickles them back; the alias never enters this
process (see tests/test_torch_dse.py).  Checked:

  * ``rne_fraction`` and ``dot_exact_steps`` equal (exact rationals) on
    seeded draws, ties, overflow and every style;
  * ``AccuracyModel.evaluate`` dicts equal for every (format, style) of the
    SP and DP ladders (``REGISTRY.formats_for``), and for a small model on
    a narrow FPGen point whose samples overflow;
  * the oracle equals the port's bit-exact ``emulated_dot`` (float64 torch
    on the CPU) wherever the format does not overflow;
  * the ladder is monotone and results are cached.
"""
import math
import os
import pickle
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.core.formats import FloatFormat
from repro_torch.numerics import (DEFAULT_ACCURACY_MODEL, REGISTRY,
                                  AccuracyModel, dot_exact_steps,
                                  emulated_dot, get_format, rne_fraction)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
STYLES = ("fused", "cascade", "cascade_fwd")
SP = tuple(f.name for f in REGISTRY.formats_for("sp"))
PAIRS = [(f, s) for f in SP + ("fp64",) for s in STYLES]
NARROW = (2, 1)  # an fp4 FPGen point: 3-sigma draws overflow it

_REF = r"""
import pickle, sys
from fractions import Fraction
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64  # the name jax 0.9.0 dropped
import numpy as np
from repro.core.formats import FloatFormat
from repro.numerics import AccuracyModel, get_format
from repro.numerics.accuracy import dot_exact_steps, rne_fraction

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
for f in inp["formats"]:
    fmt = get_format(f)
    got = []
    for v in inp["values"]:
        try:
            got.append(rne_fraction(v, fmt))
        except OverflowError:
            got.append("overflow")
    out["rne", f] = got
    a = [rne_fraction(Fraction(float(x)), fmt) for x in inp["dot"][0]]
    b = [rne_fraction(Fraction(float(x)), fmt) for x in inp["dot"][1]]
    for s in inp["styles"]:
        out["steps", f, s] = dot_exact_steps(a, b, fmt, s)
model = AccuracyModel()
for f, s in inp["pairs"]:
    out["eval", f, s] = model.evaluate(f, s)
small = AccuracyModel(k=16, n_samples=4)
for fmt in (FloatFormat(*inp["narrow"]), FloatFormat(5, 0)):
    for s in inp["styles"]:
        out["small", fmt.name, s] = small.evaluate(fmt, s)
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
"""


def _values():
    rng = np.random.default_rng(3)
    vals = [Fraction(float(x)) for x in
            rng.standard_normal(64) * np.exp2(rng.integers(-20, 20, 64))]
    vals += [Fraction(0), Fraction(1) + Fraction(1, 2 ** 8),
             Fraction(1) + Fraction(3, 2 ** 8), Fraction(-3, 2 ** 11),
             Fraction(1, 3), Fraction(-2, 7), Fraction(2) ** 17,
             Fraction(240), Fraction(248), Fraction(65520),
             Fraction(2) ** -140, Fraction(3, 2) * Fraction(2) ** -135]
    return vals


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's values, computed in a subprocess (see above)."""
    d = tmp_path_factory.mktemp("accuracy_ref")
    rng = np.random.default_rng(4)
    inp = dict(formats=SP + ("fp64",), styles=STYLES, pairs=PAIRS,
               narrow=NARROW, values=_values(),
               dot=rng.standard_normal((2, 40)))
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _REF, str(d / "in.pkl"),
                           str(d / "out.pkl")], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(d / "out.pkl", "rb") as fh:
        out = pickle.load(fh)
    out["inputs"] = inp
    return out


@pytest.mark.parametrize("fmt", SP + ("fp64",))
def test_rne_fraction_and_steps_equal(ref, fmt):
    f = get_format(fmt)
    got = []
    for v in ref["inputs"]["values"]:
        try:
            got.append(rne_fraction(v, f))
        except OverflowError:
            got.append("overflow")
    assert got == ref["rne", fmt]
    raw = ref["inputs"]["dot"]
    a = [rne_fraction(Fraction(float(x)), f) for x in raw[0]]
    b = [rne_fraction(Fraction(float(x)), f) for x in raw[1]]
    for style in STYLES:
        assert dot_exact_steps(a, b, f, style) == ref["steps", fmt, style]
    with pytest.raises(ValueError, match="style"):
        dot_exact_steps(a, b, f, "sideways")


@pytest.mark.parametrize("fmt,style", PAIRS,
                         ids=[f"{f}-{s}" for f, s in PAIRS])
def test_evaluate_equals_reference(ref, fmt, style):
    assert DEFAULT_ACCURACY_MODEL.evaluate(fmt, style) == \
        ref["eval", fmt, style]


def test_narrow_points_scored_as_the_reference_scores_them(ref):
    small = AccuracyModel(k=16, n_samples=4)
    fp4 = FloatFormat(*NARROW)
    for fmt in (fp4, FloatFormat(5, 0)):
        for style in STYLES:
            assert small.evaluate(fmt, style) == \
                ref["small", fmt.name, style]
    assert small.rel_err(fp4) == math.inf
    assert small.evaluate(fp4)["overflow_frac"] > 0


@pytest.mark.parametrize("fmt", SP)
def test_oracle_equals_emulated_dot(fmt):
    """Two derivations of the same unit semantics: the Fraction step
    simulation and the bit-exact float64 softfloat accumulation, on the
    oracle's own samples."""
    f = get_format(fmt)
    model = AccuracyModel()
    raw = model._samples()
    checked = 0
    for style in STYLES:
        a_all, b_all, want = [], [], []
        for pair in raw:
            try:
                a = [rne_fraction(Fraction(float(x)), f) for x in pair[0]]
                b = [rne_fraction(Fraction(float(x)), f) for x in pair[1]]
                w = dot_exact_steps(a, b, f, style)
            except OverflowError:
                continue
            a_all.append([float(x) for x in a])
            b_all.append([float(x) for x in b])
            want.append(float(np.float32(float(w))))
        got = emulated_dot(torch.tensor(a_all, dtype=torch.float32),
                           torch.tensor(b_all, dtype=torch.float32),
                           fmt=f, style=style)
        assert got.tolist() == want, style
        checked += len(want)
    assert checked > 0


def test_ladder_is_monotone_and_cached():
    errs = [DEFAULT_ACCURACY_MODEL.rel_err(f, "fused")
            for f in ("fp64", "fp32", "fp16", "bf16", "fp8_e4m3")]
    assert all(a < b for a, b in zip(errs, errs[1:]))
    assert DEFAULT_ACCURACY_MODEL.evaluate("bf16", "fused")[
        "accuracy_bits"] > 5
    assert DEFAULT_ACCURACY_MODEL.evaluate("bf16", "fused") is \
        DEFAULT_ACCURACY_MODEL.evaluate("bf16", "fused")
