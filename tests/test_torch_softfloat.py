"""The port's softfloat (bit-exact FMA/CMA scalar semantics in float64
torch) and ``emulated_dot`` against the JAX package's.

The JAX package's softfloat runs under ``jax.experimental.enable_x64``, a
name jax 0.9.0 dropped, so the reference values are computed in one
subprocess that restores it (``jax.experimental.enable_x64 =
jax.enable_x64``) and pickles them back; the alias never enters this
process (see tests/test_torch_dse.py).  Tolerances:

  * bitwise: ``quantize64`` (ties, overflow, +-inf, NaN and +-0 included),
    ``sf_mul/sf_add/sf_fma/sf_cma`` per format, ``dp_mul/dp_add/dp_cma/
    dp_fma``, ``dot_fused``/``dot_cascade`` (both forwarding modes) and
    ``emulated_dot`` for every style;
  * exact: ``dp_fma`` against the correctly rounded ``fractions.Fraction``
    value of a*b + c (Python 3.12 has no ``math.fma``).

The operands are normal-range: XLA:CPU flushes subnormals to zero in
float64 as well as float32 (DAZ/FTZ), where IEEE PyTorch keeps them, so the
draws keep every product and sum out of the subnormal ranges.
"""
import os
import pickle
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.core import softfloat as sf
from repro_torch.numerics import emulated_dot, get_format

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CPU = "cpu"
FORMATS = ("fp32", "tf32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")
STYLES = ("fused", "cascade", "cascade_fwd")
N = 4096
DOT = (24, 64)


def _draws(seed):
    """Operands for every check, from numpy: normal-range float64 draws
    (quantize64 gets ties and specials on top), per-format grid operands
    come from quantize64 on the JAX side and are pickled back."""
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal((3, N)) * np.exp2(rng.integers(-6, 7, (3, N)))
    dot = rng.standard_normal((2,) + DOT)
    return raw, dot


def _ties(fmt):
    """Exact midpoints between neighbours of fmt's grid in [1, 2) and
    [2**-3, 2**-2), both signs, plus overflow and the specials."""
    m = fmt.man_bits
    j = np.arange(0, 2 ** min(m, 10))
    mid = 1.0 + (2 * j + 1) * 2.0 ** -(m + 1)
    out = np.concatenate([mid, -mid, mid / 8, -mid / 8])
    over = fmt.max_finite * (1 + 2.0 ** -(m + 2)) if m < 52 else 1e308
    return np.concatenate([out, [0.0, -0.0, np.inf, -np.inf, np.nan,
                                 fmt.max_finite, over, -over * 4]])


_REF = r"""
import pickle, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64  # the name jax 0.9.0 dropped
import jax.numpy as jnp
import numpy as np
from repro.core import softfloat as js
from repro.numerics import emulated_dot, get_format

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
with jax.enable_x64():
    for f in inp["formats"]:
        fmt = get_format(f)
        out["q64", f] = np.asarray(js.quantize64(jnp.asarray(inp["ties"][f]),
                                                 fmt))
        ops = [np.asarray(js.quantize64(jnp.asarray(r), fmt)).astype(
            np.float32) for r in inp["raw"]]
        out["ops", f] = ops
        a, b, c = (jnp.asarray(o) for o in ops)
        out["q64_raw", f] = np.asarray(js.quantize64(
            jnp.asarray(inp["raw"][0]), fmt))
        for name in ("sf_mul", "sf_add"):
            out[name, f] = np.asarray(getattr(js, name)(a, b, fmt))
        for name in ("sf_fma", "sf_cma"):
            out[name, f] = np.asarray(getattr(js, name)(a, b, c, fmt))
        da, db = (np.asarray(js.quantize64(jnp.asarray(x), fmt)).astype(
            np.float32) for x in inp["dot"])
        out["dot_ops", f] = (da, db)
        out["dot_fused", f] = np.asarray(js.dot_fused(jnp.asarray(da),
                                                      jnp.asarray(db), fmt))
        for fw in (False, True):
            out["dot_cascade", f, fw] = np.asarray(js.dot_cascade(
                jnp.asarray(da), jnp.asarray(db), fmt, forwarding=fw))
        for style in inp["styles"]:
            out["emulated_dot", f, style] = np.asarray(emulated_dot(
                jnp.asarray(da), jnp.asarray(db), fmt=f, style=style))
        out["dot", f] = np.asarray(js.dot(jnp.asarray(da), jnp.asarray(db),
                                          fmt, style="cma", forwarding=True))
    raw = [jnp.asarray(r) for r in inp["raw"]]
    for name in ("dp_mul", "dp_add"):
        out[name] = np.asarray(getattr(js, name)(raw[0], raw[1]))
    for name in ("dp_cma", "dp_fma"):
        out[name] = np.asarray(getattr(js, name)(*raw))
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's values, computed in a subprocess (see above)."""
    d = tmp_path_factory.mktemp("softfloat_ref")
    raw, dot = _draws(0)
    inp = dict(formats=FORMATS, styles=STYLES, raw=raw, dot=dot,
               ties={f: _ties(get_format(f)) for f in FORMATS})
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


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits_equal(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    u = np.uint32 if got.dtype == np.float32 else np.uint64
    same = (got.view(u) == want.view(u)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (what, int((~same).sum()))


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize64_bitwise(ref, fmt):
    f = get_format(fmt)
    _bits_equal(sf.quantize64(_t(ref["inputs"]["ties"][fmt]), f),
                ref["q64", fmt], "ties")
    _bits_equal(sf.quantize64(_t(ref["inputs"]["raw"][0]), f),
                ref["q64_raw", fmt], "draws")


@pytest.mark.parametrize("fmt", FORMATS)
def test_sf_ops_bitwise(ref, fmt):
    f = get_format(fmt)
    a, b, c = (_t(o) for o in ref["ops", fmt])
    for name in ("sf_mul", "sf_add"):
        _bits_equal(getattr(sf, name)(a, b, f), ref[name, fmt], name)
    for name in ("sf_fma", "sf_cma"):
        _bits_equal(getattr(sf, name)(a, b, c, f), ref[name, fmt], name)
    # the fused and the cascade unit really differ on this workload
    assert not np.array_equal(ref["sf_fma", fmt], ref["sf_cma", fmt])


def test_dp_ops_bitwise(ref):
    raw = [_t(r) for r in ref["inputs"]["raw"]]
    for name in ("dp_mul", "dp_add"):
        _bits_equal(getattr(sf, name)(raw[0], raw[1]), ref[name], name)
    for name in ("dp_cma", "dp_fma"):
        _bits_equal(getattr(sf, name)(*raw), ref[name], name)


def test_dp_fma_exact_against_fraction(ref):
    a, b, c = ref["inputs"]["raw"]
    got = sf.dp_fma(_t(a), _t(b), _t(c)).numpy()
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a, b, c)])
    _bits_equal(got, want, "dp_fma vs Fraction")
    # the single rounding shows: the cascade differs somewhere
    assert not np.array_equal(sf.dp_cma(_t(a), _t(b), _t(c)).numpy(), want)
    # cancellation: a*b + (-RNE(a*b)) is the exact product error
    p = a * b
    got = sf.dp_fma(_t(a), _t(b), _t(-p)).numpy()
    want = np.array([float(Fraction(x) * Fraction(y) - Fraction(q))
                     for x, y, q in zip(a, b, p)])
    _bits_equal(got, want, "dp_fma cancellation")


@pytest.mark.parametrize("fmt", FORMATS)
def test_dots_bitwise(ref, fmt):
    f = get_format(fmt)
    da, db = (_t(o) for o in ref["dot_ops", fmt])
    _bits_equal(sf.dot_fused(da, db, f), ref["dot_fused", fmt], "fused")
    for fw in (False, True):
        _bits_equal(sf.dot_cascade(da, db, f, forwarding=fw),
                    ref["dot_cascade", fmt, fw], f"cascade fwd={fw}")
    _bits_equal(sf.dot(da, db, f, style="cma", forwarding=True),
                ref["dot", fmt], "dot dispatch")
    for style in STYLES:
        _bits_equal(emulated_dot(da, db, fmt=fmt, style=style),
                    ref["emulated_dot", fmt, style], style)


def test_entry_points_follow_the_operands_device(ref):
    """Tensor operands keep their device; other operands go to the card
    unless the caller asks for the CPU."""
    da, db = ref["dot_ops", "bf16"]
    got = emulated_dot(np.array(da), np.array(db), fmt="bf16", device=CPU)
    _bits_equal(got, ref["emulated_dot", "bf16", "fused"], "numpy in")
    assert sf.dp_fma(1.0, 2.0, 3.0, device=CPU).item() == 5.0
    with pytest.raises(ValueError, match="style"):
        emulated_dot(_t(da), _t(db), fmt="bf16", style="sideways")
    with pytest.raises(ValueError, match="FMAC style"):
        sf.dot(_t(da), _t(db), style="sideways")


def test_python_floats_and_lists_stay_float64():
    """Python floats and lists enter as float64, not torch's default
    float32: 0.1, 0.2 and 0.3 are not on the fp32 grid."""
    xs, ys, zs = [0.1, 1.0 / 3.0, 2.0 ** -30 + 1.0], [0.2, 0.7, 3.1], \
        [0.3, -0.2, 1e-17]
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(xs, ys, zs)]
    assert sf.dp_fma(0.1, 0.2, 0.3, device=CPU).item() == want[0]
    assert sf.dp_fma(xs, ys, zs, device=CPU).tolist() == want
    cma = [float(Fraction(x * y) + Fraction(z))
           for x, y, z in zip(xs, ys, zs)]
    assert sf.dp_cma(xs, ys, zs, device=CPU).tolist() == cma
    assert sf.quantize64(xs, get_format("fp64"), device=CPU).tolist() == xs
