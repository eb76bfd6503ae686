"""The port's selective-scan kernels' plain versions against the JAX package.

K6 (``ssm_scan``) and K5 (``ssm_scan_quantized``) run on the CPU here as
their plain versions, which the CUDA kernels equal bitwise on the card
(tests/test_torch_cuda.py).  The JAX side runs its Pallas kernels in
interpret mode and its own plain versions, on the same seeded numpy inputs.
Tolerances:

  * y and h_last: within 1e-5 * max|ref|.  Both sides round every op to
    float32, but XLA sums the readout over N in its own order (and may fuse
    a product into the sum) where the port sums n = 0..N-1 left to right;
  * y with ``out_fmt``: within one ``out_fmt`` ulp of |y|, since a last-bit
    difference before the rounding can move y to the neighbouring grid
    point;
  * the rounded operands: bitwise.  With N = 1, two tokens and b = 0 at the
    second, y and h_last are products of two rounded operands, exact in
    float32, so they show the rounding alone.  f32-subnormal inputs are
    excluded: XLA:CPU treats them as zero (tests/test_torch_formats.py).

The dispatch of ``emulated_ssm_scan`` and ``policy_ssm_scan`` follows the
JAX package's, with the same ``ValueError`` on a bad S or D.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import get_format as jget_format
from repro.kernels import fused as jfused
from repro.kernels import ssm_scan as jssm_scan
from repro.models.numerics import EmulatedPolicy as JPolicy
from repro.models.numerics import policy_ssm_scan as jpolicy_ssm_scan
from repro.numerics import emulated_ssm_scan as jemulated_ssm_scan
from repro_torch.kernels import fused, ssm_scan
from repro_torch.models.numerics import EmulatedPolicy, policy_ssm_scan
from repro_torch.numerics import emulated_ssm_scan, get_format

FMTS = [None, "bf16", "fp8_e4m3"]


def _inputs(shape, seed=0):
    B, S, D, N = shape
    r = np.random.default_rng(seed)
    a = r.uniform(0.5, 1.0, (B, S, D, N)).astype(np.float32)
    b = r.standard_normal((B, S, D, N)).astype(np.float32)
    c = r.standard_normal((B, S, N)).astype(np.float32)
    return a, b, c


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _within(got, want, rel, what):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    bound = rel * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (what, bound)


def _ulp(x, fmt):
    """One ulp of ``fmt`` at |x| (normal or subnormal)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(np.maximum(e, 1 - fmt.bias) - fmt.man_bits)


@pytest.mark.parametrize("shape,chunk,bd", [((2, 64, 16, 8), 32, 8),
                                            ((1, 48, 24, 16), 16, 24),
                                            ((3, 32, 8, 5), 32, 256)],
                         ids=["tiled", "one-d-tile", "odd-n"])
def test_ssm_scan_matches_jax(shape, chunk, bd):
    a, b, c = _inputs(shape)
    got_y, got_h = ssm_scan.ssm_scan(*_t(a, b, c), chunk=chunk, bd=bd)
    for want_y, want_h in (jssm_scan.ssm_scan(a, b, c, chunk=chunk, bd=bd,
                                              interpret=True),
                           jssm_scan.ssm_scan_ref(a, b, c)):
        _within(got_y, want_y, 1e-5, "y")
        _within(got_h, want_h, 1e-5, "h_last")


@pytest.mark.parametrize("out_fmt", [None, "fp16"], ids=["f32-out",
                                                         "fp16-out"])
@pytest.mark.parametrize("fmt", FMTS, ids=["none", "bf16", "fp8_e4m3"])
def test_ssm_scan_quantized_matches_jax(fmt, out_fmt):
    a, b, c = _inputs((2, 64, 16, 8), seed=1)
    jf = jget_format(fmt) if fmt else None
    jo = jget_format(out_fmt) if out_fmt else None
    tf = get_format(fmt) if fmt else None
    to = get_format(out_fmt) if out_fmt else None
    got_y, got_h = fused.ssm_scan_quantized(*_t(a, b, c), fmt=tf, out_fmt=to,
                                            chunk=32, bd=8)
    for want_y, want_h in (jfused.ssm_scan_quantized(a, b, c, fmt=jf,
                                                     out_fmt=jo, chunk=32,
                                                     bd=8, interpret=True),
                           jfused.ssm_scan_quantized_ref(a, b, c, fmt=jf,
                                                         out_fmt=jo)):
        _within(got_h, want_h, 1e-5, "h_last")
        if out_fmt is None:
            _within(got_y, want_y, 1e-5, "y")
        else:
            want_y = np.asarray(want_y)
            got = got_y.numpy()
            ulp = _ulp(np.maximum(np.abs(got), np.abs(want_y)), jo)
            assert (np.abs(got - want_y) <= ulp).all()


@pytest.mark.parametrize("fmt", ["bf16", "fp16", "fp8_e4m3"])
def test_rounded_operands_bitwise(fmt):
    """N = 1, S = 2, b = 0 at the second token: y = [q(b0) q(c0),
    q(a1) q(b0) q(c1)] and h_last = q(a1) q(b0), exact products of the
    rounded operands."""
    r = np.random.default_rng(2)
    B, D = 3, 64
    a = (r.uniform(0.5, 1.0, (B, 2, D, 1))
         * np.exp2(r.integers(-6, 6, (B, 2, D, 1)))).astype(np.float32)
    b = (r.standard_normal((B, 2, D, 1))
         * np.exp2(r.integers(-6, 6, (B, 2, D, 1)))).astype(np.float32)
    b[:, 1] = 0.0
    c = r.standard_normal((B, 2, 1)).astype(np.float32)
    for x in (a, b, c):
        nz = x[x != 0]
        assert (np.abs(nz) >= np.finfo(np.float32).tiny).all()
    jf = jget_format(fmt)
    got_y, got_h = fused.ssm_scan_quantized(*_t(a, b, c),
                                            fmt=get_format(fmt), chunk=2)
    for want_y, want_h in (jfused.ssm_scan_quantized(a, b, c, fmt=jf,
                                                     chunk=2,
                                                     interpret=True),
                           jfused.ssm_scan_quantized_ref(a, b, c, fmt=jf)):
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
        np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    # and the rounding happened: unrounded operands give other bits
    plain_y, _ = ssm_scan.ssm_scan_ref(*_t(a, b, c))
    assert not torch.equal(plain_y, got_y)


def test_quantized_with_no_format_is_the_plain_scan():
    a, b, c = _t(*_inputs((2, 32, 16, 8), seed=3))
    y5, h5 = fused.ssm_scan_quantized(a, b, c, fmt=None, chunk=32)
    y6, h6 = ssm_scan.ssm_scan(a, b, c, chunk=32)
    assert torch.equal(y5, y6) and torch.equal(h5, h6)


BAD_TILING = [dict(chunk=48), dict(chunk=64, bd=12)]


@pytest.mark.parametrize("kw", BAD_TILING, ids=["bad-chunk", "bad-bd"])
def test_tiling_errors_match_jax(kw):
    a, b, c = _inputs((1, 64, 16, 4))
    with pytest.raises(ValueError, match="% chunk"):
        jssm_scan.ssm_scan(a, b, c, interpret=True, **kw)
    with pytest.raises(ValueError, match="% chunk"):
        jfused.ssm_scan_quantized(a, b, c, fmt=None, interpret=True, **kw)
    ta, tb, tc = _t(a, b, c)
    for call in (lambda: ssm_scan.ssm_scan(ta, tb, tc, **kw),
                 lambda: fused.ssm_scan_quantized(ta, tb, tc, fmt=None,
                                                  **kw),
                 lambda: emulated_ssm_scan(ta, tb, tc, fmt="bf16",
                                           impl="fused", device="cpu", **kw),
                 lambda: emulated_ssm_scan(ta, tb, tc, fmt="bf16",
                                           impl="interpret", device="cpu",
                                           **kw)):
        with pytest.raises(ValueError, match="% chunk"):
            call()
    # impl='ref' drops chunk and bd, in both packages
    want, _ = jemulated_ssm_scan(a, b, c, fmt="bf16", impl="ref", **kw)
    got, _ = emulated_ssm_scan(ta, tb, tc, fmt="bf16", impl="ref",
                               device="cpu", **kw)
    _within(got, want, 1e-5, "ref ignores the tiling")


def test_emulated_ssm_scan_dispatch():
    a, b, c = _t(*_inputs((2, 64, 16, 8), seed=4))
    want = fused.ssm_scan_quantized_ref(a, b, c, fmt=get_format("bf16"),
                                        out_fmt=get_format("bf16"))
    for impl in ("auto", "fused", "interpret", "ref"):
        got = emulated_ssm_scan(a, b, c, fmt="bf16", impl=impl,
                                out_fmt=get_format("bf16"), device="cpu")
        assert all(torch.equal(g, w) for g, w in zip(got, want)), impl
    with pytest.raises(ValueError, match="unknown impl"):
        emulated_ssm_scan(a, b, c, fmt="bf16", impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="bad scan shapes"):
        emulated_ssm_scan(a, b, c[:, :, :4], fmt=None, device="cpu")


@pytest.mark.parametrize("spec", [None, "inert", ("bf16", "fused"),
                                  ("fp8_e4m3", "cascade")],
                         ids=["none", "inert", "bf16", "fp8_e4m3"])
def test_policy_ssm_scan_matches_jax(spec):
    a, b, c = _inputs((2, 64, 16, 8), seed=5)

    class Inert:
        emulate = False
        fmt = "bf16"

    if spec is None or spec == "inert":
        jpol = tpol = None if spec is None else Inert()
        fmt = None
    else:
        jpol, tpol, fmt = JPolicy(*spec), EmulatedPolicy(*spec), spec[0]
    got_y, got_h = policy_ssm_scan(*_t(a, b, c), tpol, chunk=32, bd=8)
    want_y, want_h = jpolicy_ssm_scan(a, b, c, jpol, impl="interpret",
                                      chunk=32, bd=8)
    _within(got_y, want_y, 1e-5, "y")
    _within(got_h, want_h, 1e-5, "h_last")
    plain = fused.ssm_scan_quantized_ref(
        *_t(a, b, c), fmt=get_format(fmt) if fmt else None)
    assert torch.equal(got_y, plain[0]) and torch.equal(got_h, plain[1])
