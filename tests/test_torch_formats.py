"""The port's round-to-format against the JAX package, bitwise.

Same inputs (numpy, from a seed) through ``repro.core.formats.quantize``
(jitted, the JAX tests' contract) and ``repro_torch.core.formats.quantize``:
every registry format the f32 path hosts, plus an FPGen point, with specials,
the overflow edge and target-format subnormals.  f32-subnormal inputs are
excluded: XLA:CPU treats them as zero (DAZ), so JAX returns such an input
unchanged through the ``x == 0`` branch, where IEEE PyTorch (and the CUDA
kernel) round it.  The card check keeps the kernel bitwise against the plain
version including f32 subnormals.

Also excluded: inputs whose rounding scale 2**(q_exp - man_bits) lies below
2**-126 (the formats with 8 exponent bits, for |x| < 2**(man_bits - 126)).
XLA:CPU folds ``x / scale_lo / scale_hi`` into ``x / (scale_lo * scale_hi)``,
flushes that subnormal product to zero, and returns +-inf for such inputs;
the port keeps the two exact divisions and returns the IEEE-rounded value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.numerics import registry as jreg
from repro_torch.core import formats as tf
from repro_torch.numerics import quantize_tensor, registry as treg

F32_MIN_NORMAL = 2.0 ** -126
NAMES = ["fp32", "tf32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2", "e5m7"]


def _fmt_pair(name):
    if name == "e5m7":  # an FPGen point, registered in both registries
        return jreg.fpgen_format(5, 7), treg.fpgen_format(5, 7)
    return jf.REGISTRY[name], tf.REGISTRY[name]


@np.errstate(over="ignore", divide="ignore")
def _inputs(jfmt, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal(4096) * np.exp2(r.integers(-130, 130, 4096))
    mf, ulp_top = jfmt.max_finite, 2.0 ** (jfmt.emax - jfmt.man_bits)
    sub = jfmt.min_subnormal * np.arange(0, 2 ** jfmt.man_bits + 3, 0.5)
    edge = [mf, mf + ulp_top / 2, mf + ulp_top / 4, mf + ulp_top,
            np.nextafter(np.float32(mf + ulp_top / 2), np.float32(0)),
            jfmt.min_normal, jfmt.min_normal * 1.5]
    special = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 0.5, 3e38]
    x = np.concatenate([x, sub[:512], -sub[:512], edge, np.negative(edge),
                        special]).astype(np.float32)
    e = np.floor(np.log2(np.abs(x.astype(np.float64))))
    one_half_scale = np.maximum(e, jfmt.emin) - jfmt.man_bits >= -126
    keep = (x == 0) | ~np.isfinite(x) | (
        (np.abs(x) >= F32_MIN_NORMAL) & one_half_scale)
    return x[keep]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", NAMES)
def test_quantize_bitwise_vs_jax(name):
    jfmt, tfmt = _fmt_pair(name)
    x = _inputs(jfmt)
    want = jax.jit(lambda v: jf.quantize(v, jfmt))(jnp.asarray(x))
    got = tf.quantize(torch.from_numpy(x), tfmt)
    mism = _bits(want) != _bits(got.numpy())
    assert not mism.any(), (name, x[mism][:8], np.asarray(want)[mism][:8],
                            got.numpy()[mism][:8])


@pytest.mark.parametrize("name", NAMES)
def test_format_constants_equal(name):
    jfmt, tfmt = _fmt_pair(name)
    for attr in ("exp_bits", "man_bits", "name", "bias", "emax", "emin",
                 "max_finite", "min_normal", "min_subnormal", "bits"):
        assert getattr(jfmt, attr) == getattr(tfmt, attr), attr
    assert jfmt.ulp(3) == tfmt.ulp(3)


def test_registry_names_and_classes_match():
    assert set(jf.REGISTRY) == set(tf.REGISTRY)
    for spec in jreg.REGISTRY:
        t = treg.REGISTRY.get(spec.name)
        assert (t.precision_class, t.is_native, t.bits) == \
            (spec.precision_class, spec.is_native, spec.bits)
    treg.fpgen_format(5, 7), jreg.fpgen_format(5, 7)
    for prec in ("sp", "dp"):
        assert [f.name for f in treg.REGISTRY.formats_for(prec)] == \
            [f.name for f in jreg.REGISTRY.formats_for(prec)]
    assert tf.get_format("e5m7") == treg.fpgen_format(5, 7)


def test_quantize_tensor_cpu_is_the_plain_version():
    x = torch.from_numpy(_inputs(jf.BF16, seed=1))
    got = quantize_tensor(x, fmt="bf16", device="cpu")
    assert torch.equal(got.view(torch.int32),
                       tf.quantize(x, tf.BF16).view(torch.int32))
    with pytest.raises(ValueError):
        quantize_tensor(x, fmt="bf16", impl="interpret", device="cpu")
