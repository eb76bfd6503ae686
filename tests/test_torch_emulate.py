"""The port's emulated matmul against the JAX package's kernels.

The plain versions behind the port's ``fused_qmm`` (K1) and
``fma_emu_matmul`` (K3) wrappers — what they run on CPU tensors — against
the JAX kernels in interpret mode, on the same numpy inputs.  The two sides
take their f32 block dots in different summation orders, so they are held to
the format-ulp bound of the JAX package's own kernel tests
(tests/test_kernels.py): two ulps of the format at the magnitude of
|a| @ |b|.  The dispatch tests mirror tests/test_fused_kernels.py: 'auto'
equals 'ref' on the CPU, and routes to the kernel wrappers when the device
probe says CUDA.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.kernels import fused as jfused
from repro.kernels.fma_emu import fma_emu_matmul as j_fma_emu
from repro_torch.core import formats as tf
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fma_emu import fma_emu_matmul
from repro_torch.numerics import emulate, emulated_matmul, quantize_tensor

FMTS = ["bf16", "fp16", "fp8_e4m3", "tf32"]
STYLES = ["fused", "cascade", "cascade_fwd"]


def _ulp_bound(fmt, a, b, n=2):
    """Two format ulps at the accumulator's running magnitude, bounded by
    |a| @ |b| (a copy of tests/test_kernels.py::_ulp_bound in numpy)."""
    acc_mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    mag = np.maximum(acc_mag, fmt.min_normal)
    return np.exp2(np.floor(np.log2(mag)) - fmt.man_bits) * n * 1.01


def _operands(seed, a_shape=(61, 300), n=37, scale=1.0):
    r = np.random.default_rng(seed)
    a = (r.standard_normal(a_shape) * scale).astype(np.float32)
    b = (r.standard_normal((a_shape[-1], n)) * scale).astype(np.float32)
    return a, b


def _assert_within_bound(got, want, fmt, a, b):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    assert np.array_equal(got[~fin], want[~fin], equal_nan=True)
    with np.errstate(invalid="ignore"):
        err = np.abs(got - want)
    bound = np.broadcast_to(_ulp_bound(fmt, a, b), err.shape)
    assert (err[fin] <= bound[fin]).all(), err[fin].max()


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaled"])
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("style", STYLES)
def test_fused_qmm_plain_vs_jax_interpret(style, fmt, scaled):
    a, b = _operands(0, scale=64.0 if fmt == "fp8_e4m3" else 1.0)
    want = jfused.fused_qmm(jnp.asarray(a), jnp.asarray(b),
                            fmt=jf.REGISTRY[fmt], style=style, scaled=scaled,
                            interpret=True)
    got = tfused.fused_qmm(torch.from_numpy(a), torch.from_numpy(b),
                           fmt=tf.REGISTRY[fmt], style=style, scaled=scaled)
    _assert_within_bound(got, want, tf.REGISTRY[fmt], a, b)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("style", STYLES)
def test_fused_qmm_out_fmt_batched_vs_jax_interpret(style, fmt):
    """A batched 3-D a, rounded to an output format."""
    a, b = _operands(1, a_shape=(2, 61, 300))
    out = "bf16" if fmt == "fp16" else "fp16"
    want = jfused.fused_qmm(jnp.asarray(a), jnp.asarray(b),
                            fmt=jf.REGISTRY[fmt], style=style,
                            out_fmt=jf.REGISTRY[out], interpret=True)
    got = tfused.fused_qmm(torch.from_numpy(a), torch.from_numpy(b),
                           fmt=tf.REGISTRY[fmt], style=style,
                           out_fmt=tf.REGISTRY[out])
    # the final rounding to out_fmt can move a result by one of its ulps
    wider = tf.REGISTRY[out] if tf.REGISTRY[out].man_bits < \
        tf.REGISTRY[fmt].man_bits else tf.REGISTRY[fmt]
    _assert_within_bound(got, want, wider, a, b)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("style", STYLES)
def test_fma_emu_plain_vs_jax_interpret(style, fmt):
    a, b = _operands(2)
    want = j_fma_emu(jnp.asarray(a), jnp.asarray(b), fmt=jf.REGISTRY[fmt],
                     style=style, interpret=True)
    got = fma_emu_matmul(torch.from_numpy(a), torch.from_numpy(b),
                         fmt=tf.REGISTRY[fmt], style=style)
    _assert_within_bound(got, want, tf.REGISTRY[fmt], a, b)


def test_cpu_wrappers_count_no_launches():
    a, b = _operands(3)
    before = (tfused.fused_qmm.launches, fma_emu_matmul.launches)
    tfused.fused_qmm(torch.from_numpy(a), torch.from_numpy(b), fmt=tf.BF16)
    fma_emu_matmul(torch.from_numpy(a), torch.from_numpy(b), fmt=tf.BF16)
    assert (tfused.fused_qmm.launches, fma_emu_matmul.launches) == before


def test_scaled_rescues_fp8_overflow():
    r = np.random.default_rng(6)
    big = torch.from_numpy((r.standard_normal((16, 32)) * 1e6)
                           .astype(np.float32))
    w = torch.from_numpy((r.standard_normal((32, 16)) * 1e6)
                         .astype(np.float32))
    plain = tfused.fused_qmm_ref(big, w, fmt=tf.FP8_E4M3)
    scaled = tfused.fused_qmm_ref(big, w, fmt=tf.FP8_E4M3, scaled=True)
    assert not torch.isfinite(plain).all()
    assert torch.isfinite(scaled).all()


# ---------------------------------------------------------------------------
# dispatch: impl='auto' routes through the kernel wrappers iff on CUDA
# ---------------------------------------------------------------------------
def test_auto_dispatch_cpu_uses_ref():
    a, b = _operands(11, a_shape=(3, 8, 16), n=8)
    got = emulated_matmul(a, b, fmt="bf16", impl="auto", device="cpu")
    want = emulated_matmul(a, b, fmt="bf16", impl="ref", device="cpu")
    assert torch.equal(got, want)
    assert got.shape == (3, 8, 8)


def test_auto_dispatch_cuda_routes_to_kernel_wrappers(monkeypatch):
    from repro_torch.kernels import quantize_kernel
    monkeypatch.setattr(emulate, "_on_cuda", lambda dev: True)
    calls = []
    sentinel = torch.zeros((8, 8))
    monkeypatch.setattr(tfused, "fused_qmm",
                        lambda *a, **kw: calls.append("qmm") or sentinel)
    monkeypatch.setattr(quantize_kernel, "quantize_nd",
                        lambda *a, **kw: calls.append("quantize") or sentinel)
    a, b = _operands(12, a_shape=(8, 16), n=8)
    emulated_matmul(a, b, fmt="bf16", impl="auto", device="cpu")
    quantize_tensor(a, fmt="bf16", device="cpu")
    assert calls == ["qmm", "quantize"]


def test_pallas_impl_routes_to_fma_emu(monkeypatch):
    import repro_torch.kernels.fma_emu as fma_mod
    calls = []
    monkeypatch.setattr(fma_mod, "fma_emu_matmul", lambda a, b, **kw:
                        calls.append(tuple(a.shape)) or torch.zeros(
                            (a.shape[0], b.shape[1])))
    a, b = _operands(13, a_shape=(2, 8, 16), n=8)
    out = emulated_matmul(a, b, fmt="bf16", impl="pallas", device="cpu")
    assert calls == [(16, 16)] and out.shape == (2, 8, 8)
    with pytest.raises(ValueError):
        emulated_matmul(a, b, fmt="bf16", impl="pallas", scaled=True,
                        device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        emulated_matmul(a, b, fmt="bf16", impl="tpu", device="cpu")


@pytest.mark.parametrize("impl,route", [("interpret", "pallas"),
                                        ("fused_interpret", "fused")])
def test_interpret_impl_names_match_jax(impl, route):
    """The JAX package's interpret-mode names are accepted and run the
    port's route of the same kernel: equal to that route, and within the
    format-ulp bound of JAX's output under the same name."""
    from repro.numerics import emulate as jemulate
    a, b = _operands(14, a_shape=(2, 24, 160), n=24)
    want = jemulate.emulated_matmul(jnp.asarray(a), jnp.asarray(b),
                                    fmt="bf16", style="cascade", impl=impl)
    got = emulated_matmul(a, b, fmt="bf16", style="cascade", impl=impl,
                          device="cpu")
    same = emulated_matmul(a, b, fmt="bf16", style="cascade", impl=route,
                           device="cpu")
    assert torch.equal(got, same)
    _assert_within_bound(got, want, tf.BF16, a, b)
