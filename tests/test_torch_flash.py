"""The port's emulated flash attention against the JAX package, on the CPU.

K4 (``fused_flash_attention``) runs here as its plain version
``fused_flash_ref``, which the CUDA kernel equals bitwise on the card
(tests/test_torch_cuda.py).  The JAX side runs its Pallas kernel in
interpret mode (bitwise equal to its own ``fused_flash_ref``, which
tests/test_fused_kernels.py holds) and its twins, on the same seeded numpy
inputs.  The inputs hold no f32 subnormals: XLA:CPU treats them as zero
(tests/test_torch_formats.py).  Tolerances, on the scale of max |v| (an
output row is a convex combination of v's rows):

  * no format: within 1e-6 * max |v|.  Both sides compute in f32, but XLA
    takes the dots in its own order where the port sums left to right, and
    XLA's exp and torch's CPU exp may differ in the last bit (1.2e-7 seen);
  * a rounded format: within 2**-man_bits * max |v|, and at least 95% of the
    entries within the f32 tolerance above.  A rounded p near a rounding
    midpoint can land on the neighbouring grid point when the f32 score
    differs in the last bit: one format ulp of p (p <= 1) moves the output
    by at most 2**-man_bits * max |v| / l with l >= 1;
  * with ``out_fmt``: one ``out_fmt`` ulp of |out| more, for the same
    reason at the final rounding.

The dispatch of ``emulated_flash_attention`` and ``policy_flash_attention``
follows the JAX package's, with the same ``ValueError`` on Hq % Hkv != 0.
"""
import numpy as np
import pytest
import torch

from repro.kernels import fused as jfused
from repro.models.numerics import EmulatedPolicy as JPolicy
from repro.models.numerics import policy_flash_attention as jpolicy_flash
from repro.numerics import emulated_flash_attention as jemulated_flash
from repro.numerics import get_format as jget_format
from repro_torch.kernels import fused
from repro_torch.models.numerics import EmulatedPolicy, policy_flash_attention
from repro_torch.numerics import emulated_flash_attention, get_format

F32_TOL = 1e-6

#: (q (B, Sq, Hq, D), kv (B, Sk, Hkv, D), keywords), blocks of 16: GQA
#: groups of 2 (the JAX tests' shape), 8 and 1, lengths that are not
#: multiples of the block, Sq != Sk with q_offset, a window, kv_len < Sk and
#: a decode shape (Sq = 1)
CASES = {
    "jax-shape-g2": ((2, 48, 4, 16), (2, 48, 2, 16), {}),
    "ragged-g8-offset": ((1, 40, 8, 16), (1, 44, 1, 16), dict(q_offset=4)),
    "g1-window": ((1, 33, 2, 8), (1, 33, 2, 8), dict(window=8)),
    "kv-len": ((2, 30, 2, 16), (2, 37, 2, 16),
               dict(kv_len=30, q_offset=7)),
    "decode": ((2, 1, 4, 16), (2, 37, 2, 16), dict(q_offset=36)),
}
#: (fmt, scaled, out_fmt)
FMTS = {
    "none": (None, True, None),
    "bf16": ("bf16", True, None),
    "fp8_e4m3-unscaled": ("fp8_e4m3", False, None),
    "fp8_e5m2-scaled": ("fp8_e5m2", True, None),
    "bf16-out-bf16": ("bf16", True, "bf16"),
}


def _inputs(q_shape, kv_shape, seed=0, q_scale=1.0):
    r = np.random.default_rng(seed)
    q = (r.standard_normal(q_shape) * q_scale).astype(np.float32)
    k = r.standard_normal(kv_shape).astype(np.float32)
    v = r.standard_normal(kv_shape).astype(np.float32)
    return q, k, v


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _close(got, want, v, fmt=None, out_fmt=None, what=""):
    """The module's tolerance for ``fmt`` (None: f32 only)."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    vmax = float(np.abs(v).max())
    err = np.abs(got - want)
    if fmt is None and out_fmt is None:
        assert err.max() <= F32_TOL * vmax, (what, err.max() / vmax)
        return
    bound = (2.0 ** -fmt.man_bits if fmt is not None else F32_TOL) * vmax
    if out_fmt is not None:
        e = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
        bound = bound + np.exp2(np.maximum(e, 1 - out_fmt.bias)
                                - out_fmt.man_bits)
    assert (err <= bound).all(), (what, err.max() / vmax)
    assert (err <= F32_TOL * vmax).mean() >= 0.95, what


def _formats(name):
    fmt, scaled, out_fmt = FMTS[name]
    return ((get_format(fmt) if fmt else None),
            (jget_format(fmt) if fmt else None), scaled,
            (get_format(out_fmt) if out_fmt else None),
            (jget_format(out_fmt) if out_fmt else None))


@pytest.mark.parametrize("fmt_name", sorted(FMTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_ref_matches_jax_kernel(case, fmt_name):
    """The port's plain K4 (and the K4 wrapper on CPU tensors) against the
    JAX Pallas kernel in interpret mode."""
    q_shape, kv_shape, kw = CASES[case]
    q, k, v = _inputs(q_shape, kv_shape)
    fmt, jfmt, scaled, out_fmt, jout = _formats(fmt_name)
    want = jfused.fused_flash_attention(
        q, k, v, fmt=jfmt, scaled=scaled, out_fmt=jout, block_q=16,
        block_k=16, interpret=True, **kw)
    args = dict(fmt=fmt, scaled=scaled, out_fmt=out_fmt, block_q=16,
                block_k=16, **kw)
    got = fused.fused_flash_ref(*_t(q, k, v), **args)
    _close(got, want, v, fmt, out_fmt, f"{case} {fmt_name}")
    wrapped = fused.fused_flash_attention(*_t(q, k, v), **args)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("fmt_name", ["none", "fp8_e4m3-unscaled"])
def test_flash_ref_matches_jax_ref(fmt_name):
    """Against the JAX loop twin itself, at a shape whose trace stays small
    (the twin unrolls every block update into one program)."""
    q, k, v = _inputs((1, 32, 2, 8), (1, 32, 1, 8), seed=1)
    fmt, jfmt, scaled, out_fmt, _ = _formats(fmt_name)
    want = jfused.fused_flash_ref(q, k, v, fmt=jfmt, scaled=scaled,
                                  block_q=16, block_k=16)
    got = fused.fused_flash_ref(*_t(q, k, v), fmt=fmt, scaled=scaled,
                                block_q=16, block_k=16)
    _close(got, want, v, fmt, None, fmt_name)


@pytest.mark.parametrize("fmt_name", ["none", "bf16", "fp8_e5m2-scaled"])
@pytest.mark.parametrize("case", ["jax-shape-g2", "g1-window", "decode"])
def test_flash_scan_matches_jax_scan(case, fmt_name):
    q_shape, kv_shape, kw = CASES[case]
    q, k, v = _inputs(q_shape, kv_shape, seed=2)
    fmt, jfmt, scaled, _, _ = _formats(fmt_name)
    want = jfused.fused_flash_scan(q, k, v, fmt=jfmt, scaled=scaled,
                                   block_q=16, block_k=16, **kw)
    got = fused.fused_flash_scan(*_t(q, k, v), fmt=fmt, scaled=scaled,
                                 block_q=16, block_k=16, **kw)
    _close(got, want, v, fmt, None, f"scan {case} {fmt_name}")


def test_fp8_e4m3_scaled_tile_above_240():
    """A q tile whose max lies above fp8_e4m3's 240: the scaled path stays
    finite and matches JAX, where the unscaled rounding gives inf.  No
    causal mask, so no masked score lies far above a row's max (that gives
    inf * 0 = NaN in both packages, by the reference's rule)."""
    q, k, v = _inputs((1, 32, 2, 16), (1, 32, 2, 16), seed=3, q_scale=300.0)
    assert np.abs(q).max() > 240
    e4, je4 = get_format("fp8_e4m3"), jget_format("fp8_e4m3")
    want = jfused.fused_flash_attention(q, k, v, fmt=je4, scaled=True,
                                        causal=False, block_q=16,
                                        block_k=16, interpret=True)
    got = fused.fused_flash_ref(*_t(q, k, v), fmt=e4, scaled=True,
                                causal=False, block_q=16, block_k=16)
    _close(got, want, v, e4, None, "scaled above 240")
    unscaled = fused.fused_flash_ref(*_t(q, k, v), fmt=e4, scaled=False,
                                     causal=False, block_q=16, block_k=16)
    assert not torch.isfinite(unscaled).all()


@pytest.mark.parametrize("impl", ["fused", "interpret", "ref", "scan",
                                  "auto"])
def test_emulated_flash_attention_every_impl(impl):
    """Each route of the port against the same route of the JAX package on
    the CPU (JAX's 'fused' and 'interpret' both as interpret mode, since
    its 'fused' needs a TPU; 'auto' is 'scan' off the card in both)."""
    q, k, v = _inputs((1, 40, 4, 16), (1, 40, 2, 16), seed=4)
    jimpl = {"fused": "interpret"}.get(impl, impl)
    kw = dict(block_q=16, block_k=16, window=12)
    want = jemulated_flash(q, k, v, fmt="bf16", impl=jimpl, **kw)
    got = emulated_flash_attention(q, k, v, fmt="bf16", impl=impl,
                                   device="cpu", **kw)
    _close(got, want, v, get_format("bf16"), None, impl)
    if impl in ("fused", "interpret"):  # the K4 wrapper: the plain version
        assert torch.equal(got, emulated_flash_attention(
            q, k, v, fmt="bf16", impl="ref", device="cpu", **kw))
    if impl == "auto":
        assert torch.equal(got, emulated_flash_attention(
            q, k, v, fmt="bf16", impl="scan", device="cpu", **kw))


def test_policy_flash_attention_inert_and_emulating():
    q, k, v = _inputs((1, 32, 2, 8), (1, 32, 2, 8), seed=5)
    # inert: the model's plain attention in both packages, not K4
    want = jpolicy_flash(q, k, v, policy=None)
    got = policy_flash_attention(*_t(q, k, v), policy=None)
    _close(got, want, v, what="inert")
    from repro_torch.models.attention import flash_attention
    assert torch.equal(got, flash_attention(*_t(q, k, v)))
    # emulating: the policy's format through emulated_flash_attention
    for fmt in ("bf16", "fp8_e4m3"):
        want = jpolicy_flash(q, k, v, policy=JPolicy(jget_format(fmt),
                                                     "fused"))
        got = policy_flash_attention(*_t(q, k, v),
                                     policy=EmulatedPolicy(fmt, "fused"))
        _close(got, want, v, get_format(fmt), None, f"emulating {fmt}")
        assert torch.equal(got, emulated_flash_attention(
            *_t(q, k, v), fmt=fmt, device="cpu"))


def test_bf16_operands_keep_their_dtype():
    """bf16 operands are computed in f32 and the output cast back, as the
    JAX kernel does."""
    q, k, v = _inputs((1, 24, 2, 16), (1, 24, 1, 16), seed=6)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = fused.fused_flash_attention(qb, kb, vb, fmt=get_format("bf16"),
                                      block_q=16, block_k=16)
    assert got.dtype == torch.bfloat16
    want = fused.fused_flash_ref(qb.float(), kb.float(), vb.float(),
                                 fmt=get_format("bf16"), block_q=16,
                                 block_k=16)
    assert torch.equal(got, want.to(torch.bfloat16))


def test_errors_match_jax():
    q, k, v = _inputs((1, 16, 3, 8), (1, 16, 2, 8))
    with pytest.raises(ValueError, match="Hq=3 not a multiple of Hkv=2"):
        jfused.fused_flash_attention(q, k, v, fmt=None, interpret=True)
    for call in (lambda: fused.fused_flash_attention(*_t(q, k, v), fmt=None),
                 lambda: fused.fused_flash_ref(*_t(q, k, v), fmt=None),
                 lambda: emulated_flash_attention(q, k, v, fmt=None,
                                                  impl="scan",
                                                  device="cpu")):
        with pytest.raises(ValueError, match="Hq=3 not a multiple of Hkv=2"):
            call()
    q, k, v = _inputs((1, 16, 2, 8), (1, 16, 2, 8))
    with pytest.raises(ValueError, match="unknown impl"):
        jemulated_flash(q, k, v, fmt=None, impl="nope")
    with pytest.raises(ValueError, match="unknown impl"):
        emulated_flash_attention(q, k, v, fmt=None, impl="nope",
                                 device="cpu")
