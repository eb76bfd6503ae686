"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and the CUDA toolkit (the kernels build with
``nvcc`` at first use); without a card they skip.  This file imports
neither ``jax`` nor ``repro``, so it runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: K2 (quantize) bitwise, f32 subnormals included; K1 (fused_qmm)
and K3 (fma_emu) exactly equal to their plain versions, since the kernel and
the plain version's per-block product (cuBLAS, TF32 off) both sum each
128-deep partial dot with f32 FMAs in k order; K5 (ssm_scan_quantized) and
K6 (ssm_scan) bitwise, since both sides round every op of the recurrence
and the readout to f32 in the same order (NaN equal to NaN); K4
(fused_flash_attention) bitwise against fused_flash_ref, which sums s, l
and pv in the kernel's fixed order with one rounded multiply and one
rounded add per term (NaN equal to NaN).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import formats as tf
from repro_torch.kernels.fma_emu import fma_emu_matmul
from repro_torch.kernels.fused import (fused_flash_attention,
                                       fused_flash_ref, fused_qmm,
                                       fused_qmm_ref, ssm_scan_quantized,
                                       ssm_scan_quantized_ref)
from repro_torch.kernels.quantize_kernel import quantize_nd
from repro_torch.kernels.ref import fma_emu_matmul_ref
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref

pytestmark = pytest.mark.cuda
STYLES = ("fused", "cascade", "cascade_fwd")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32  # the plain products
    return torch.device("cuda")


def _exact(got, want):
    same = (got == want) | (got.isnan() & want.isnan())
    assert same.all(), float((got - want).abs().nan_to_num().max())


@pytest.mark.parametrize("fmt", ["tf32", "bf16", "fp16", "fp8_e4m3",
                                 "fp8_e5m2"])
def test_quantize_kernel_bitwise(card, fmt):
    fmt = tf.REGISTRY[fmt]
    r = np.random.default_rng(0)
    x = r.standard_normal(1 << 16) * np.exp2(r.integers(-150, 129, 1 << 16))
    x = np.concatenate([x, [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40,
                            -3e-39, 240.0, 248.0, 65520.0]])
    with np.errstate(over="ignore"):  # the largest draws overflow to inf
        xc = torch.from_numpy(x.astype(np.float32)).to(card)
    before = quantize_nd.launches
    got = quantize_nd(xc, fmt=fmt)
    assert quantize_nd.launches == before + 1
    want = tf.quantize(xc, fmt)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaled"])
@pytest.mark.parametrize("fmt", ["bf16", "fp16", "fp8_e4m3"])
@pytest.mark.parametrize("style", STYLES)
def test_fused_qmm_kernel_vs_plain(card, style, fmt, scaled):
    fmt = tf.REGISTRY[fmt]
    g = torch.Generator(device=card)
    g.manual_seed(1)
    a = torch.randn(2, 141, 300, generator=g, device=card)
    table = torch.randn(173, 300, generator=g, device=card).to(torch.bfloat16)
    b = table.T  # read through its strides, as the unembed's table.T
    before = fused_qmm.launches
    got = fused_qmm(a, b, fmt=fmt, style=style, scaled=scaled)
    assert fused_qmm.launches == before + 1
    want = fused_qmm_ref(a, b, fmt=fmt, style=style, scaled=scaled, bm=128,
                         bn=128)
    _exact(got, want)


@pytest.mark.parametrize("m", [2, 4])
def test_fused_qmm_kernel_at_falcon_mamba_unembed(card, m):
    """K1 at the shape falcon-mamba-7b's emulated unembed gives it: M = 2
    (a 2-row prefill's last positions) or 4 (a 4-slot decode step), K =
    d_model = 4096, N = the vocabulary, 65024, b = table.T through its
    strides."""
    from repro_torch.configs.base import get_config
    cfg = get_config("falcon-mamba-7b")
    g = torch.Generator(device=card)
    g.manual_seed(6)
    a = torch.randn(m, cfg.d_model, generator=g, device=card)
    table = (torch.randn(cfg.vocab_size, cfg.d_model, generator=g,
                         device=card) * 0.02).to(torch.bfloat16)
    a, b = a.to(torch.bfloat16), table.T
    for fmt in (tf.BF16, tf.FP8_E4M3):
        for style in STYLES:
            got = fused_qmm(a, b, fmt=fmt, style=style)
            want = fused_qmm_ref(a, b, fmt=fmt, style=style, bm=128, bn=128)
            _exact(got, want)


@pytest.mark.parametrize("fmt", ["bf16", "fp16", "fp8_e4m3"])
@pytest.mark.parametrize("style", STYLES)
def test_fma_emu_kernel_vs_plain(card, style, fmt):
    fmt = tf.REGISTRY[fmt]
    g = torch.Generator(device=card)
    g.manual_seed(2)
    a = torch.randn(61, 300, generator=g, device=card)
    b = torch.randn(300, 37, generator=g, device=card)
    got = fma_emu_matmul(a, b, fmt=fmt, style=style, out_fmt=tf.FP16)
    want = fma_emu_matmul_ref(a, b, fmt=fmt, style=style, out_fmt=tf.FP16)
    _exact(got, want)


def test_emulated_lm_on_card_matches_cpu(card):
    """The reduced LM under each emulating policy: K1 on the card against
    the plain version on the CPU, |delta| <= 4 * 2**-8 * max|logit|."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    from repro_torch.models.numerics import EmulatedPolicy
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg, device=card)
    params = cpu.init(seed=0)

    def to(tree):
        return {k: to(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else tree.to(card)

    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 24)))
    for spec in (("bf16", "fused"), ("bf16", "cascade"),
                 ("bf16", "cascade_fwd"), ("fp8_e4m3", "fused")):
        pol = EmulatedPolicy(*spec)
        want, _ = cpu.apply(params, toks, policy=pol)
        before = fused_qmm.launches
        got, _ = gpu.apply(to(params), toks.to(card), policy=pol)
        assert fused_qmm.launches - before == 7 * cfg.n_layers + 1
        assert (got.cpu() - want).abs().max() <= \
            4 * 2.0 ** -8 * want.abs().max()


def _scan_operands(card, shape, seed):
    """a in (0.5, 1) and b, c normal, with f32 subnormals, signed zeros,
    +-inf and NaN planted among them."""
    B, S, D, N = shape
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    a = torch.rand(shape, generator=g, device=card) * 0.5 + 0.5
    b = torch.randn(shape, generator=g, device=card)
    c = torch.randn((B, S, N), generator=g, device=card)
    special = torch.tensor([1e-40, -3e-39, 0.0, -0.0, float("inf"),
                            -float("inf"), float("nan"), 240.0, 250.0],
                           device=card)
    for t in (a, b, c):
        flat = t.view(-1)
        idx = torch.randint(0, flat.numel(), (64,), generator=g, device=card)
        flat[idx] = special[torch.arange(64, device=card) % len(special)]
    return a, b, c


@pytest.mark.parametrize("shape", [(2, 64, 8192 // 64, 16), (3, 32, 200, 8),
                                   (1, 16, 40, 5)],
                         ids=["n16", "ragged-d-n8", "any-n"])
def test_ssm_scan_kernel_bitwise(card, shape):
    a, b, c = _scan_operands(card, shape, 4)
    chunk = shape[1]
    before = ssm_scan.launches
    y, h = ssm_scan(a, b, c, chunk=chunk, bd=shape[2])
    assert ssm_scan.launches == before + 1
    want_y, want_h = ssm_scan_ref(a, b, c)
    _exact(y, want_y)
    _exact(h, want_h)
    # K5 with no rounding is K6
    y5, h5 = ssm_scan_quantized(a, b, c, fmt=None, chunk=chunk)
    _exact(y5, y)
    _exact(h5, h)


@pytest.mark.parametrize("out_fmt", [None, "bf16"], ids=["f32-out",
                                                         "bf16-out"])
@pytest.mark.parametrize("fmt", [None, "bf16", "fp16", "fp8_e4m3"])
def test_ssm_scan_quantized_kernel_bitwise(card, fmt, out_fmt):
    fmt = tf.REGISTRY[fmt] if fmt else None
    out_fmt = tf.REGISTRY[out_fmt] if out_fmt else None
    a, b, c = _scan_operands(card, (2, 48, 136, 16), 5)
    before = ssm_scan_quantized.launches
    y, h = ssm_scan_quantized(a, b, c, fmt=fmt, out_fmt=out_fmt, chunk=16,
                              bd=136)
    assert ssm_scan_quantized.launches == before + 1
    want_y, want_h = ssm_scan_quantized_ref(a, b, c, fmt=fmt,
                                            out_fmt=out_fmt)
    _exact(y, want_y)
    _exact(h, want_h)


def test_ssm_lm_on_card_launches_k1_once(card):
    """The reduced falcon-mamba under EmulatedPolicy: the unembed is the one
    K1 launch of a forward, and the logits match the CPU plain version."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    from repro_torch.models.numerics import EmulatedPolicy
    cfg = dataclasses.replace(get_config("falcon-mamba-7b").reduced(),
                              dtype="float32")
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg, device=card)
    params = cpu.init(seed=0)

    def to(tree):
        return {k: to(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else tree.to(card)

    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 70)))
    pol = EmulatedPolicy("bf16", "fused")
    want, _ = cpu.apply(params, toks, policy=pol)
    before = fused_qmm.launches
    got, _ = gpu.apply(to(params), toks.to(card), policy=pol)
    assert fused_qmm.launches - before == 1
    assert (got.cpu() - want).abs().max() <= 4 * 2.0 ** -8 * want.abs().max()


def _flash_operands(card, q_shape, kv_shape, seed, dtype=torch.float32,
                    specials=True):
    """q, k, v normal; with ``specials``, f32 subnormals and signed zeros
    planted in many places and one each of NaN, +inf and -inf in q, k and
    v."""
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    q = torch.randn(q_shape, generator=g, device=card)
    k = torch.randn(kv_shape, generator=g, device=card)
    v = torch.randn(kv_shape, generator=g, device=card)
    if specials:
        quiet = torch.tensor([1e-40, -3e-39, 0.0, -0.0], device=card)
        loud = torch.tensor([float("nan"), float("inf"), -float("inf")],
                            device=card)
        for t in (q, k, v):
            flat = t.view(-1)
            idx = torch.randint(0, flat.numel(), (32,), generator=g,
                                device=card)
            flat[idx] = quiet[torch.arange(32, device=card) % 4]
            idx = torch.randint(0, flat.numel(), (3,), generator=g,
                                device=card)
            flat[idx] = loud
    return q.to(dtype), k.to(dtype), v.to(dtype)


#: (q shape, kv shape, keywords): GQA groups of 1, 2 and 8, ragged lengths,
#: Sq != Sk with q_offset, kv_len < Sk, a window, a decode shape (Sq = 1)
FLASH_CASES = {
    "gqa2-ragged": ((2, 45, 4), (2, 45, 2), {}),
    "gqa8-offset": ((1, 37, 8), (1, 53, 1), dict(q_offset=16)),
    "g1-window-kvlen": ((2, 50, 2), (2, 50, 2), dict(window=8, kv_len=41)),
    "decode": ((3, 1, 4), (3, 70, 2), dict(q_offset=69, kv_len=70)),
}
FLASH_FMTS = ((None, False, None), ("bf16", False, None),
              ("fp8_e4m3", True, None), ("fp8_e5m2", True, "bf16"))


@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_bitwise(card, case, D, block):
    (B, Sq, Hq), (_, Sk, Hkv), kw = FLASH_CASES[case]
    q, k, v = _flash_operands(card, (B, Sq, Hq, D), (B, Sk, Hkv, D), 7)
    for fmt, scaled, out_fmt in FLASH_FMTS:
        fmt = tf.REGISTRY[fmt] if fmt else None
        out_fmt = tf.REGISTRY[out_fmt] if out_fmt else None
        args = dict(fmt=fmt, scaled=scaled, out_fmt=out_fmt, block_q=block,
                    block_k=block, **kw)
        before = fused_flash_attention.launches
        got = fused_flash_attention(q, k, v, **args)
        assert fused_flash_attention.launches == before + 1
        _exact(got, fused_flash_ref(q, k, v, **args))


def test_flash_kernel_bitwise_bf16_operands(card):
    """bf16 q, k and v (as the model hands them) are read as they are and
    the output is bf16, equal to the plain version's cast."""
    q, k, v = _flash_operands(card, (2, 130, 8, 64), (2, 130, 2, 64), 8,
                              dtype=torch.bfloat16, specials=False)
    for fmt in (None, tf.BF16, tf.FP8_E4M3):
        got = fused_flash_attention(q, k, v, fmt=fmt)
        assert got.dtype == torch.bfloat16
        _exact(got, fused_flash_ref(q, k, v, fmt=fmt))


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 3, (torch.bfloat16, torch.float32, torch.float32),
    (torch.float64,) * 3], ids=["fp16", "bf16-q-f32-kv", "f64"])
def test_flash_kernel_returns_q_dtype(card, dtypes):
    """Operands other than all-bf16 are widened to f32 for the kernel; the
    output comes back in q's dtype, equal to the plain version's."""
    q, k, v = _flash_operands(card, (2, 45, 4, 64), (2, 45, 2, 64), 10,
                              specials=False)
    q, k, v = (t.to(dt) for t, dt in zip((q, k, v), dtypes))
    for fmt in (None, tf.BF16):
        got = fused_flash_attention(q, k, v, fmt=fmt)
        want = fused_flash_ref(q, k, v, fmt=fmt)
        assert got.dtype == want.dtype == q.dtype
        _exact(got, want)


def test_flash_kernel_controls(card):
    """The bitwise check catches fp8 without rounding p, scaled=False where
    a tile's max lies above 240 (unscaled rounding gives inf), and a window
    ignored."""
    q, k, v = _flash_operands(card, (2, 96, 4, 64), (2, 96, 2, 64), 9,
                              specials=False)
    e4 = tf.FP8_E4M3
    # fp8 with q, k and v rounded but p not: the unscaled rounding is
    # elementwise, so it is the unrounded schedule on rounded operands
    no_p = fused_flash_ref(tf.quantize(q, e4), tf.quantize(k, e4),
                           tf.quantize(v, e4), fmt=None)
    got = fused_flash_attention(q, k, v, fmt=e4, scaled=False)
    assert not ((got == no_p) | (got.isnan() & no_p.isnan())).all()
    # non-causal, so no score is masked (a masked score far above the row
    # max gives inf * 0 = NaN in both versions, by the reference's rule)
    big = q * 300.0
    got = fused_flash_attention(big, k, v, fmt=e4, scaled=True, causal=False)
    assert torch.isfinite(got).all()
    unscaled = fused_flash_ref(big, k, v, fmt=e4, scaled=False,
                               causal=False)
    assert not ((got == unscaled) | (got.isnan() & unscaled.isnan())).all()
    got = fused_flash_attention(q, k, v, fmt=None, window=8, block_q=16,
                                block_k=16)
    no_window = fused_flash_ref(q, k, v, fmt=None, block_q=16, block_k=16)
    assert not (got == no_window).all()


def test_flash_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros(1, 8, 2, 160, device=card)
    with pytest.raises(ValueError, match="head dims up to 128"):
        fused_flash_attention(q, q, q, fmt=None)
    q = torch.zeros(1, 300, 2, 64, device=card)
    with pytest.raises(ValueError, match="blocks up to 128"):
        fused_flash_attention(q, q, q, fmt=None, block_q=256)
