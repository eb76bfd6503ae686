"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and the CUDA toolkit (the kernels build with
``nvcc`` at first use); without a card they skip.  This file imports
neither ``jax`` nor ``repro``, so it runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: K2 (quantize) bitwise, f32 subnormals included; K1 (fused_qmm)
and K3 (fma_emu) exactly equal to their plain versions on every schedule of
``plan_qmm``, since the kernel and the plain version's per-block product
(cuBLAS, TF32 off) both sum each 128-deep partial dot with f32 FMAs in k
order; their rounding (the multiplication form) bitwise K2's over all 2**32
f32 patterns; K5 (ssm_scan_quantized) and
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


M_CASES = [1, 2, 3, 4, 5, 16, 17, 127, 128, 129, 512]
# (sm count, WHOLE_MIN_FILL) that force each schedule on small shapes:
# every tile grid counts as filling the card (whole k above 16 rows, the
# widest column tile at decode on one SM), or none does (split_tile above
# 16 rows, 16-wide column tiles at decode on a million SMs)
SCHEDULES = {"whole": (1, 0.0), "split": (10 ** 6, 2.0)}
# b layouts: a (K, N) weight or the unembed's table.T read in place, each
# contiguous (K = 300 and N = 37 rows: plain loads) or a view of padded
# rows (16-byte aligned: cp.async with the ragged edge zero-filled)
LAYOUTS = ("kn", "kn_padded", "table_T", "table_T_padded")
DTYPES = {"kn": (torch.float32, torch.float32),
          "kn_padded": (torch.bfloat16, torch.bfloat16),
          "table_T": (torch.float32, torch.bfloat16),
          "table_T_padded": (torch.bfloat16, torch.float32)}


def _qmm_operands(card, m, k, n, layout, seed, nb=None):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    ta, tb = DTYPES[layout]
    pad = 8 if layout.endswith("padded") else 0
    shape = (m, k + pad) if nb is None else (nb, m, k + pad)
    a = torch.randn(shape, generator=g, device=card).to(ta)[..., :k]
    if layout.startswith("table_T"):
        b = (torch.randn(n, k + pad, generator=g, device=card) * 0.1) \
            .to(tb)[:, :k].T
    else:
        b = (torch.randn(k, n + pad, generator=g, device=card) * 0.1) \
            .to(tb)[:, :n]
    return a, b


def _plan(monkeypatch, schedule, a, b, bm=None):
    """Force ``schedule`` through the planner, and with ``bm`` the tiled
    kernel's row tile (64 or 128) on both whole and split_tile."""
    from repro_torch.kernels import fused as tfused
    sms, fill = SCHEDULES[schedule]
    monkeypatch.setattr(tfused, "sm_count", lambda device: sms)
    monkeypatch.setattr(tfused, "WHOLE_MIN_FILL", fill)
    if bm is not None:
        monkeypatch.setattr(tfused, "TILE_ROWS", ((bm, 2),))
    nb, m = (1, a.shape[0]) if a.dim() == 2 else a.shape[:2]
    return tfused.plan_qmm(nb, m, b.shape[1], b.shape[0], sms)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("m", M_CASES)
def test_fused_qmm_exact_on_both_schedules(card, monkeypatch, m, schedule,
                                           layout):
    """K1 and K3 exactly equal to their plain versions at ragged K = 300
    and N = 37 on every schedule, format, style, scaled and out_fmt."""
    a, b = _qmm_operands(card, m, 300, 37, layout, m)
    plan = _plan(monkeypatch, schedule, a, b)
    if m <= 16:
        assert plan.schedule == "split_rows"
    else:
        assert plan.schedule == ("whole" if schedule == "whole"
                                 else "split_tile")
    for fmt in (tf.BF16, tf.FP16, tf.FP8_E4M3, tf.TF32):
        for style in STYLES:
            for scaled in (False, True):
                out_fmt = tf.FP16 if scaled else None
                before = fused_qmm.launches
                got = fused_qmm(a, b, fmt=fmt, style=style, scaled=scaled,
                                out_fmt=out_fmt)
                assert fused_qmm.launches == before + 1
                _exact(got, fused_qmm_ref(a, b, fmt=fmt, style=style,
                                          scaled=scaled, out_fmt=out_fmt,
                                          bm=128, bn=128))
            got = fma_emu_matmul(a, b, fmt=fmt, style=style, out_fmt=tf.BF16)
            _exact(got, fma_emu_matmul_ref(a, b, fmt=fmt, style=style,
                                           out_fmt=tf.BF16))


# (M, N, K) across the edges of 128-row and 128-column tiles, K ragged
EDGE_SHAPES = [(129, 37, 300), (129, 300, 1000), (300, 37, 1000),
               (300, 300, 300)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=["x".join(map(str, s)) for s in EDGE_SHAPES])
def test_fused_qmm_exact_on_each_row_tile(card, monkeypatch, shape, bm,
                                          schedule, layout):
    """K1 and K3 on the tiled kernel's 64- and 128-row tiles, forced
    through the planner on both whole and split_tile, exactly equal to
    their plain versions on every format, style, scaled and out_fmt, with
    bf16 and f32 operands and b as (K, N) or table.T."""
    m, n, k = shape
    a, b = _qmm_operands(card, m, k, n, layout, m + n + k)
    plan = _plan(monkeypatch, schedule, a, b, bm)
    assert plan.bm == bm
    assert plan.schedule == ("whole" if schedule == "whole" else
                             "split_tile")
    for fmt in (tf.BF16, tf.FP16, tf.FP8_E4M3, tf.TF32):
        for style in STYLES:
            for scaled in (False, True):
                out_fmt = tf.FP16 if scaled else None
                got = fused_qmm(a, b, fmt=fmt, style=style, scaled=scaled,
                                out_fmt=out_fmt)
                _exact(got, fused_qmm_ref(a, b, fmt=fmt, style=style,
                                          scaled=scaled, out_fmt=out_fmt,
                                          bm=128, bn=128))
            got = fma_emu_matmul(a, b, fmt=fmt, style=style, out_fmt=tf.BF16)
            _exact(got, fma_emu_matmul_ref(a, b, fmt=fmt, style=style,
                                           out_fmt=tf.BF16))


@pytest.mark.parametrize("bm", [None, 64, 128])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("m", [1, 129])
def test_fused_qmm_exact_batched_scaled(card, monkeypatch, m, schedule, bm):
    """nb = 3 slices of a, each with its own tile scales (on the planner's
    row tile, or on a forced one)."""
    a, b = _qmm_operands(card, m, 300, 37, "kn_padded", 7, nb=3)
    a = a * torch.tensor([1.0, 2.0 ** 20, 2.0 ** -30], device=card
                         ).to(a.dtype)[:, None, None]
    _plan(monkeypatch, schedule, a, b, bm)
    for fmt in (tf.BF16, tf.FP8_E4M3):
        for style in STYLES:
            got = fused_qmm(a, b, fmt=fmt, style=style, scaled=True)
            _exact(got, fused_qmm_ref(a, b, fmt=fmt, style=style,
                                      scaled=True, bm=128, bn=128))


@pytest.mark.parametrize("bm", [None, 64, 128])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("m", [4, 129])
def test_fused_qmm_exact_with_specials(card, monkeypatch, m, schedule, bm):
    """+-0, +-inf, NaN and f32 subnormals planted inside tiles of a (rows
    0-1) and b (columns 0-4), f32 operands, every style and out_fmt; the
    other outputs stay finite."""
    a, b = _qmm_operands(card, m, 300, 37, "kn", 3)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e-40, -3e-39, 1e-45],
                           device=card)
    r = np.random.default_rng(5)
    for i in range(24):
        a[i % 2, int(r.integers(300))] = special[i % len(special)]
        b[int(r.integers(300)), i % 5] = special[i % len(special)]
    b[:, 5] = 1e-40  # a column of subnormals only
    a[2, 128:256] = -0.0  # a whole k block of negative zeros
    _plan(monkeypatch, schedule, a, b, bm)
    finite = 0
    for fmt in (tf.BF16, tf.FP8_E5M2):
        for style in STYLES:
            for scaled in (False, True):
                for out_fmt in (None, tf.FP16, tf.FP8_E4M3):
                    got = fused_qmm(a, b, fmt=fmt, style=style,
                                    scaled=scaled, out_fmt=out_fmt)
                    want = fused_qmm_ref(a, b, fmt=fmt, style=style,
                                         scaled=scaled, out_fmt=out_fmt,
                                         bm=128, bn=128)
                    _exact(got, want)
                    finite += int(torch.isfinite(want).sum())
    # scaled fp8 on a tile that holds an inf rescales by 2**-114, so the
    # tile's dequant factor overflows and every entry of it is NaN; the
    # other settings keep most entries finite
    assert finite > 0


@pytest.mark.parametrize("fmt", ["tf32", "bf16", "fp16", "fp8_e4m3",
                                 "fp8_e5m2"])
def test_rounding_multiplication_form_exhaustive(card, fmt):
    """All 2**32 f32 bit patterns through quantize_rne_mul (K1/K3) and
    quantize_rne (K2) on the card: zero bitwise mismatches; and rounding a
    finite bf16 value onto a format that holds every bf16 value moves
    none of them (why K1 skips it for unscaled bf16 operands)."""
    from repro_torch.kernels.fused import rounding_mismatches
    fmt = tf.REGISTRY[fmt]
    mul_vs_div, bf16_moved = rounding_mismatches(fmt, card)
    assert mul_vs_div == 0
    holds_bf16 = fmt.exp_bits == 8 and fmt.man_bits >= 7
    assert (bf16_moved == 0) == holds_bf16


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


#: the scan shapes (B, S, D, N) that stress the lanes kernel's schedule:
#: S = 1, S under the ring's depth of 8 and not a multiple of it, S across
#: the 64-step chunks of rounded c, a partial last d-block with B > 1 at
#: 32, 16 and 8 rows a block, N = 8 and 16; and N = 5 (the scalar kernel)
SCAN_SHAPES = {"n16": (2, 64, 8192 // 64, 16), "ragged-d-n8": (3, 32, 200, 8),
               "any-n": (1, 16, 40, 5), "s1": (2, 1, 256, 16),
               "s5-n8": (2, 5, 136, 8), "s13-partial-d": (3, 13, 201, 16),
               "s70-partial-32-rows": (2, 70, 4100, 16),
               "s21-partial-n8": (3, 21, 1000, 8)}
#: operand layouts the wrapper must realign: a and c 4 bytes past a 16-byte
#: boundary, b a non-contiguous view
SCAN_LAYOUTS = ("contiguous", "offset4", "strided")


def _scan_layout(t, layout):
    """The same values as ``t`` in another memory layout."""
    if layout == "offset4":
        flat = torch.empty(t.numel() + 1, device=t.device)[1:]
        assert flat.data_ptr() % 16 == 4
        return flat.view(t.shape).copy_(t)
    if layout == "strided":
        return t.transpose(0, -1).contiguous().transpose(0, -1)
    return t


@pytest.mark.parametrize("layout", SCAN_LAYOUTS)
@pytest.mark.parametrize("shape", list(SCAN_SHAPES.values()),
                         ids=list(SCAN_SHAPES))
def test_ssm_scan_kernel_bitwise(card, shape, layout):
    a, b, c = _scan_operands(card, shape, 4)
    want_y, want_h = ssm_scan_ref(a, b, c)
    a, c = _scan_layout(a, layout), _scan_layout(c, layout)
    b = _scan_layout(b, "strided" if layout != "contiguous" else layout)
    chunk = shape[1]
    before = ssm_scan.launches
    y, h = ssm_scan(a, b, c, chunk=chunk, bd=shape[2])
    assert ssm_scan.launches == before + 1
    _exact(y, want_y)
    _exact(h, want_h)
    # K5 with no rounding is K6
    y5, h5 = ssm_scan_quantized(a, b, c, fmt=None, chunk=chunk,
                                bd=shape[2])
    _exact(y5, y)
    _exact(h5, h)


@pytest.mark.parametrize("shape", [(2, 48, 136, 16), (2, 1, 256, 16),
                                   (3, 13, 201, 16), (3, 21, 1000, 8)],
                         ids=["n16", "s1", "s13-partial-d", "s21-partial-n8"])
@pytest.mark.parametrize("out_fmt", [None, "bf16"], ids=["f32-out",
                                                         "bf16-out"])
@pytest.mark.parametrize("fmt", [None, "bf16", "fp16", "fp8_e4m3"])
def test_ssm_scan_quantized_kernel_bitwise(card, fmt, out_fmt, shape):
    fmt = tf.REGISTRY[fmt] if fmt else None
    out_fmt = tf.REGISTRY[out_fmt] if out_fmt else None
    a, b, c = _scan_operands(card, shape, 5)
    before = ssm_scan_quantized.launches
    y, h = ssm_scan_quantized(a, b, c, fmt=fmt, out_fmt=out_fmt,
                              chunk=shape[1], bd=shape[2])
    assert ssm_scan_quantized.launches == before + 1
    want_y, want_h = ssm_scan_quantized_ref(a, b, c, fmt=fmt,
                                            out_fmt=out_fmt)
    _exact(y, want_y)
    _exact(h, want_h)


@pytest.mark.parametrize("layout", SCAN_LAYOUTS[1:])
@pytest.mark.parametrize("fmt", ["bf16", "fp8_e4m3"])
def test_ssm_scan_quantized_kernel_realigns_operands(card, fmt, layout):
    fmt = tf.REGISTRY[fmt]
    a, b, c = _scan_operands(card, (2, 13, 201, 16), 6)
    want = ssm_scan_quantized_ref(a, b, c, fmt=fmt, out_fmt=tf.BF16)
    a, b, c = (_scan_layout(t, layout) for t in (a, b, c))
    got = ssm_scan_quantized(a, b, c, fmt=fmt, out_fmt=tf.BF16, chunk=13,
                             bd=201)
    for g, w in zip(got, want):
        _exact(g, w)


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


#: (q shape, kv shape, keywords): GQA groups of 1, 2, 4 and 8, ragged
#: lengths, Sq != Sk with q_offset, kv_len < Sk, a window, a decode shape
#: (Sq = 1), and lengths above 128 so that unequal blocks stay unequal
FLASH_CASES = {
    "gqa2-ragged": ((2, 45, 4), (2, 45, 2), {}),
    "gqa8-offset": ((1, 37, 8), (1, 53, 1), dict(q_offset=16)),
    "g1-window-kvlen": ((2, 50, 2), (2, 50, 2), dict(window=8, kv_len=41)),
    "decode": ((3, 1, 4), (3, 70, 2), dict(q_offset=69, kv_len=70)),
    "gqa2-long": ((2, 200, 4), (2, 200, 2), {}),
    "gqa4-long-offset": ((1, 150, 8), (1, 290, 2),
                         dict(q_offset=140, kv_len=281)),
}
#: (block_q, block_k): equal blocks, and unequal ones over several tiles
FLASH_BLOCKS = [pytest.param((16, 16), id="16"),
                pytest.param((128, 128), id="128"),
                pytest.param((128, 64), id="128x64"),
                pytest.param((64, 128), id="64x128")]
FLASH_FMTS = ((None, False, None), ("bf16", False, None),
              ("fp8_e4m3", True, None), ("fp8_e5m2", True, "bf16"))


@pytest.mark.parametrize("block", FLASH_BLOCKS)
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_bitwise(card, case, D, block):
    (B, Sq, Hq), (_, Sk, Hkv), kw = FLASH_CASES[case]
    q, k, v = _flash_operands(card, (B, Sq, Hq, D), (B, Sk, Hkv, D), 7)
    for fmt, scaled, out_fmt in FLASH_FMTS:
        fmt = tf.REGISTRY[fmt] if fmt else None
        out_fmt = tf.REGISTRY[out_fmt] if out_fmt else None
        args = dict(fmt=fmt, scaled=scaled, out_fmt=out_fmt,
                    block_q=block[0], block_k=block[1], **kw)
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


def test_fp8_cache_cast_on_card(card):
    """The KV cache's cast into float8_e4m3fn on the card gives what it
    gives on the CPU (held against JAX's ``astype`` in
    test_torch_kv_cache.py) for every bf16 bit pattern and the f32 edges:
    NaN beyond 464 and for +-inf, 464 to 448."""
    from repro_torch.models.model import to_cache
    fp8 = torch.float8_e4m3fn
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    edges = torch.tensor([448, 463.99997, 464, 464.00003, 465, -464, -465,
                          3e38, float("inf"), -float("inf"), float("nan"),
                          1e-10, -0.0, 2.0 ** -9, 2.0 ** -10])
    for x in (bits.view(torch.bfloat16), bits.view(torch.bfloat16).float(),
              edges):
        got = to_cache(x.to(card), fp8).cpu()
        want = to_cache(x, fp8)
        nan = want.float().isnan()
        assert torch.equal(got.float().isnan(), nan)
        assert torch.equal(got.view(torch.uint8)[~nan],
                           want.view(torch.uint8)[~nan])


SOFTFLOAT_FORMATS = ("fp32", "tf32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")


@pytest.mark.parametrize("fmt", SOFTFLOAT_FORMATS)
def test_softfloat_on_card_bitwise(card, fmt):
    """The float64 softfloat on the card gives the CPU's bits: every
    elementwise op on 2**16 normal-range triples on ``fmt``'s grid, and
    ``emulated_dot`` in every style on the accuracy oracle's own 24 x 64
    samples (held against the JAX package and the oracle on the CPU in
    test_torch_softfloat.py and test_torch_accuracy.py).  Each op is one
    kernel of its own, so nothing is contracted into a fused
    multiply-add."""
    from repro_torch.core import softfloat as sf
    from repro_torch.numerics import AccuracyModel, emulated_dot, get_format
    f = get_format(fmt)
    r = np.random.default_rng(1)
    raw = r.standard_normal((3, 1 << 16)) * np.exp2(
        r.integers(-6, 7, (3, 1 << 16)))
    a, b, c = (sf.quantize64(torch.from_numpy(x), f).float() for x in raw)
    on = [t.to(card) for t in (a, b, c)]
    for name in ("sf_mul", "sf_add"):
        got = getattr(sf, name)(on[0], on[1], f).cpu()
        _exact(got, getattr(sf, name)(a, b, f))
    for name in ("sf_fma", "sf_cma"):
        got = getattr(sf, name)(*on, f).cpu()
        _exact(got, getattr(sf, name)(a, b, c, f))
    wide = [torch.from_numpy(x) for x in raw]
    for name in ("dp_cma", "dp_fma"):
        got = getattr(sf, name)(*(t.to(card) for t in wide)).cpu()
        _exact(got, getattr(sf, name)(*wide))
    samples = torch.from_numpy(AccuracyModel()._samples())
    da = sf.quantize64(samples[:, 0], f).float()
    db = sf.quantize64(samples[:, 1], f).float()
    for style in STYLES:
        got = emulated_dot(da.to(card), db.to(card), fmt=f, style=style)
        assert got.device.type == "cuda"
        _exact(got.cpu(), emulated_dot(da, db, fmt=f, style=style))


# ------------------------------------------ the hybrid and MoE families
def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.to(dev)


@pytest.mark.parametrize("cf", [1.25, 64.0])
def test_moe_apply_on_card_is_stable_and_matches_cpu(card, cf):
    """A deepseek-moe-shaped layer (64 routed experts, top-6, 2 shared) at
    a narrow width, in bfloat16: two card runs bitwise equal; the picks,
    keep mask, slots and tokens the CPU's; the output within 4 * 2**-8 *
    max|out| of the CPU's (the experts' products sum in another order; each
    output is a few rounded adds of those)."""
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, 256, n_experts=64, moe_d_ff=128, n_shared=2,
                     dtype=torch.bfloat16)
    x = torch.randn((4, 128, 256), generator=gen).to(torch.bfloat16)
    kw = dict(top_k=6, capacity_factor=cf)
    pc, xc = _tree_to(p, card), x.to(card)
    got = moe.route(pc["router"], xc.reshape(-1, 256), **kw)
    want = moe.route(p["router"], x.reshape(-1, 256), **kw)
    for name in ("top_i", "keep", "slot", "tok"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    assert bool(got.keep.all()) == (cf == 64.0)
    out1, aux = moe.moe_apply(pc, xc, **kw)
    out2, _ = moe.moe_apply(pc, xc, **kw)
    assert torch.equal(out1, out2)
    ref, aux_cpu = moe.moe_apply(p, x, **kw)
    assert float(aux["dropped_frac"]) == float(aux_cpu["dropped_frac"])
    err = (out1.cpu().float() - ref.float()).abs().max()
    assert err <= 4 * 2.0 ** -8 * ref.float().abs().max()


def test_ring_decode_on_card_matches_cpu(card):
    """The reduced mixtral (16-slot ring, float32): a 40-token prefill and
    12 decode steps across the wrap on the card against the CPU, logits
    and ring within rtol = atol = 1e-4 (float32; the products' summation
    order differs)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              dtype="float32")
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg, device=card)
    params = cpu.init(seed=0)
    params_gpu = _tree_to(params, card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 40)))
    want, wc = cpu.prefill(params, toks, max_len=64)
    got, gc_ = gpu.prefill(params_gpu, toks.to(card), max_len=64)
    for _ in range(12):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        nxt = torch.argmax(want, dim=-1)[:, None]
        want, wc = cpu.decode_step(params, wc, nxt)
        got, gc_ = gpu.decode_step(params_gpu, gc_, nxt.to(card))
        want, got = want[:, -1], got[:, -1]
    assert wc.data["k"].shape[2] == 16
    for name in ("k", "v"):
        torch.testing.assert_close(gc_.data[name].cpu(), wc.data[name],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,per_fwd", [("zamba2-1.2b", 13),
                                          ("deepseek-moe-16b", 9)])
def test_emulated_families_on_card_match_cpu(card, arch, per_fwd):
    """The reduced hybrid (5 layers, two shared applications: 6 * 2 + 1
    K1 launches a forward) and MoE (2 layers: 4 * 2 + 1) under
    EmulatedPolicy(bf16, fused): K1 on the card against the plain version
    on the CPU, |delta| <= 4 * 2**-8 * max|logit|, for ``apply`` and for
    the last logits of a prefill."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    from repro_torch.models.numerics import EmulatedPolicy
    kw = dict(n_layers=5) if arch == "zamba2-1.2b" else {}
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **kw)
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg, device=card)
    params = cpu.init(seed=0)
    params_gpu = _tree_to(params, card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 24)))
    pol = EmulatedPolicy("bf16", "fused")
    want, _ = cpu.apply(params, toks, policy=pol)
    before = fused_qmm.launches
    got, _ = gpu.apply(params_gpu, toks.to(card), policy=pol)
    assert fused_qmm.launches - before == per_fwd
    assert (got.cpu() - want).abs().max() <= 4 * 2.0 ** -8 * want.abs().max()
    want, _ = cpu.prefill(params, toks, policy=pol)
    got, _ = gpu.prefill(params_gpu, toks.to(card), policy=pol)
    assert (got.cpu() - want).abs().max() <= 4 * 2.0 ** -8 * want.abs().max()


def test_emulated_vlm_with_prefix_on_card_matches_cpu(card):
    """The reduced internvl2 (2 layers: 7 * 2 + 1 K1 launches a forward)
    with 8 prefix embeddings in front of its tokens, under
    EmulatedPolicy(bf16, fused): K1 on the card against the plain version
    on the CPU, |delta| <= 4 * 2**-8 * max|logit|, for ``apply`` and for
    the last logits of a prefill, whose cache length counts the prefix."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    from repro_torch.models.numerics import EmulatedPolicy
    cfg = dataclasses.replace(get_config("internvl2-1b").reduced(),
                              dtype="float32")
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg, device=card)
    params = cpu.init(seed=0)
    params_gpu = _tree_to(params, card)
    r = np.random.default_rng(0)
    toks = torch.from_numpy(r.integers(0, 256, (2, 24)))
    prefix = torch.from_numpy(r.standard_normal(
        (2, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32))
    pol = EmulatedPolicy("bf16", "fused")
    want, _ = cpu.apply(params, toks, prefix_embeds=prefix, policy=pol)
    before = fused_qmm.launches
    got, _ = gpu.apply(params_gpu, toks.to(card),
                       prefix_embeds=prefix.to(card), policy=pol)
    assert fused_qmm.launches - before == 7 * cfg.n_layers + 1
    assert got.shape == (2, 24 + cfg.n_prefix_tokens, gpu.vocab_padded)
    assert (got.cpu() - want).abs().max() <= 4 * 2.0 ** -8 * want.abs().max()
    want, wc = cpu.prefill(params, toks, prefix_embeds=prefix, policy=pol)
    got, gc_ = gpu.prefill(params_gpu, toks.to(card),
                           prefix_embeds=prefix.to(card), policy=pol)
    assert int(gc_.length) == int(wc.length) == 24 + cfg.n_prefix_tokens
    assert (got.cpu() - want).abs().max() <= 4 * 2.0 ** -8 * want.abs().max()


def test_kernels_refuse_grad_and_serve_without_it(card):
    """No kernel has a backward, and a ``ctypes`` launch leaves no
    ``grad_fn``: with grad on and an input that requires it, every wrapper
    raises ``NoBackwardError`` before launching, so a train step under an
    emulating policy fails on the card where it would otherwise get zero
    gradients.  Without grad the same calls launch."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import for_arch, make_batch
    from repro_torch.kernels._build import NoBackwardError
    from repro_torch.models import LM
    from repro_torch.models.numerics import EmulatedPolicy
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_state, make_train_step
    bf16 = tf.get_format("bf16")
    g = torch.Generator(device=card)
    g.manual_seed(0)
    a = torch.randn((4, 64), generator=g, device=card)
    b = torch.randn((64, 32), generator=g, device=card)
    x = torch.randn((1, 16, 2, 16), generator=g, device=card)
    # the scan's wrappers take S in whole 64-step chunks, D in 256-row blocks
    sa = torch.rand((1, 64, 256, 8), generator=g, device=card) * 0.5 + 0.5
    sc = torch.randn((1, 64, 8), generator=g, device=card)
    # (wrapper, a call on its first operand, that operand)
    cases = [(fused_qmm, lambda t: fused_qmm(t, b, fmt=bf16), a),
             (fma_emu_matmul, lambda t: fma_emu_matmul(t, b, fmt=bf16), a),
             (quantize_nd, lambda t: quantize_nd(t, fmt=bf16), a),
             (fused_flash_attention,
              lambda t: fused_flash_attention(t, x, x, fmt=bf16), x),
             (ssm_scan, lambda t: ssm_scan(t, sa, sc), sa),
             (ssm_scan_quantized,
              lambda t: ssm_scan_quantized(t, sa, sc, fmt=bf16), sa)]
    for wrapper, call, first in cases:
        live = first.clone().requires_grad_(True)
        before = wrapper.launches
        with pytest.raises(NoBackwardError, match=wrapper.__name__):
            call(live)
        assert wrapper.launches == before, wrapper.__name__
        with torch.no_grad():
            call(live)
        assert wrapper.launches == before + 1, wrapper.__name__

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              n_layers=1)
    model = LM(cfg, device=card)
    opt = AdamWConfig()
    batch = make_batch(for_arch(cfg, seq_len=16, global_batch=2), 0,
                       device=card)
    state = make_train_state(model, 0, opt)
    step = make_train_step(model, opt, policy=EmulatedPolicy("bf16", "fused"))
    with pytest.raises(NoBackwardError, match="fused_qmm"):
        step(state, batch)
    # the same model trains without a policy
    state, metrics = make_train_step(model, opt)(state, batch)
    assert float(metrics["grad_norm"]) > 0
