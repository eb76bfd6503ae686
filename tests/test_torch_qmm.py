"""K1's host planner and its rounding, on the CPU (no JAX, no card).

``plan_qmm`` picks the schedule of each ``fused_qmm``/``fma_emu_matmul``
call on the card: split over the 128-deep k blocks at decode (M <= 16) and
where the output tile grid would leave the card idle, whole k loops where
the tile grid fills it.  The kernels round with ``quantize_rne_mul``, the
division-free form of ``quantize_rne``; its PyTorch mirror here must equal
``core/formats.quantize`` bitwise (the card test enumerates all 2**32 f32
patterns through the device functions themselves).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import formats as tf
from repro_torch.kernels import fused as tfused
from repro_torch.kernels.fused import (SPLIT_ROWS_MAX_M, TILE, QmmPlan,
                                       plan_qmm)

H100_SMS = 132
ROUNDED = [f for f in tf.REGISTRY.values()
           if f.exp_bits <= 8 and f.man_bits < 23]


def _decode_shapes(arch="tinyllama-1.1b"):
    cfg = get_config(arch)
    d, hd = cfg.d_model, cfg.head_dim
    return {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
            "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
            "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
            "w_down": (cfg.d_ff, d), "unembed": (d, cfg.vocab_size)}


@pytest.mark.parametrize("name", sorted(_decode_shapes()))
def test_plan_splits_every_decode_projection(name):
    k, n = _decode_shapes()[name]
    plan = plan_qmm(1, 4, n, k, H100_SMS)
    assert plan.schedule == "split_rows"
    assert plan.bm == 4
    assert plan.blocks == -(-n // plan.bn) * -(-k // TILE)
    assert plan.blocks >= 1.9 * H100_SMS  # about two waves at least


@pytest.mark.parametrize("m,n,k", [(2048, 5632, 2048), (1024, 2048, 2048),
                                   (4096, 32000, 2048), (1024, 2048, 5632)])
def test_plan_keeps_whole_k_where_the_tile_grid_fills_the_card(m, n, k):
    plan = plan_qmm(1, m, n, k, H100_SMS)
    assert plan == QmmPlan("whole", 64, 128, -(-m // 64) * -(-n // 128), 0)
    assert tfused.tile_fill(plan.blocks, H100_SMS) >= tfused.WHOLE_MIN_FILL


def test_plan_splits_small_n_at_prefill():
    plan = plan_qmm(1, 512, 256, 2048, H100_SMS)  # wk, wv at prefill
    assert plan.schedule == "split_tile"
    assert plan.blocks >= 1.9 * H100_SMS


@pytest.mark.parametrize("name", sorted(set(_decode_shapes()) - {"unembed"}))
def test_plan_splits_every_projection_of_a_512_row_prefill(name):
    """At M = 512 the last wave of 64 x 128 tiles is at most 2/3 full on
    132 SMs (two tile blocks to an SM), where split_tile measured faster."""
    k, n = _decode_shapes()[name]
    plan = plan_qmm(1, 512, n, k, H100_SMS)
    assert plan.schedule == "split_tile"
    assert tfused.tile_fill(8 * -(-n // 128), H100_SMS) <= 2 / 3


def test_tile_fill_counts_the_slots_of_every_wave():
    assert tfused.tile_fill(264, 132) == 1.0
    assert tfused.tile_fill(265, 132) == 265 / 528
    assert tfused.tile_fill(352, 132) == 352 / 528
    assert tfused.tile_fill(1, 1) == 0.5


def test_plan_one_k_block_needs_no_split():
    for m in (1, 16, 17, 512):
        assert plan_qmm(1, m, 37, 128, H100_SMS).schedule == "whole"
        assert plan_qmm(1, m, 37, 0, H100_SMS).schedule == "whole"


@pytest.mark.parametrize("seed", range(4))
def test_plan_tiles_stay_inside_logical_tiles(seed):
    """A thread block's rows never straddle a 128-row logical tile nor its
    columns a 128-column one (``scaled`` looks up those tiles' scales), and
    the workspace holds every k block's part of every output."""
    r = np.random.default_rng(seed)
    for _ in range(200):
        nb = int(r.integers(1, 4))
        m, n = (int(x) for x in r.integers(1, 1200, 2))
        if r.random() < 0.5:
            m = int(r.integers(1, SPLIT_ROWS_MAX_M + 1))
        k = int(r.integers(0, 3000))
        sms = int(r.choice([1, 8, 132, 100000]))
        plan = plan_qmm(nb, m, n, k, sms)
        assert TILE % plan.bn == 0
        if plan.schedule == "split_rows":
            assert m <= SPLIT_ROWS_MAX_M and plan.bm == m  # one row tile
        else:
            assert TILE % plan.bm == 0 and plan.bn == TILE
        gk = -(-k // TILE)
        if plan.schedule == "whole":
            assert plan.workspace_bytes == 0
        else:
            assert gk > 1
            assert plan.workspace_bytes == gk * nb * m * n * 4


def test_plan_workspace_of_the_unembed():
    k, n = _decode_shapes()["unembed"]
    assert plan_qmm(1, 4, n, k, H100_SMS).workspace_bytes == \
        16 * 4 * 32000 * 4


@pytest.mark.parametrize("shape", [(0, 4, 8, 256), (1, 0, 8, 256),
                                   (1, 4, 0, 256), (1, 4, 8, -1),
                                   (70000, 4, 8, 256), (1, 4, 8, 128 * 70000),
                                   (1, 128 * 70000, 8, 256)])
def test_plan_raises_on_shapes_it_cannot_take(shape):
    with pytest.raises(ValueError, match="plan_qmm"):
        plan_qmm(*shape, H100_SMS)
    with pytest.raises(ValueError, match="plan_qmm"):
        plan_qmm(1, 4, 8, 256, 0)


def test_vector_copies_need_16_byte_alignment():
    x = torch.empty(4, 304, dtype=torch.bfloat16)
    assert tfused._aligned16(x, (x.stride(0),))
    assert tfused._aligned16(x[:, :300], (x.stride(0),))
    assert not tfused._aligned16(x[:, 1:], (x.stride(0),))
    y = torch.empty(4, 300, dtype=torch.bfloat16)
    assert not tfused._aligned16(y, (y.stride(0),))
    assert tfused._aligned16(y.float(), (y.stride(0),))


# ---------------------------------------------------------------------------
# the multiplication form of the rounding
# ---------------------------------------------------------------------------
def _pow2_exact(e):
    """2**e as f32 for int32 e in [-149, 127] (subnormal below -126)."""
    normal = ((e.clamp(-126, 127) + 127) << 23).view(torch.float32)
    sub = (torch.ones_like(e) << (e.clamp(-149, -127) + 149)) \
        .view(torch.float32)
    return torch.where(e >= -126, normal, sub)


def _quantize_mul(x, fmt):
    """Mirror of ``csrc/quantize.cuh::quantize_rne_mul``: x * 2**-s in
    place of each division x / 2**s of ``formats.quantize``."""
    e = tf._unbiased_exp_f32(x)
    q_exp = e.clamp(fmt.emin, fmt.emax)
    scale_exp = q_exp - fmt.man_bits
    half_lo = scale_exp.clamp(-126, 127)
    half_hi = scale_exp - half_lo
    q = torch.round(x * _pow2_exact(-half_lo) * _pow2_exact(-half_hi))
    y = q * tf._pow2_from_exp(half_lo) * tf._pow2_from_exp(half_hi)
    y = torch.where(y.abs() > fmt.max_finite,
                    torch.copysign(torch.full_like(y, float("inf")), y), y)
    y = torch.where(torch.isfinite(x), y, x)
    return torch.where(x == 0, x, y)


def _tie_patterns():
    """Every exponent field 0-255, both signs; mantissas at a rounding tie
    of every bit position (so at each format's ties, normal and subnormal)
    and one ulp either side, plus 0, 1, 2**22 and all ones: zeros, f32
    subnormals, infs and NaNs among them."""
    r = np.random.default_rng(0)
    mants = {0, 1, 1 << 22, (1 << 23) - 1}
    for t in range(23):
        for j in [0, 1, 2, 3] + [int(v) for v in r.integers(0, 1 << 22, 4)]:
            tie = ((j << (t + 1)) | (1 << t)) & ((1 << 23) - 1)
            mants.update({tie, max(tie - 1, 0), min(tie + 1, (1 << 23) - 1)})
    mants = np.array(sorted(mants), np.int64)
    exps = np.arange(256, dtype=np.int64)
    bits = (exps[:, None] << 23 | mants[None, :]).ravel()
    bits = np.concatenate([bits, bits | (1 << 31)])
    return torch.from_numpy(bits.astype(np.uint32).view(np.int32)) \
        .view(torch.float32)


@pytest.mark.parametrize("fmt", ROUNDED, ids=[f.name for f in ROUNDED])
def test_multiplication_form_rounds_bitwise_as_quantize(fmt):
    x = _tie_patterns()
    assert bool(torch.isnan(x).any()) and bool(torch.isinf(x).any())
    assert bool(((x != 0) & (x.abs() < 2.0 ** -126)).any())  # subnormals
    want = tf.quantize(x, fmt)
    got = _quantize_mul(x, fmt)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("fmt", [tf.BF16, tf.TF32], ids=["bf16", "tf32"])
def test_rounding_a_bf16_value_onto_a_wider_format_is_the_identity(fmt):
    """Why K1 skips the rounding of an unscaled bf16 operand for formats
    that hold every bf16 value: every finite bf16 pattern comes back."""
    bits = torch.arange(1 << 16, dtype=torch.int32)
    x = (bits << 16).view(torch.float32)
    fin = torch.isfinite(x)
    y = tf.quantize(x, fmt)
    assert torch.equal(y[fin].view(torch.int32), x[fin].view(torch.int32))
