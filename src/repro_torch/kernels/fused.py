"""K1: fused quantize + matmul + dequant on the card (``csrc/qmm.cu``),
K4: blockwise flash attention with per-block quantize/dequant
(``csrc/flash_attn.cu``), and K5: the selective scan with format-rounded
operands (``csrc/ssm_scan.cu``).

Counterpart of ``repro.kernels.fused``.

K1: the TPU kernel ran the grid (B, M/128, N/128, K/128) with the k axis
sequential into a VMEM accumulator.  On the card ``plan_qmm`` picks one of
three schedules: ``whole`` (one thread block per output tile loops over the
128-deep k blocks and folds them in registers; prefill shapes whose tile
grid fills the card), ``split_rows`` (M <= 16, decode: one thread block per
column tile and k block) or ``split_tile`` (prefill shapes with a small
tile grid); a split writes each k block's part to a workspace that a second
kernel folds in k-block order.  ``fused_qmm_ref`` is the plain version: a
replay of the same k-block schedule in PyTorch, which the CPU path runs and
the card check compares against.
Power-of-two scaling (``scaled=True``) is exact: the scale is built from
exponent bits of the tile's largest magnitude, so rescaling adds no rounding
of its own and a scaled product equals the unscaled one wherever the
format's range suffices.

K4: the TPU kernel ran the grid (B, Hq, Sq/bq, Sk/bk) with the kv axis
sequential into VMEM online-softmax state; the CUDA kernel gives each thread
block one (q block, head, batch) and loops over the kv blocks inside it.
``fused_flash_ref`` is its plain version, the same block schedule with every
sum in the kernel's fixed order (so the two are bitwise equal on the card);
``fused_flash_scan`` is the fast twin that sums with matrix products, the
CPU path of ``emulated_flash_attention``.

K5 shares K6's device code (``kernels/ssm_scan.py``) with the operands
rounded as they are read; ``ssm_scan_quantized_ref`` is its plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.core.formats import (FloatFormat, _pow2_from_exp,
                                      _unbiased_exp_f32, quantize)
from repro_torch.kernels import _build
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels._build import sm_count
from repro_torch.kernels.ref import STYLES, TILE, accumulate

_STYLE_CODE = {"fused": 0, "cascade": 1, "cascade_fwd": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pow2_scale(x: torch.Tensor, fmt: FloatFormat, dims):
    """(scale, inv_scale) per tile, reducing over ``dims`` (kept as size-1
    dims): moves the tile's max magnitude into binade clip(e, emin,
    emax - 1) when it lies outside the format's normal range."""
    e = _unbiased_exp_f32(x.abs().amax(dim=dims, keepdim=True))
    scale_exp = (e - e.clamp(fmt.emin, fmt.emax - 1)).clamp(-126, 126)
    return _pow2_from_exp(scale_exp), _pow2_from_exp(-scale_exp)


def fused_qmm_ref(a: torch.Tensor, b: torch.Tensor, *, fmt: FloatFormat,
                  style: str = "fused", out_fmt: FloatFormat | None = None,
                  scaled: bool = False, bm: int | None = None,
                  bn: int | None = None) -> torch.Tensor:
    """Plain version of ``fused_qmm``: the same tiles and op order.

    ``bm``/``bn`` default to one tile over the whole output, as the JAX
    ``fused_qmm_ref``; pass 128/128 to replay the kernel's tiling (it only
    matters with ``scaled=True``, where each tile has its own scale)."""
    if style not in STYLES:
        raise ValueError(f"style must be one of {STYLES}, got {style!r}")
    batched = a.dim() == 3
    a3 = a if batched else a[None]
    nb, m, kdim = a3.shape
    n = b.shape[1]
    bm = m if bm is None else bm
    bn = n if bn is None else bn
    pm, pn, pk = (-m) % bm, (-n) % bn, (-kdim) % TILE
    a_p = F.pad(a3.to(torch.float32), (0, pk, 0, pm))
    b_p = F.pad(b.to(torch.float32), (0, pn, 0, pk))
    gm, gn, gk = (m + pm) // bm, (n + pn) // bn, (kdim + pk) // TILE
    a_t = a_p.reshape(nb, gm, bm, gk, TILE)
    b_t = b_p.reshape(gk, TILE, gn, bn)
    acc = torch.zeros((nb, gm, bm, gn, bn), dtype=torch.float32,
                      device=a.device)
    for k in range(gk):
        ak, bk = a_t[:, :, :, k], b_t[k]  # (nb, gm, bm, TILE), (TILE, gn, bn)
        if scaled:
            sa, inv_a = _pow2_scale(ak, fmt, dims=(2, 3))
            sb, inv_b = _pow2_scale(bk, fmt, dims=(0, 2))
            ak, bk = ak * inv_a, bk * inv_b
        part = (quantize(ak, fmt).reshape(-1, TILE)
                @ quantize(bk, fmt).reshape(TILE, -1))
        part = part.reshape(nb, gm, bm, gn, bn)
        if scaled:
            part = part * (sa.reshape(nb, gm, 1, 1, 1)
                           * sb.reshape(1, 1, 1, gn, 1))
        acc = accumulate(acc, part, fmt, style)
    if out_fmt is not None:
        acc = quantize(acc, out_fmt)
    out = acc.reshape(nb, gm * bm, gn * bn)[:, :m, :n]
    return out if batched else out[0]


#: the planner's thresholds, set between readings of scripts/qmm_sweep.py
#: on the H100 (PERF.md): the whole-k schedule runs where its tile blocks,
#: TILE_BLOCKS_PER_SM to an SM (bf16 operands), keep at least this share of
#: the slots of their waves busy (split_tile was faster at 0.48 and 0.67,
#: whole at 0.89 and 0.97); split_rows narrows its column tile until the
#: grid holds SPLIT_WAVES waves of the card's SMs (2 was the fastest bf16
#: decode forward of 1, 2 and 4)
WHOLE_MIN_FILL = 0.78
TILE_BLOCKS_PER_SM = 2
SPLIT_WAVES = 2.0
#: the most rows the split_rows schedule takes (decode batches), and the
#: rows of the tiled kernel's output tile
SPLIT_ROWS_MAX_M = 16
TILE_BM = 64
_SCHEDULE_CODE = {"whole": 0, "split_rows": 1, "split_tile": 2}
_GRID_YZ_MAX = 65535


@dataclasses.dataclass(frozen=True)
class QmmPlan:
    """How K1 runs one call on the card: the schedule, the output tile
    (``bm`` rows by ``bn`` columns, each dividing the 128 x 128 logical
    tile), the thread blocks of the main kernel, and the bytes of the f32
    workspace (gk, B, M, N) of a split schedule (0 for ``whole``)."""

    schedule: str
    bm: int
    bn: int
    blocks: int
    workspace_bytes: int


def plan_qmm(nb: int, m: int, n: int, k: int, sm_count: int) -> QmmPlan:
    """The schedule of one K1 call, (nb, m, k) @ (k, n), on a card with
    ``sm_count`` SMs.

    The whole k loop stays in one thread block when the grid of 64 x 128
    output tiles keeps at least ``WHOLE_MIN_FILL`` of the slots of its
    waves busy (or there is one k block at most): a last wave that is
    mostly empty costs more than the split's workspace and fold.
    Otherwise the k blocks run in parallel thread blocks and a fold
    follows.  M <= 16 always splits (decode: a few rows,
    every weight read once), with the widest column tile that still gives
    ``SPLIT_WAVES`` waves.  Raises on shapes the kernels cannot take."""
    if min(nb, m, n, sm_count) < 1 or k < 0:
        raise ValueError(f"plan_qmm: bad shape nb={nb} m={m} n={n} k={k} "
                         f"sm_count={sm_count}")
    gk = -(-k // TILE)
    if m <= SPLIT_ROWS_MAX_M and gk > 1:
        for bn in (128, 64, 32, 16):
            blocks = -(-n // bn) * gk * nb
            if blocks >= SPLIT_WAVES * sm_count:
                break
        plan = QmmPlan("split_rows", m, bn, blocks, 4 * gk * nb * m * n)
        if gk > _GRID_YZ_MAX or nb > _GRID_YZ_MAX:
            raise ValueError(f"plan_qmm: k={k} or nb={nb} beyond the grid")
        return plan
    tiles = nb * -(-m // TILE_BM) * -(-n // TILE)
    if gk <= 1 or tile_fill(tiles, sm_count) >= WHOLE_MIN_FILL:
        plan = QmmPlan("whole", TILE_BM, TILE, tiles, 0)
    else:
        plan = QmmPlan("split_tile", TILE_BM, TILE, tiles * gk,
                       4 * gk * nb * m * n)
    grid_z = nb * (gk if plan.schedule == "split_tile" else 1)
    if -(-m // plan.bm) > _GRID_YZ_MAX or grid_z > _GRID_YZ_MAX:
        raise ValueError(f"plan_qmm: m={m}, nb={nb} or k={k} beyond the "
                         f"grid")
    return plan


def tile_fill(tiles: int, sm_count: int) -> float:
    """The share of thread-block slots that ``tiles`` blocks of the tiled
    kernel keep busy over their waves, TILE_BLOCKS_PER_SM to an SM."""
    slots = TILE_BLOCKS_PER_SM * sm_count
    return tiles / (-(-tiles // slots) * slots)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point of K1 and K3, built and loaded at first use."""
    fn = _build.load("qmm").repro_fused_qmm
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, ll, ll, p, i, ll, ll, p, i, i, i, i, i, i, i, i, i,
                   i, p, p, i, i, i, i, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _rounding_entry():
    """The test entry of ``csrc/qmm.cu`` that enumerates f32 patterns."""
    fn = _build.load("qmm").repro_qmm_rounding_mismatches
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rounding_mismatches(fmt: FloatFormat, device) -> tuple[int, int]:
    """Test entry of ``csrc/qmm.cu`` on a CUDA device: over all 2**32 f32
    bit patterns, how many round differently (bitwise) through the kernels'
    multiplication form than through the division form K2 runs; and over
    the 2**16 bf16 patterns, how many finite ones the rounding moves (0
    where ``fmt`` holds every bf16 value, which is why K1 skips rounding an
    unscaled bf16 operand there)."""
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    _build.check(_rounding_entry()(
        fmt.exp_bits, fmt.man_bits, counts.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream),
        "rounding check kernel")
    mul_vs_div, bf16_moved = counts.tolist()
    return mul_vs_div, bf16_moved


def _aligned16(t: torch.Tensor, strides) -> bool:
    """16-byte copies fit: the base and the given strides (in elements) are
    multiples of 16 bytes."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * size % 16 == 0
                                          for s in strides)


def check_operands(a: torch.Tensor, b: torch.Tensor, fmt: FloatFormat,
                   style: str) -> None:
    """What the CUDA kernels accept; raises on anything else."""
    if style not in STYLES:
        raise ValueError(f"style must be one of {STYLES}, got {style!r}")
    if fmt.exp_bits > 8 or fmt.man_bits > 23:
        raise ValueError(f"f32 quantize path supports sub-f32 formats, got {fmt}")
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if a.stride(-1) != 1:
        raise ValueError("a must be contiguous along k")
    if b.stride(0) != 1 and b.stride(1) != 1:
        raise ValueError("b must be contiguous along k or along n")


def launch(a3: torch.Tensor, b: torch.Tensor, fmt: FloatFormat, style: str,
           out_fmt: FloatFormat | None, scaled: bool) -> torch.Tensor:
    """One launch of the device code on CUDA operands a3 (B, M, K) and b
    (K, N), f32 (B, M, N) out, on the schedule ``plan_qmm`` picks.  The
    caller counts the launch."""
    check_operands(a3, b, fmt, style)
    nb, m, kdim = a3.shape
    n = b.shape[1]
    plan = plan_qmm(nb, m, n, kdim, sm_count(a3.device))
    out = torch.empty((nb, m, n), dtype=torch.float32, device=a3.device)
    gk = -(-kdim // TILE)
    ws = None
    if plan.schedule != "whole":
        ws = torch.empty((gk, nb, m, n), dtype=torch.float32,
                         device=a3.device)
    a_scale = b_scale = None
    if scaled:
        a_scale = torch.empty((nb, -(-m // TILE), gk), dtype=torch.int32,
                              device=a3.device)
        b_scale = torch.empty((gk, -(-n // TILE)), dtype=torch.int32,
                              device=a3.device)
    out_exp, out_man = (out_fmt.exp_bits, out_fmt.man_bits) if out_fmt \
        else (0, 0)
    b_lead = b.stride(1) if b.stride(0) == 1 and b.stride(1) != 1 \
        else b.stride(0)
    vec = _aligned16(a3, (a3.stride(0), a3.stride(1))) and \
        _aligned16(b, (b_lead,))
    rc = _entry()(
        a3.data_ptr(), _DTYPE_CODE[a3.dtype], a3.stride(0), a3.stride(1),
        b.data_ptr(), _DTYPE_CODE[b.dtype], b.stride(0), b.stride(1),
        out.data_ptr(), nb, m, n, kdim, fmt.exp_bits, fmt.man_bits,
        _STYLE_CODE[style], out_exp, out_man, int(scaled),
        a_scale.data_ptr() if scaled else None,
        b_scale.data_ptr() if scaled else None,
        _SCHEDULE_CODE[plan.schedule], plan.bm, plan.bn, int(vec),
        ws.data_ptr() if ws is not None else None,
        torch.cuda.current_stream(a3.device).cuda_stream)
    _build.check(rc, "qmm kernel")
    return out


def fused_qmm(a: torch.Tensor, b: torch.Tensor, *, fmt: FloatFormat,
              style: str = "fused", out_fmt: FloatFormat | None = None,
              scaled: bool = False) -> torch.Tensor:
    """(B?, M, K) @ (K, N) fully fused: quantize -> f32 dot -> dequant.

    CPU tensors take ``fused_qmm_ref`` at the kernel's 128 x 128 tiling; a
    CUDA tensor launches the kernel on ``plan_qmm``'s schedule (f32 or bf16
    operands, b through its strides) and counts the launch in
    ``fused_qmm.launches``."""
    batched = a.dim() == 3
    a3 = a if batched else a[None]
    if a3.dim() != 3 or b.dim() != 2 or a3.shape[2] != b.shape[0]:
        raise ValueError(f"bad qmm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device.type == "cpu":
        return fused_qmm_ref(a, b, fmt=fmt, style=style, out_fmt=out_fmt,
                             scaled=scaled, bm=TILE, bn=TILE)
    if a.device.type != "cuda":
        raise ValueError(f"fused_qmm runs on cpu or cuda, got {a.device}")
    out = launch(a3, b, fmt, style, out_fmt, scaled)
    fused_qmm.launches += 1
    return out if batched else out[0]


fused_qmm.launches = 0


# ---------------------------------------------------------------------------
# K5: the selective scan with format-rounded operands (csrc/ssm_scan.cu)
# ---------------------------------------------------------------------------
def ssm_scan_quantized_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                           *, fmt: FloatFormat | None,
                           out_fmt: FloatFormat | None = None):
    """Plain version of ``ssm_scan_quantized``: a, b and c rounded to
    ``fmt`` (skipped for ``None``), then the sequential recurrence in an f32
    state and the readout summed over n left to right, y rounded to
    ``out_fmt`` if given.  The rounding is elementwise, so it is applied to
    whole tensors, with the same result as per token."""
    _ssm.check_shapes(a, b, c)
    a, b, c = (t.to(torch.float32) for t in (a, b, c))
    if fmt is not None:
        a, b, c = quantize(a, fmt), quantize(b, fmt), quantize(c, fmt)
    return _ssm.scan_ref(a, b, c, out_fmt)


def ssm_scan_quantized(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                       fmt: FloatFormat | None,
                       out_fmt: FloatFormat | None = None, chunk: int = 64,
                       bd: int = 256):
    """Quantized selective scan: a, b (B, S, D, N), c (B, S, N) ->
    (y (B, S, D), h_last (B, D, N)), f32.

    The operands are rounded to ``fmt`` as they are read; the state stays
    in f32 (the unit's extended accumulator) and ``out_fmt`` optionally
    rounds the readout.  S % chunk == 0 and D % bd == 0 are required (bd
    clamped to D first), as in the JAX package.  CPU tensors take
    ``ssm_scan_quantized_ref`` after those checks; a CUDA tensor launches
    the kernel and counts the launch in ``ssm_scan_quantized.launches``."""
    _ssm.check_shapes(a, b, c)
    B, S, D, N = a.shape
    bd = min(bd, D)
    if S % chunk or D % bd:
        raise ValueError(f"S={S} % chunk={chunk} or D={D} % bd={bd} != 0")
    if a.device.type == "cpu":
        return ssm_scan_quantized_ref(a, b, c, fmt=fmt, out_fmt=out_fmt)
    if a.device.type != "cuda":
        raise ValueError(f"ssm_scan_quantized runs on cpu or cuda, got "
                         f"{a.device}")
    out = _ssm.launch(a, b, c, fmt, out_fmt)
    ssm_scan_quantized.launches += 1
    return out


ssm_scan_quantized.launches = 0


# ---------------------------------------------------------------------------
# K4: blockwise flash attention with per-block quantize/dequant
# (csrc/flash_attn.cu)
# ---------------------------------------------------------------------------
NEG_INF = -1.0e30
#: what the kernel takes: head dims up to 128 and blocks of up to 128 rows
#: (one thread per q row; the rounded tiles of a block pair in shared memory)
FLASH_MAX_D = 128
FLASH_MAX_BLOCK = 128


def _qk_ordered(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """s[..., i, j] = the sum over d = 0..D-1, left to right, of
    q[..., i, d] * k[..., j, d]: one rounded multiply and one rounded add
    per term, the first term taken as it is (the kernel's order)."""
    s = q[..., :, None, 0] * k[..., None, :, 0]
    for d in range(1, q.shape[-1]):
        s = s + q[..., :, None, d] * k[..., None, :, d]
    return s


def _pv_ordered(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[..., i, d] = the sum over j = 0..bk-1, left to right, of
    p[..., i, j] * v[..., j, d] (the kernel's order)."""
    out = p[..., :, 0, None] * v[..., None, 0, :]
    for j in range(1, p.shape[-1]):
        out = out + p[..., :, j, None] * v[..., None, j, :]
    return out


def _rowsum_ordered(p: torch.Tensor) -> torch.Tensor:
    """The sum over the last dim, left to right (the kernel's order)."""
    out = p[..., 0]
    for j in range(1, p.shape[-1]):
        out = out + p[..., j]
    return out


def _quantize_tile(x: torch.Tensor, fmt: FloatFormat, scaled: bool):
    """Round tiles (the last two dims) to ``fmt``; returns (q, dequant
    scale), the scale None when unscaled."""
    if not scaled:
        return quantize(x, fmt), None
    scale, inv = _pow2_scale(x, fmt, dims=(-2, -1))
    return quantize(x * inv, fmt), scale


def _flash_block_update(carry, q_blk, k_blk, v_blk, mask, *, scale: float,
                        fmt: FloatFormat | None, scaled: bool,
                        ordered: bool):
    """One (q-block, kv-block) online-softmax update, batched over leading
    dims: q_blk (..., bq, D), k_blk and v_blk (..., bk, D), ``mask``
    (..., bq, bk).  With ``fmt`` set, q/k/v are rounded per tile (exact pow2
    scaling when ``scaled``) and each partial dot is dequantized before it
    enters the f32 state.  ``ordered`` sums in the kernel's fixed order
    (``fused_flash_ref``); otherwise with matrix products
    (``fused_flash_scan``)."""
    m, l, acc = carry
    if fmt is not None:
        qq, sq = _quantize_tile(q_blk, fmt, scaled)
        qk, sk = _quantize_tile(k_blk, fmt, scaled)
        qv, sv = _quantize_tile(v_blk, fmt, scaled)
    else:
        qq, qk, qv = q_blk, k_blk, v_blk
        sq = sk = sv = None
    s = _qk_ordered(qq, qk) if ordered else qq @ qk.mT
    if sq is not None:
        s = s * (sq * sk)
    s = s * scale
    s_m = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s_m.amax(dim=-1))
    m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    # a product, not a select: a masked score far above m_safe gives
    # inf * 0 = NaN, as in the reference
    p = torch.exp(s - m_safe[..., None]) * mask
    corr = torch.exp(torch.clamp(m - m_safe, max=0.0)) * (m > NEG_INF / 2)
    l_new = l * corr + (_rowsum_ordered(p) if ordered else p.sum(dim=-1))
    if fmt is not None:
        # the probability operand register: p is in [0, 1], no scale needed
        p = quantize(p, fmt)
    pv = _pv_ordered(p, qv) if ordered else p @ qv
    if sv is not None:
        pv = pv * sv
    acc_new = acc * corr[..., None] + pv
    return m_new, l_new, acc_new


def _flash_mask(q_pos, k_pos, *, causal: bool, window: int, kv_len: int):
    m = k_pos[None, :] < kv_len
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_q: int, block_k: int) -> None:
    """q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D) on one device, Hq a
    multiple of Hkv; raises otherwise."""
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape) \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or 0 in q.shape[:2] or k.shape[1] == 0:
        raise ValueError(f"bad flash shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"blocks must be positive, got {block_q}, "
                         f"{block_k}")


def _f32_scale(D: int) -> float:
    """1/sqrt(D) rounded to f32 (not exact for D = 128), as the float the
    kernel gets."""
    return float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32))


def _flash_forward(q, k, v, *, fmt, scaled, causal, window, kv_len,
                   q_offset, out_fmt, block_q, block_k, ordered):
    """The block schedule of K4 in PyTorch, vectorised over batch, heads and
    q blocks, in order over the kv blocks."""
    _check_flash(q, k, v, block_q, block_k)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = _f32_scale(D)
    kv_len = Sk if kv_len is None else kv_len
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    pq, pk = (-Sq) % bq, (-Sk) % bk
    nq, nk = (Sq + pq) // bq, (Sk + pk) // bk
    # q: (B, Hkv, G, nq, bq, D); k, v: (B, Hkv, nk, bk, D) -- q head h reads
    # kv head h // G through broadcasting, with no repeated KV
    qf = F.pad(q.to(torch.float32), (0, 0, 0, 0, 0, pq)).reshape(
        B, nq, bq, Hkv, G, D).permute(0, 3, 4, 1, 2, 5)
    kf, vf = (F.pad(t.to(torch.float32), (0, 0, 0, 0, 0, pk)).reshape(
        B, nk, bk, Hkv, D).permute(0, 3, 1, 2, 4) for t in (k, v))
    dev = q.device
    q_pos = q_offset + torch.arange(nq * bq, device=dev)
    m = torch.full((B, Hkv, G, nq, bq), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G, nq, bq), device=dev)
    acc = torch.zeros((B, Hkv, G, nq, bq, D), device=dev)
    for kj in range(nk):
        k_pos = kj * bk + torch.arange(bk, device=dev)
        mask = _flash_mask(q_pos, k_pos, causal=causal, window=window,
                           kv_len=kv_len).expand(nq * bq, bk).reshape(
                               nq, bq, bk)
        m, l, acc = _flash_block_update(
            (m, l, acc), qf, kf[:, :, None, None, kj],
            vf[:, :, None, None, kj], mask, scale=scale, fmt=fmt,
            scaled=scaled, ordered=ordered)
    out = acc / torch.maximum(l, l.new_tensor(1e-30))[..., None]
    if out_fmt is not None:
        out = quantize(out, out_fmt)
    out = out.permute(0, 3, 4, 1, 2, 5).reshape(B, nq * bq, Hq, D)[:, :Sq]
    return out.to(q.dtype)


def fused_flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    fmt: FloatFormat | None, scaled: bool = True,
                    causal: bool = True, window: int = 0,
                    kv_len: int | None = None, q_offset: int = 0,
                    out_fmt: FloatFormat | None = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Plain version of ``fused_flash_attention``: the kernel's block
    schedule and op order, every sum in the kernel's fixed order (s over d,
    l and pv over j, each left to right), so the two are bitwise equal on
    the card."""
    return _flash_forward(q, k, v, fmt=fmt, scaled=scaled, causal=causal,
                          window=window, kv_len=kv_len, q_offset=q_offset,
                          out_fmt=out_fmt, block_q=block_q, block_k=block_k,
                          ordered=True)


def fused_flash_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     fmt: FloatFormat | None, scaled: bool = True,
                     causal: bool = True, window: int = 0,
                     kv_len: int | None = None, q_offset: int = 0,
                     out_fmt: FloatFormat | None = None, block_q: int = 128,
                     block_k: int = 128) -> torch.Tensor:
    """Fast twin (the CPU path of ``emulated_flash_attention``): the same
    block schedule and per-block math, with the dots as matrix products, so
    it agrees with the kernel to f32 tolerance rather than bitwise.  On a
    CUDA tensor it refuses to run with TF32 matmuls enabled."""
    if q.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("fused_flash_scan needs IEEE f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return _flash_forward(q, k, v, fmt=fmt, scaled=scaled, causal=causal,
                          window=window, kv_len=kv_len, q_offset=q_offset,
                          out_fmt=out_fmt, block_q=block_q, block_k=block_k,
                          ordered=False)


@functools.lru_cache(maxsize=None)
def _flash_entry():
    """The C entry point of K4, built and loaded at first use."""
    fn = _build.load("flash_attn").repro_flash_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p] + [i] * 18 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def _flash_launch(q, k, v, fmt, scaled, causal, window, kv_len, q_offset,
                  out_fmt, bq, bk) -> torch.Tensor:
    """One launch of K4 on CUDA operands; out in q's dtype.  The caller
    counts the launch."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D > FLASH_MAX_D:
        raise ValueError(f"the flash kernel takes head dims up to "
                         f"{FLASH_MAX_D}, got D={D}")
    if bq > FLASH_MAX_BLOCK or bk > FLASH_MAX_BLOCK:
        raise ValueError(f"the flash kernel takes blocks up to "
                         f"{FLASH_MAX_BLOCK} rows, got {bq} and {bk}")
    for f in (fmt, out_fmt):
        if f is not None and (f.exp_bits > 8 or f.man_bits > 23):
            raise ValueError(f"f32 flash path supports sub-f32 formats, "
                             f"got {f}")
    # bf16 operands are read as they are; anything else is widened (or, for
    # float64, rounded) to f32 first, as the JAX kernel's astype(float32)
    q_dtype = q.dtype
    dt = torch.bfloat16 if q.dtype == k.dtype == v.dtype == torch.bfloat16 \
        else torch.float32
    q, k, v = (t.to(dt).contiguous() for t in (q, k, v))
    out = torch.empty((B, Sq, Hq, D), dtype=dt, device=q.device)
    exp_bits, man_bits = (fmt.exp_bits, fmt.man_bits) if fmt else (0, 0)
    out_exp, out_man = (out_fmt.exp_bits, out_fmt.man_bits) if out_fmt \
        else (0, 0)
    rc = _flash_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(dt == torch.bfloat16), B, Sq, Sk, Hq, Hkv, D, bq, bk, exp_bits,
        man_bits, int(scaled), out_exp, out_man, int(causal), int(window),
        int(kv_len), int(q_offset), _f32_scale(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash attention kernel")
    return out if dt == q_dtype else out.to(q_dtype)


def fused_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, fmt: FloatFormat | None, scaled: bool = True,
                          causal: bool = True, window: int = 0,
                          kv_len: int | None = None, q_offset: int = 0,
                          out_fmt: FloatFormat | None = None,
                          block_q: int = 128,
                          block_k: int = 128) -> torch.Tensor:
    """Blockwise flash attention with per-block quantize/dequant.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype,
    computed in f32.  Every q/k/v tile is rounded to ``fmt`` (exact pow2
    scaling when ``scaled``), the probabilities too, and each partial dot
    is dequantized into the f32 online-softmax state; ``fmt=None`` runs the
    same schedule unrounded.  q head h reads kv head h // (Hq // Hkv).
    ``kv_len`` masks keys at or beyond it, ``q_offset`` is q[0]'s position,
    ``window`` > 0 keeps the last ``window`` keys.  CPU tensors take
    ``fused_flash_ref`` behind the same argument checks; a CUDA tensor
    launches the kernel (D and the blocks up to 128) and counts the launch
    in ``fused_flash_attention.launches``."""
    _check_flash(q, k, v, block_q, block_k)
    kw = dict(fmt=fmt, scaled=scaled, causal=causal, window=window,
              kv_len=kv_len, q_offset=q_offset, out_fmt=out_fmt)
    if q.device.type == "cpu":
        return fused_flash_ref(q, k, v, block_q=block_q, block_k=block_k,
                               **kw)
    if q.device.type != "cuda":
        raise ValueError(f"fused_flash_attention runs on cpu or cuda, got "
                         f"{q.device}")
    Sq, Sk = q.shape[1], k.shape[1]
    kw["kv_len"] = Sk if kv_len is None else kv_len
    out = _flash_launch(q, k, v, bq=min(block_q, Sq), bk=min(block_k, Sk),
                        **kw)
    fused_flash_attention.launches += 1
    return out


fused_flash_attention.launches = 0
