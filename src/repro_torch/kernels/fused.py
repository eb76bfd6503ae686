"""K1: fused quantize + matmul + dequant on the card (``csrc/qmm.cu``), and
K5: the selective scan with format-rounded operands (``csrc/ssm_scan.cu``).

Counterpart of the ``fused_qmm`` and ``ssm_scan_quantized`` parts of
``repro.kernels.fused`` (``fused_flash_attention`` arrives with the
attention slice).

K1: the TPU kernel ran the grid (B, M/128, N/128, K/128) with the k axis
sequential into a VMEM accumulator; the CUDA kernel gives each thread block
one output tile and loops over the 128-deep k blocks inside it.
``fused_qmm_ref`` is the plain version: a replay of the same tile schedule
in PyTorch, which the CPU path runs and the card check compares against.
Power-of-two scaling (``scaled=True``) is exact: the scale is built from
exponent bits of the tile's largest magnitude, so rescaling adds no rounding
of its own and a scaled product equals the unscaled one wherever the
format's range suffices.

K5 shares K6's device code (``kernels/ssm_scan.py``) with the operands
rounded as they are read; ``ssm_scan_quantized_ref`` is its plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.formats import (FloatFormat, _pow2_from_exp,
                                      _unbiased_exp_f32, quantize)
from repro_torch.kernels import _build
from repro_torch.kernels import ssm_scan as _ssm
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


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point of K1 and K3, built and loaded at first use."""
    fn = _build.load("qmm").repro_fused_qmm
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, ll, ll, ll, p, i, ll, ll, p, i, i, i, i, i, i, i,
                   i, i, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


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
    (K, N), f32 (B, M, N) out.  The caller counts the launch."""
    check_operands(a3, b, fmt, style)
    nb, m, kdim = a3.shape
    n = b.shape[1]
    out = torch.empty((nb, m, n), dtype=torch.float32, device=a3.device)
    a_scale = b_scale = None
    if scaled:
        gk = -(-kdim // TILE)
        a_scale = torch.empty((nb, -(-m // TILE), gk), dtype=torch.int32,
                              device=a3.device)
        b_scale = torch.empty((gk, -(-n // TILE)), dtype=torch.int32,
                              device=a3.device)
    out_exp, out_man = (out_fmt.exp_bits, out_fmt.man_bits) if out_fmt \
        else (0, 0)
    rc = _entry()(
        a3.data_ptr(), _DTYPE_CODE[a3.dtype], a3.stride(0), a3.stride(1),
        a3.stride(2), b.data_ptr(), _DTYPE_CODE[b.dtype], b.stride(0),
        b.stride(1), out.data_ptr(), nb, m, n, kdim, fmt.exp_bits,
        fmt.man_bits, _STYLE_CODE[style], out_exp, out_man, int(scaled),
        a_scale.data_ptr() if scaled else None,
        b_scale.data_ptr() if scaled else None,
        torch.cuda.current_stream(a3.device).cuda_stream)
    _build.check(rc, "qmm kernel")
    return out


def fused_qmm(a: torch.Tensor, b: torch.Tensor, *, fmt: FloatFormat,
              style: str = "fused", out_fmt: FloatFormat | None = None,
              scaled: bool = False) -> torch.Tensor:
    """(B?, M, K) @ (K, N) fully fused: quantize -> f32 dot -> dequant.

    CPU tensors take ``fused_qmm_ref`` at the kernel's 128 x 128 tiling; a
    CUDA tensor launches the kernel (f32 or bf16 operands, b through its
    strides) and counts the launch in ``fused_qmm.launches``."""
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
