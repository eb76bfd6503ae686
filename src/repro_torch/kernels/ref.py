"""Plain PyTorch versions of the emulation kernels (counterpart of
``repro.kernels.ref``).

``fma_emu_matmul_ref`` replays the kernels' k-block schedule: round the
operands of each ``TILE``-deep block, take the f32 partial dot, fold it into
the accumulator by style.  The CPU path of every wrapper runs these, and the
card check holds each CUDA kernel against them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.formats import FloatFormat, quantize

STYLES = ("fused", "cascade", "cascade_fwd")
#: the k block at whose edges the cascade styles round; also the logical
#: tile of the scale in ``scaled`` mode (the TPU kernel's 128 x 128 tiles)
TILE = 128


def accumulate(acc: torch.Tensor, part: torch.Tensor, fmt: FloatFormat,
               style: str) -> torch.Tensor:
    """Fold one k block's f32 partial dot into the accumulator."""
    if style == "fused":
        return acc + part
    if style == "cascade_fwd":
        return acc + quantize(part, fmt)
    if style == "cascade":
        return quantize(acc + quantize(part, fmt), fmt)
    raise ValueError(f"style must be one of {STYLES}, got {style!r}")


def fma_emu_matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
                       fmt: FloatFormat, style: str = "fused",
                       out_fmt: FloatFormat | None = None) -> torch.Tensor:
    """(M, K) @ (K, N) under the k-block rounding schedule, in f32.

    M and N are zero-padded to whole 128 x 128 tiles, as the kernels tile
    them: padding changes no value, and on the card it gives each block's
    product the shape at which cuBLAS sums the partial dot in k order, as
    the kernels do."""
    m, kdim = a.shape
    n = b.shape[1]
    pm, pn, pk = (-m) % TILE, (-n) % TILE, (-kdim) % TILE
    a_p = F.pad(a.to(torch.float32), (0, pk, 0, pm))
    b_p = F.pad(b.to(torch.float32), (0, pn, 0, pk))
    acc = torch.zeros((m + pm, n + pn), dtype=torch.float32, device=a.device)
    for k in range(0, kdim + pk, TILE):
        part = (quantize(a_p[:, k:k + TILE], fmt)
                @ quantize(b_p[k:k + TILE], fmt))
        acc = accumulate(acc, part, fmt, style)
    if out_fmt is not None:
        acc = quantize(acc, out_fmt)
    return acc[:m, :n]


def quantize_ref(x: torch.Tensor, *, fmt: FloatFormat) -> torch.Tensor:
    """Plain version of the quantize kernel: ``formats.quantize`` itself."""
    return quantize(x, fmt)
