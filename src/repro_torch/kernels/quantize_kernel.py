"""K2: elementwise round-to-format on the card (``csrc/quantize.cu``).

Counterpart of ``repro.kernels.quantize_kernel``.  The TPU kernel tiled a
2-D array into (rows x 128-lane) blocks and ``quantize_nd`` folded leading
dims onto it; the CUDA kernel runs over the flattened tensor, so the one
wrapper takes any shape.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.formats import FloatFormat
from repro_torch.kernels import _build
from repro_torch.kernels.ref import quantize_ref


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point of K2, built and loaded at first use."""
    fn = _build.load("quantize").repro_quantize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_nd(x: torch.Tensor, *, fmt: FloatFormat) -> torch.Tensor:
    """Round ``x`` onto ``fmt``'s grid, as f32 of the same shape.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``quantize_nd.launches``)."""
    if fmt.exp_bits > 8 or fmt.man_bits > 23:
        raise ValueError(f"f32 quantize path supports sub-f32 formats, got {fmt}")
    if x.device.type == "cpu":
        return quantize_ref(x, fmt=fmt)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_nd runs on cpu or cuda, got {x.device}")
    x = x.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    rc = _entry()(x.data_ptr(), out.data_ptr(), x.numel(), fmt.exp_bits,
                  fmt.man_bits,
                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "quantize kernel")
    quantize_nd.launches += 1
    return out


quantize_nd.launches = 0
