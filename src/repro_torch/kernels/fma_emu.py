"""K3: emulated-precision matmul, 2-D and unscaled (``csrc/qmm.cu``).

Counterpart of ``repro.kernels.fma_emu``: the FPMax accumulation styles on a
k-block schedule ('fused' = extended f32 accumulator, 'cascade' = round
after every k-block add, 'cascade_fwd' = rounded partial products into an
unrounded accumulator).  It launches K1's device code with one batch slice
and no scaling, and keeps its own launch count, so ``emulated_matmul``'s
``impl='pallas'`` route stays distinct from ``impl='fused'`` as in the JAX
package.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import FloatFormat
from repro_torch.kernels import fused
from repro_torch.kernels.ref import fma_emu_matmul_ref


def fma_emu_matmul(a: torch.Tensor, b: torch.Tensor, *, fmt: FloatFormat,
                   style: str = "fused",
                   out_fmt: FloatFormat | None = None) -> torch.Tensor:
    """(M, K) @ (K, N) in emulated precision ``fmt``, f32 out.

    CPU tensors take ``fma_emu_matmul_ref``; a CUDA tensor launches the
    kernel and counts the launch in ``fma_emu_matmul.launches``."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu":
        return fma_emu_matmul_ref(a, b, fmt=fmt, style=style, out_fmt=out_fmt)
    if a.device.type != "cuda":
        raise ValueError(f"fma_emu_matmul runs on cpu or cuda, got {a.device}")
    out = fused.launch(a[None], b, fmt, style, out_fmt, scaled=False)
    fma_emu_matmul.launches += 1
    return out[0]


fma_emu_matmul.launches = 0
