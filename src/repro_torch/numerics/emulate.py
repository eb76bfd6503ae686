"""The emulation surface: matmul / dot / quantize under FPMax semantics
(counterpart of ``repro.numerics.emulate``).

Every consumer that wants "this computation, under the numerics of that FPU"
routes through here; ``repro_torch.kernels.ops`` and
``repro_torch.models.numerics`` are thin adapters.

Accumulation styles (see kernels/fma_emu.py): ``'fused'`` (extended
accumulator, one final round), ``'cascade'`` (round-after-add each k block)
and ``'cascade_fwd'`` (rounded partial products, unrounded accumulator).

``impl`` selects the path: ``'fused'`` is the K1 kernel (CUDA tensors) or
its plain tile replay (CPU tensors), ``'pallas'`` the K3 kernel (the name of
the JAX route it stands for) or its plain version, ``'ref'`` the plain
k-block reference the JAX package runs on the CPU, and ``'auto'`` picks
``'fused'`` on CUDA and ``'ref'`` on the CPU.  The JAX package's
interpret-mode names run the same kernels: ``'interpret'`` is ``'pallas'``
and ``'fused_interpret'`` is ``'fused'``.  ``emulated_ssm_scan`` and
``emulated_flash_attention`` map the JAX package's scan and attention routes
the same way onto K5 and K4.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.core.formats import FloatFormat
from repro_torch.numerics.registry import get_format

STYLES = ("fused", "cascade", "cascade_fwd")
#: the JAX package's interpret-mode routes -> the port's kernel routes
_INTERPRET_ROUTES = {"interpret": "pallas", "fused_interpret": "fused"}


def accum_style_for(style: str, forwarding: bool = True) -> str:
    """Map an FPU FMAC style ('fma' | 'cma') to the emulation accumulation
    style."""
    if style == "fma":
        return "fused"
    if style != "cma":
        raise ValueError(f"unknown FMAC style {style!r}")
    return "cascade_fwd" if forwarding else "cascade"


def _on_cuda(device: torch.device) -> bool:
    return device.type == "cuda"


def emulated_matmul(a, b, *, fmt: FloatFormat | str, style: str = "fused",
                    out_fmt: FloatFormat | None = None, impl: str = "auto", scaled: bool = False,
                    device=None) -> torch.Tensor:
    """(..., M, K) @ (K, N) with FPMax-emulated numerics, f32 out.

    Runs on ``device`` (default CUDA; raises if it is absent).  Every path
    rounds at 128-deep k blocks, the edges the CUDA kernels round at.
    ``scaled=True`` enables exact per-tile pow2 scaling with fused dequant
    ('fused' and 'ref' only)."""
    fmt = get_format(fmt)
    if style not in STYLES:
        raise ValueError(f"style must be one of {STYLES}, got {style!r}")
    dev = resolve_device(device)
    a = torch.as_tensor(a, device=dev)
    b = torch.as_tensor(b, device=dev)
    if impl == "auto":
        impl = "fused" if _on_cuda(dev) else "ref"
    impl = _INTERPRET_ROUTES.get(impl, impl)
    from repro_torch.kernels import fma_emu as _fma_emu
    from repro_torch.kernels import fused as _fused
    from repro_torch.kernels import ref as _ref

    batch_shape = a.shape[:-2]
    m, kdim = a.shape[-2:]
    if impl == "fused":
        a3 = a.reshape((-1, m, kdim)) if batch_shape else a
        out = _fused.fused_qmm(a3, b, fmt=fmt, style=style, out_fmt=out_fmt,
                               scaled=scaled)
        return out.reshape(batch_shape + out.shape[-2:])
    if impl not in ("pallas", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if scaled and impl != "ref":
        raise ValueError(f"scaled=True requires impl 'fused' / 'ref', got "
                         f"{impl!r}")
    if scaled:
        # one scale tile per slice, as the JAX path vmaps fused_qmm_ref
        a3 = a.reshape((-1, m, kdim))
        out = _fused.fused_qmm_ref(a3, b, fmt=fmt, style=style,
                                   out_fmt=out_fmt, scaled=True)
        return out.reshape(batch_shape + (m, b.shape[1]))
    # unscaled rows are independent: the slices fold into one 2-D product
    a2 = a.reshape((-1, kdim))
    fn = _fma_emu.fma_emu_matmul if impl == "pallas" \
        else _ref.fma_emu_matmul_ref
    out = fn(a2, b, fmt=fmt, style=style, out_fmt=out_fmt)
    return out.reshape(batch_shape + (m, b.shape[1]))


def emulated_dot(a_vec, b_vec, *, fmt: FloatFormat | str,
                 style: str = "fused", device=None) -> torch.Tensor:
    """Dot product under the exact per-scalar unit semantics.

    Unlike ``emulated_matmul`` (which models the k-block mapping), this is
    what the physical FMA/CMA unit computes one operation at a time, the
    granularity the ``AccuracyModel`` oracle certifies.  Shapes:
    ``(..., K) . (..., K) -> (...,)``, f32, in float64 torch on the
    operands' device (tensors) or on ``device`` (default CUDA; raises if it
    is absent)."""
    from repro_torch.core import softfloat as _sf
    fmt = get_format(fmt)
    if style == "fused":
        return _sf.dot_fused(a_vec, b_vec, fmt, device=device)
    if style == "cascade":
        return _sf.dot_cascade(a_vec, b_vec, fmt, forwarding=False,
                               device=device)
    if style == "cascade_fwd":
        return _sf.dot_cascade(a_vec, b_vec, fmt, forwarding=True,
                               device=device)
    raise ValueError(f"style must be one of {STYLES}, got {style!r}")


def matmul_for_policy(a, b, policy, **kw) -> torch.Tensor:
    """``emulated_matmul`` under a chip ``NumericsPolicy`` (its format and
    kernel accumulation style)."""
    return emulated_matmul(a, b, fmt=policy.fmt, style=policy.kernel_style,
                           **kw)


def policy_matmul(x: torch.Tensor, w: torch.Tensor, policy=None):
    """x: (..., K) @ w: (K, N) under an optional numerics policy.

    Inert policies (or ``policy=None``) run the native matmul in the
    operands' dtype; emulating policies route through ``emulated_matmul``
    on x's device.  The kernel widens bf16 operands on load, so weights are
    passed as they are (no f32 copy per call); the result is cast back to
    x's dtype.

    DTensor operands (under a mesh) take the emulating path the JAX
    package's Pallas calls take under GSPMD, which cannot partition a
    custom call: the operands are redistributed to ``Replicate``, every
    rank runs the kernel (K1 on the card, its plain version on the CPU) on
    its full local operands, and the result is a replicated DTensor."""
    if policy is None or not getattr(policy, "emulate", False):
        return torch.matmul(x, w)
    from repro_torch.parallel import sharding as sh
    if sh.is_dtensor(x) or sh.is_dtensor(w):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = (x if sh.is_dtensor(x) else w).device_mesh
        rep = [Replicate()] * mesh.ndim
        out = policy_matmul(sh.redistribute(x, mesh, rep).to_local(),
                            sh.redistribute(w, mesh, rep).to_local(), policy)
        return DTensor.from_local(out, mesh, rep, run_check=False)
    lead = x.shape[:-1]
    x2 = x.reshape((-1, x.shape[-1]))
    out = emulated_matmul(x2, w, fmt=get_format(policy.fmt),
                          style=policy.accum_style, device=x.device)
    return out.reshape(lead + (w.shape[-1],)).to(x.dtype)


def emulated_ssm_scan(a, b, c, *, fmt: FloatFormat | str | None,
                      impl: str = "auto", device=None, **kw):
    """Selective scan (the Mamba recurrence) with format-rounded operands.

    a, b: (B, S, D, N); c: (B, S, N) -> (y, h_last), f32, on ``device``
    (default CUDA; raises if it is absent).  The operands pass through
    ``fmt``'s rounding as they are read (``None``: no rounding); the state
    stays in f32.  impl: ``'fused'`` the K5 kernel (its plain version,
    behind the same shape checks, for CPU tensors); ``'interpret'`` the
    same, since the kernel has no interpret mode; ``'ref'`` the plain
    version, with ``chunk`` and ``bd`` dropped;
    ``'auto'`` is ``'fused'`` on CUDA and ``'ref'`` on the CPU.  ``kw``:
    ``out_fmt``, ``chunk``, ``bd``."""
    fmt = get_format(fmt) if fmt is not None else None
    dev = resolve_device(device)
    a, b, c = (torch.as_tensor(t, device=dev) for t in (a, b, c))
    if impl == "auto":
        impl = "fused" if _on_cuda(dev) else "ref"
    from repro_torch.kernels import fused as _fused
    if impl in ("fused", "interpret"):
        return _fused.ssm_scan_quantized(a, b, c, fmt=fmt, **kw)
    if impl == "ref":
        kw.pop("chunk", None), kw.pop("bd", None)
        return _fused.ssm_scan_quantized_ref(a, b, c, fmt=fmt, **kw)
    raise ValueError(f"unknown impl {impl!r}")


def emulated_flash_attention(q, k, v, *, fmt: FloatFormat | str | None,
                             impl: str = "auto", scaled: bool = True,
                             device=None, **kw) -> torch.Tensor:
    """Blockwise flash attention under FPMax-emulated numerics.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype,
    on ``device`` (default CUDA; raises if it is absent).  Per-block
    rounding of q/k/v (and the probability operand) with per-block dequant
    of each partial dot; ``fmt=None`` runs the same schedule unrounded.
    impl: ``'fused'`` the K4 kernel (its plain version, behind the same
    argument checks, for CPU tensors); ``'interpret'`` the same, since the
    kernel has no interpret mode; ``'ref'`` the plain version in the
    kernel's op order; ``'scan'`` the fast twin with matrix-product dots;
    ``'auto'`` is ``'fused'`` on CUDA and ``'scan'`` on the CPU.  ``kw``:
    ``causal``, ``window``, ``kv_len``, ``q_offset``, ``out_fmt``,
    ``block_q``, ``block_k``."""
    fmt = get_format(fmt) if fmt is not None else None
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(t, device=dev) for t in (q, k, v))
    if impl == "auto":
        impl = "fused" if _on_cuda(dev) else "scan"
    from repro_torch.kernels import fused as _fused
    if impl in ("fused", "interpret"):
        return _fused.fused_flash_attention(q, k, v, fmt=fmt, scaled=scaled,
                                            **kw)
    if impl == "ref":
        return _fused.fused_flash_ref(q, k, v, fmt=fmt, scaled=scaled, **kw)
    if impl == "scan":
        return _fused.fused_flash_scan(q, k, v, fmt=fmt, scaled=scaled, **kw)
    raise ValueError(f"unknown impl {impl!r}")


def quantize_tensor(x, *, fmt: FloatFormat | str, impl: str = "auto",
                    device=None) -> torch.Tensor:
    """Round a tensor onto fmt's grid: the K2 kernel on CUDA ('pallas',
    the default there), the plain version ('ref') on the CPU."""
    fmt = get_format(fmt)
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    if impl == "auto":
        impl = "pallas" if _on_cuda(dev) else "ref"
    from repro_torch.kernels import quantize_kernel as _qk
    from repro_torch.kernels import ref as _ref
    if impl == "pallas":
        return _qk.quantize_nd(x, fmt=fmt)
    if impl == "ref":
        return _ref.quantize_ref(x, fmt=fmt)
    raise ValueError(f"unknown impl {impl!r}")
