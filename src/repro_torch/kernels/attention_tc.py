"""Full-sequence attention on the H100's tensor cores (``csrc/attention_tc.cu``).

``flash_attention_tc`` computes what ``models.attention.flash_blocks``
computes on 16-bit operands (its plain version, which the card tests hold
it against): q·kᵀ of the bf16 (or fp16) operands summed in f32, times
``scale``, the causal, ``kv_len`` and window masks, an f32 online softmax
with ``flash_blocks``' ``m_safe`` rule, p rounded to v's type before p·v,
which is summed in f32, and the output rounded to q's type.  The sums run
on ``mma.sync`` in the tensor cores' order, so it agrees with the plain
version within a stated bound, not bitwise (the card tests state it).
Keys the mask excludes contribute exactly 0, and kv tiles it excludes
wholly are skipped (the source's note says where the plain version
differs).

It replaces no TPU kernel: the JAX package's attention is plain ``jnp``,
which XLA fuses, while eager torch materialises every score block.
``kernel_takes`` is the predicate ``models.attention.flash_attention``
routes by.  The kernel has no backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: the operand types the kernel reads
TC_DTYPES = (torch.bfloat16, torch.float16)
#: the widest head (D and Dv) it takes; both must be multiples of 16
MAX_WIDTH = 256


def kernel_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """True where ``flash_attention`` runs the kernel: CUDA operands of one
    16-bit float type, head widths D and Dv multiples of 16 up to
    ``MAX_WIDTH``, and no gradient needed (grad mode off, or no input
    requiring grad)."""
    return (q.device.type == "cuda" and q.dtype in TC_DTYPES
            and k.dtype == q.dtype and v.dtype == q.dtype
            and all(w % 16 == 0 and 0 < w <= MAX_WIDTH
                    for w in (q.shape[-1], v.shape[-1]))
            and not (torch.is_grad_enabled()
                     and (q.requires_grad or k.requires_grad
                          or v.requires_grad)))


def _check(q, k, v, kv_len: int, window: int, q_offset: int) -> None:
    """Raise on anything the kernel does not take (the device last, so that
    every other refusal shows on CPU tensors too)."""
    if not q.dim() == k.dim() == v.dim() == 4:
        raise ValueError(f"flash_attention_tc takes 4-d q, k and v, got "
                         f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in TC_DTYPES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention_tc takes q, k and v of one type "
                        f"among bfloat16 and float16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    B, Sq, Hq, D = q.shape
    if k.shape[0] != B or v.shape[0] != B or k.shape[3] != D \
            or tuple(v.shape[1:3]) != tuple(k.shape[1:3]):
        raise ValueError(f"flash_attention_tc: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match as (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, "
                         f"Hkv, Dv)")
    Hkv = k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention_tc: {Hq} q heads over {Hkv} kv "
                         f"heads")
    for name, w in (("D", D), ("Dv", v.shape[3])):
        if w % 16 or not 0 < w <= MAX_WIDTH:
            raise ValueError(f"flash_attention_tc takes {name} a multiple "
                             f"of 16 up to {MAX_WIDTH}, got {w}")
    if B > 65535 or Sq > 65535 * 64:
        raise ValueError(f"flash_attention_tc: a grid of {B} rows and "
                         f"{Sq} positions (64 a tile) exceeds 65535")
    if not 0 <= kv_len <= k.shape[1] or window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention_tc: kv_len {kv_len} (Sk "
                         f"{k.shape[1]}), window {window}, q_offset "
                         f"{q_offset}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_tc: {name}'s last dimension "
                             f"must be contiguous (strides {t.stride()})")
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention_tc: {name}'s rows must start "
                             f"on 16 bytes (strides {t.stride()})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_tc runs on one CUDA device; "
                             f"{name} is on {t.device}")


def agreement_bound(got: torch.Tensor, want: torch.Tensor,
                    a_mean: torch.Tensor, n_keys: int) -> torch.Tensor:
    """The elementwise bound on |kernel - plain version| of one call:
    ``got`` the kernel's output, ``want`` ``flash_blocks``' on the same
    operands, ``a_mean`` each row's softmax-weighted mean of |v| (the plain
    version in f32 on |v|), ``n_keys`` Sk.

    Both sides sum the same exact products in f32 in different orders and
    round p to the operands' type before p·v, but against different running
    maxima (the kernel rescales every 64 keys, the plain version every
    ``block_k``), so their rounded p differ.  Each side's rounding moves its
    output by at most u·A (u the type's unit roundoff: 2^-8 bf16, 2^-11
    fp16; A = ``a_mean``); the two final roundings add one ulp of the type
    at the larger output; the f32 sums stay within 2^-16·A.  fp16 adds
    2^-25·max A per key for p below its normal range."""
    u, man = (2.0 ** -8, 7) if got.dtype == torch.bfloat16 \
        else (2.0 ** -11, 10)
    top = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp(min=2.0 ** -126)))
                     - man)
    tol = (2 * u + 2.0 ** -16) * a_mean + ulp
    if got.dtype == torch.float16:
        tol = tol + n_keys * 2.0 ** -25 * a_mean.amax(dim=-1, keepdim=True)
    return tol


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, built and loaded at first use."""
    fn = _build.load("attention_tc").repro_attention_tc
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p] + [i] * 8 + [ll] * 9 + [ctypes.c_float] \
        + [i] * 4 + [p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       scale: float, causal: bool = True, window: int = 0,
                       q_offset: int = 0, kv_len=None) -> torch.Tensor:
    """q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv) -> (B, Sq,
    Hq, Dv) in q's type; q head h reads kv head h // (Hq // Hkv).
    ``scale`` multiplies the scores (rounded to f32); ``q_offset`` is
    q[0]'s position, ``kv_len`` (default Sk) masks keys at or past it,
    ``window`` > 0 keeps the keys within ``window`` of the query.  Operands
    are read through their strides (last dimension contiguous, rows on 16
    bytes).  One launch, counted in ``flash_attention_tc.launches``."""
    _build.refuse_dtensor("flash_attention_tc", q, k, v)
    Sk = k.shape[1] if k.dim() == 4 else 0
    kv_len = Sk if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len, int(window), int(q_offset))
    _build.refuse_grad("flash_attention_tc", q, k, v)
    B, Sq, Hq, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    rc = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, Sq, Sk, Hq, Hkv, D, Dv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
        int(causal), int(window), int(q_offset), kv_len,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "tensor-core attention kernel")
    flash_attention_tc.launches += 1
    return out


flash_attention_tc.launches = 0
