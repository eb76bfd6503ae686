"""Training-path flash attention (counterpart of ``repro.models.flash_vjp``),
forward only.

The JAX function wraps the same forward as ``attention.flash_attention`` in
a recompute-in-backward custom VJP; its forward is identical by
construction.  The port's serving slice needs the forward alone, so this is
that forward; the backward (a ``torch.autograd.Function``) arrives with the
training slice.
"""
from __future__ import annotations

from repro_torch.models.attention import flash_attention


def flash_attention_trainable(q, k, v, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              kv_len=None, block_q: int = 1024,
                              block_k: int = 1024):
    """Forward of the JAX ``flash_attention_trainable``."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, kv_len=kv_len,
                           block_q=block_q, block_k=block_k)
