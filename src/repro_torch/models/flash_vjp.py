"""Training-path flash attention with a recompute-in-backward gradient
(counterpart of ``repro.models.flash_vjp``).

Autograd through the blockwise forward would keep every block's
probability matrix, O(S^2) f32 per layer.  ``flash_attention_trainable`` is
a ``torch.autograd.Function`` instead: its forward is
``attention.flash_attention``'s online softmax, which also returns each
row's log-sum-exp, and it saves only q, k, v, the f32 output blocks and the
log-sum-exps, O(S * D).  The backward recomputes the scores and
probabilities of each (q block, kv block) pair from those row statistics
and accumulates dq, dk and dv blockwise, op for op the JAX
``_flash_bwd_scoped``: dk and dv are summed over the G query heads of each
kv head, and the gradients are cast back to the inputs' dtypes.  It is
plain PyTorch, as the JAX function is plain ``jnp``.

Called with grad off or on inputs that need none (serving), it runs the
plain forward, so the served numbers do not depend on this module.

The forward and the backward each run inside a
``record_function("flash_attention_kernel")`` scope, the JAX package's
named scope, which ``roofline.fused_model`` reads (a backward that
autograd runs does not inherit the forward's scope, so it opens its own).
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from repro_torch.models.attention import (NEG_INF, _blocks, block_mask,
                                          flash_attention, flash_blocks,
                                          unblock)


#: the JAX package's named scope around the flash forward and backward
SCOPE = "flash_attention_kernel"


def _flash_backward(qb, kb, vb, outs, lses, do, *, scale, causal, window,
                    kv_len, q_offset):
    """dq (B, nq, bq, Hkv, G, D), dk and dv (B, nk, bk, Hkv, D), f32, from
    the blocked operands, output blocks, row log-sum-exps and ``do`` in the
    output blocks' layout (B, nq, Hkv, G, bq, D), f32."""
    B, nq, bq, Hkv, G, D = qb.shape
    nk, bk = kb.shape[1], kb.shape[2]
    dev = qb.device
    f32 = torch.float32
    delta = torch.sum(do * outs, dim=-1)  # (B, nq, Hkv, G, bq)
    dk = torch.zeros((B, nk, bk, Hkv, D), dtype=f32, device=dev)
    dv = torch.zeros((B, nk, bk, Hkv, D), dtype=f32, device=dev)
    dqs = []
    for qi in range(nq):
        q_blk = qb[:, qi].to(f32)
        do_blk, delta_blk = do[:, qi], delta[:, qi]
        q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
        # fully masked rows stored lse = NEG_INF: guard the exp
        lse = lses[:, qi]
        lse_safe = torch.where(lse <= NEG_INF / 2, 0.0, lse)
        dq_blk = torch.zeros((B, bq, Hkv, G, D), dtype=f32, device=dev)
        for kj in range(nk):
            k_blk, v_blk = kb[:, kj].to(f32), vb[:, kj].to(f32)
            k_pos = kj * bk + torch.arange(bk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
            mask = block_mask(q_pos, k_pos, causal=causal, window=window,
                              kv_len=kv_len)
            p = torch.exp(s - lse_safe[..., None]) * mask
            dv_j = torch.einsum("bhgqk,bhgqd->bkhgd", p, do_blk)
            dp = torch.einsum("bhgqd,bkhd->bhgqk", do_blk, v_blk)
            ds = p * (dp - delta_blk[..., None]) * scale
            dq_blk = dq_blk + torch.einsum("bhgqk,bkhd->bqhgd", ds, k_blk)
            dk_j = torch.einsum("bhgqk,bqhgd->bkhgd", ds, q_blk)
            dk[:, kj] += dk_j.sum(dim=3)  # summed over G
            dv[:, kj] += dv_j.sum(dim=3)
        dqs.append(dq_blk)
    return torch.stack(dqs, dim=1), dk, dv


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len, q_offset, block_q,
                block_k):
        Sq, D = q.shape[1], q.shape[3]
        qb, kb, vb, _, _ = _blocks(q, k, v, block_q, block_k)
        kw = dict(scale=1.0 / math.sqrt(D), causal=causal, window=window,
                  kv_len=kv_len, q_offset=q_offset)
        with record_function(SCOPE):
            outs, lses = flash_blocks(qb, kb, vb, with_lse=True, **kw)
        ctx.save_for_backward(qb, kb, vb, outs, lses)
        ctx.kw = kw
        ctx.shapes = (q.shape, k.shape, q.dtype, k.dtype, v.dtype)
        return unblock(outs, Sq, q.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        qb, kb, vb, outs, lses = ctx.saved_tensors
        (B, Sq, Hq, D), (_, Sk, Hkv, _), qt, kt, vt = ctx.shapes
        nq, bq = qb.shape[1], qb.shape[2]
        G = Hq // Hkv
        # the cotangent in the output blocks' layout (B, nq, Hkv, G, bq, D)
        do = torch.nn.functional.pad(grad_out.to(torch.float32),
                                     (0, 0, 0, 0, 0, nq * bq - Sq))
        do = do.reshape(B, nq, bq, Hkv, G, D).permute(0, 1, 3, 4, 2, 5)
        with record_function(SCOPE):
            dq, dk, dv = _flash_backward(qb, kb, vb, outs, lses, do,
                                         **ctx.kw)
        dq = dq.reshape(B, nq * bq, Hq, D)[:, :Sq].to(qt)
        dk = dk.reshape(B, -1, Hkv, D)[:, :Sk].to(kt)
        dv = dv.reshape(B, -1, Hkv, D)[:, :Sk].to(vt)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_trainable(q, k, v, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              kv_len=None, block_q: int = 1024,
                              block_k: int = 1024):
    """``attention.flash_attention`` with the recompute backward: q (B, Sq,
    Hq, D), k and v (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype."""
    kv_len = k.shape[1] if kv_len is None else kv_len
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        with record_function(SCOPE):
            return flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len,
                                   block_q=block_q, block_k=block_k)
    return _Flash.apply(q, k, v, causal, window, kv_len, q_offset, block_q,
                        block_k)
