"""Attention in plain PyTorch: blockwise (flash-style) prefill, chunked
prefill and decode (counterpart of ``repro.models.attention``).

The JAX package computes attention in plain ``jnp`` (the Pallas flash
kernel is not on the model's path), so the port does too: an online
softmax over (q-block, kv-block) pairs with the probabilities multiplied by
the mask, so fully-masked rows yield 0 rather than NaN.  GQA is grouped,
without repeating KV heads: q is viewed as (B, S, Hkv, G, D).  Scores and
probability-value products are taken in f32 from the operands' values, as
the JAX code's ``preferred_element_type=float32`` does.  On the card, a
no-grad ``flash_attention`` of 16-bit operands runs the tensor-core kernel
``kernels.attention_tc`` instead, which computes the same function with its
own sum order and rescale edges; ``flash_blocks`` stays its plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention_tc import flash_attention_tc, kernel_takes
from repro_torch.telemetry.tracer import scope

NEG_INF = -1.0e30


def _f32(t):
    return t.to(torch.float32)


def _blocks(q, k, v, block_q: int, block_k: int):
    """q, k, v padded to whole blocks: qb (B, nq, bq, Hkv, G, D), kb (B, nk,
    bk, Hkv, D) and vb (B, nk, bk, Hkv, Dv), and (bq, bk); v's width Dv may
    differ from q's and k's D."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    pq, pk = (-Sq) % bq, (-Sk) % bk
    qb = F.pad(q, (0, 0, 0, 0, 0, pq)).reshape(B, -1, bq, Hkv, Hq // Hkv, D)
    kb = F.pad(k, (0, 0, 0, 0, 0, pk)).reshape(B, -1, bk, Hkv, D)
    vb = F.pad(v, (0, 0, 0, 0, 0, pk)).reshape(B, -1, bk, Hkv, v.shape[-1])
    return qb, kb, vb, bq, bk


def block_mask(q_pos, k_pos, *, causal: bool, window: int, kv_len: int):
    """(bq, bk) bool: the keys each query of the block may attend."""
    mask = k_pos[None, :] < kv_len
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def kv_extent(qi: int, bq: int, bk: int, nk: int, q_offset: int) -> int:
    """The kv blocks q block ``qi`` reaches under the causal mask: those
    starting at or before its last query (``triangle_skip``)."""
    hi = int(q_offset) + (qi + 1) * bq
    return min(nk, max(1, -(-hi // bk)))


def flash_blocks(qb, kb, vb, *, scale: float, causal: bool, window: int,
                 kv_len: int, q_offset: int, triangle_skip: bool = False,
                 with_lse: bool = False):
    """The online-softmax forward over blocked operands (``_blocks``).
    Returns the f32 output blocks (B, nq, Hkv, G, bq, Dv) and, with
    ``with_lse``, each row's log-sum-exp (B, nq, Hkv, G, bq): ``NEG_INF``
    where a row attends nothing (the JAX ``flash_vjp._fwd_scan``)."""
    B, nq, bq, Hkv, G, D = qb.shape
    nk, bk = kb.shape[1], kb.shape[2]
    dev = qb.device
    outs, lses = [], []
    for qi in range(nq):
        q_blk = _f32(qb[:, qi])
        q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, Hkv, G, bq), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, bq), device=dev)
        acc = torch.zeros((B, Hkv, G, bq, vb.shape[-1]), device=dev)
        n_kv = kv_extent(qi, bq, bk, nk, q_offset) \
            if triangle_skip and causal and nq > 1 else nk
        for kj in range(n_kv):
            k_blk, v_blk = kb[:, kj], vb[:, kj]
            k_pos = kj * bk + torch.arange(bk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, _f32(k_blk)) * scale
            mask = block_mask(q_pos, k_pos, causal=causal, window=window,
                              kv_len=kv_len)
            s_for_max = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s_for_max.amax(dim=-1))
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None]) * mask
            corr = torch.exp(torch.clamp(m - m_safe, max=0.0)) \
                * (m > NEG_INF / 2)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", _f32(p.to(v_blk.dtype)),
                              _f32(v_blk))
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
        if with_lse:
            m_row = torch.where(m <= NEG_INF / 2, 0.0, m)
            lses.append(torch.where(
                l > 0, m_row + torch.log(torch.clamp(l, min=1e-30)),
                NEG_INF))
    out = torch.stack(outs, dim=1)
    return (out, torch.stack(lses, dim=1)) if with_lse else out


def unblock(out_blocks, Sq: int, dtype):
    """(B, nq, Hkv, G, bq, D) output blocks -> (B, Sq, Hq, D) in ``dtype``."""
    B, nq, Hkv, G, bq, D = out_blocks.shape
    out = out_blocks.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * bq, Hkv * G, D)
    return out[:, :Sq].to(dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_len=None, block_q: int = 1024,
                    block_k: int = 1024, triangle_skip: bool = False,
                    scale: Optional[float] = None):
    """q: (B,Sq,Hq,D); k: (B,Sk,Hkv,D); v: (B,Sk,Hkv,Dv) -> (B,Sq,Hq,Dv).

    q_offset: absolute position of q[0]; kv_len: valid KV length (<= Sk);
    scale: the scores' factor (default D^-1/2).
    triangle_skip (causal): q block i visits only the kv blocks that start
    at or before its last query, a static per-block extent (the JAX
    ``attention.flash_attention``'s): the blocks it skips are fully
    masked.

    Where ``attention_tc.kernel_takes`` holds (CUDA, bf16 or fp16 operands,
    D and Dv multiples of 16 up to 256, no gradient needed) the
    tensor-core kernel computes the same function with its own kv-tile
    rescale edges and sum order, skips every wholly masked kv tile and
    gives masked keys exactly 0; ``block_q``, ``block_k`` and
    ``triangle_skip`` are then the plain version's edges, unused.
    Everything else runs ``flash_blocks``.  Either runs in the phase scope
    ``attn`` (``path`` "kernel" or "blocks", ``positions`` B * Sq,
    ``heads``, ``d``, ``dv``)."""
    B, Sq, Hq, D = q.shape
    kv_len = k.shape[1] if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    kernel = kernel_takes(q, k, v)
    with scope("attn", device=q.device) as sc:
        if sc.on:
            sc.set(path="kernel" if kernel else "blocks", positions=B * Sq,
                   heads=Hq, d=D, dv=v.shape[-1])
        if kernel:
            return flash_attention_tc(q, k, v, scale=scale, causal=causal,
                                      window=window, q_offset=q_offset,
                                      kv_len=kv_len)
        return attention_blocks(q, k, v, scale=scale, causal=causal,
                                window=window, q_offset=q_offset,
                                kv_len=kv_len, block_q=block_q,
                                block_k=block_k, triangle_skip=triangle_skip)


def attention_blocks(q, k, v, *, scale: float, causal: bool, window: int,
                     q_offset: int, kv_len, block_q: int = 1024,
                     block_k: int = 1024, triangle_skip: bool = False):
    """``flash_blocks`` on (B, S, H, D) operands -> (B, Sq, Hq, Dv) in q's
    dtype: ``flash_attention``'s blockwise path, and the plain version the
    card tests hold ``attention_tc.flash_attention_tc`` against."""
    qb, kb, vb, _, _ = _blocks(q, k, v, block_q, block_k)
    out = flash_blocks(qb, kb, vb, scale=scale, causal=causal, window=window,
                       kv_len=kv_len, q_offset=q_offset,
                       triangle_skip=triangle_skip)
    return unblock(out, q.shape[1], q.dtype)


def chunk_attention(q, k, v, q_pos, k_pos, k_valid, *, window: int = 0):
    """Chunked-prefill attention: one online-softmax block with per-lane
    position/validity masks.

    q: (B,Sq,Hq,D) chunk queries; k,v: (B,Sk,Hkv,D) history + fresh chunk
    keys; q_pos: (B,Sq) / k_pos: (B,Sk) absolute positions; k_valid: (B,Sk)
    marks real keys."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = _f32(q.reshape(B, Sq, Hkv, G, D))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, _f32(k)) * scale
    mask = k_valid[:, None, :] & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        mask = mask & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    mask = mask[:, None, None]  # (B,1,1,Sq,Sk)
    s_for_max = torch.where(mask, s, NEG_INF)
    m = s_for_max.amax(dim=-1)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe[..., None]) * mask
    l = p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", _f32(p.to(v.dtype)), _f32(v))
    out = pv / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     scale: Optional[float] = None):
    """Single-step attention against a cache.

    q: (B,1,Hq,D); caches: (B,Smax,Hkv,D) and (B,Smax,Hkv,Dv) -> (B,1,Hq,Dv);
    cache_len: (B,) valid length (the new token's K/V already written at
    cache_len-1); scale: the scores' factor (default D^-1/2)."""
    B, Smax, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qg = _f32(q.reshape(B, Hkv, G, D))
    kc = _f32(k_cache.to(q.dtype))  # fp8 caches cast up first
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kc) * scale
    k_pos = torch.arange(Smax, device=q.device)
    cl = cache_len.reshape(-1, 1)
    valid = k_pos[None, :] < cl
    if window:
        valid = valid & (k_pos[None, :] >= cl - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vc = _f32(v_cache.to(q.dtype))
    out = torch.einsum("bhgk,bkhd->bhgd", _f32(p.to(q.dtype)), vc)
    return out.reshape(B, 1, Hq, v_cache.shape[-1]).to(q.dtype)
