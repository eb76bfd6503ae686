"""Attention in plain PyTorch: blockwise (flash-style) prefill, chunked
prefill and decode (counterpart of ``repro.models.attention``).

The JAX package computes attention in plain ``jnp`` (the Pallas flash
kernel is not on the model's path), so the port does too: an online
softmax over (q-block, kv-block) pairs with the probabilities multiplied by
the mask, so fully-masked rows yield 0 rather than NaN.  GQA is grouped,
without repeating KV heads: q is viewed as (B, S, Hkv, G, D).  Scores and
probability-value products are taken in f32 from the operands' values, as
the JAX code's ``preferred_element_type=float32`` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


def _f32(t):
    return t.to(torch.float32)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_len=None, block_q: int = 1024,
                    block_k: int = 1024):
    """q: (B,Sq,Hq,D); k,v: (B,Sk,Hkv,D) -> (B,Sq,Hq,D).

    q_offset: absolute position of q[0]; kv_len: valid KV length (<= Sk).
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    kv_len = Sk if kv_len is None else kv_len
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    pq, pk = (-Sq) % bq, (-Sk) % bk
    qb = F.pad(q, (0, 0, 0, 0, 0, pq)).reshape(B, -1, bq, Hkv, G, D)
    kb = F.pad(k, (0, 0, 0, 0, 0, pk)).reshape(B, -1, bk, Hkv, D)
    vb = F.pad(v, (0, 0, 0, 0, 0, pk)).reshape(B, -1, bk, Hkv, D)
    nq, nk = qb.shape[1], kb.shape[1]
    dev = q.device
    outs = []
    for qi in range(nq):
        q_blk = _f32(qb[:, qi])
        q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, Hkv, G, bq), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, bq), device=dev)
        acc = torch.zeros((B, Hkv, G, bq, D), device=dev)
        for kj in range(nk):
            k_blk, v_blk = kb[:, kj], vb[:, kj]
            k_pos = kj * bk + torch.arange(bk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, _f32(k_blk)) * scale
            mask = k_pos[None, :] < kv_len
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
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
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, bq, Hkv, G, D)
    out = torch.stack(outs, dim=1).reshape(B, nq * bq, Hq, D)[:, :Sq]
    return out.to(q.dtype)


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


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """Single-step attention against a cache.

    q: (B,1,Hq,D); caches: (B,Smax,Hkv,D); cache_len: (B,) valid length
    (the new token's K/V already written at cache_len-1)."""
    B, Smax, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
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
    return out.reshape(B, 1, Hq, D).to(q.dtype)
