"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1), with
no query low-rank and YaRN RoPE.  The JAX package has no counterpart.

Per position, with H heads, a latent of r values and R rope dims:

  q = x W_q                       (H, nope + R): q_nope, q_pe
  [c, k_pe] = x W_kv_a            r + R values
  c = RMSNorm(c)                  (its own scale, eps 1e-6)
  [k_nope, v] = c W_kv_b          (H, nope + v)
  k = [k_nope, rope(k_pe)]        k_pe one head, shared by all H
  o = softmax(q k^T s) v,  then W_o

with q_pe and k_pe rotated pairwise at YaRN's frequencies and s =
(nope + R)^-1/2 times YaRN's attention factor squared.  What a position
leaves in the cache is its **latent**: [c, rope(k_pe)], r + R values.

Two paths compute the same attention:

* **expanded** (``prefill``, full sequences): the latent goes up through
  W_kv_b to per-head k and v, and the blockwise attention runs with q and k
  of width nope + R and v of width v_head_dim; one layer's k and v live at
  a time.
* **absorbed** (``decode``, one position against the cache): q_nope is
  folded through W_kv_b's key half into the latent (q_lat = W_kb q_nope), the
  scores are [q_lat, q_pe] . latent over r + R values, one "kv head" shared
  by the H query heads, the output is taken over the latent's first r
  values and goes out through W_kv_b's value half.  It reads only the
  latent cache.  The two absorbed products take no numerics policy.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.layers import (apply_rope_pairs, dense_init,
                                       rmsnorm, rmsnorm_init,
                                       yarn_frequencies, yarn_mscale)
from repro_torch.models.numerics import matmul
from repro_torch.telemetry.tracer import scope


def latent_width(cfg) -> int:
    """The values one position keeps in the cache: r + R."""
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim


def softmax_scale(cfg) -> float:
    """(nope + R)^-1/2, times YaRN's attention factor squared when the
    config scales its RoPE with ``mscale_all_dim``."""
    s = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        s *= yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return s


@functools.lru_cache(maxsize=None)
def rope_tables(cfg, device):
    """(inv_freq over the R rope dims, the factor on cos and sin)."""
    R = cfg.qk_rope_head_dim
    if not cfg.yarn_factor:
        return 1.0 / (cfg.rope_theta ** (torch.arange(
            0, R, 2, dtype=torch.float32, device=device) / R)), 1.0
    inv = yarn_frequencies(R, cfg.rope_theta, cfg.yarn_factor,
                           cfg.yarn_original_max_len, cfg.yarn_beta_fast,
                           cfg.yarn_beta_slow, device)
    return inv, yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale) \
        / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)


def mla_init(gen: torch.Generator, cfg, dtype, *, lead=()):
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, R, v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": dense_init(gen, d, H * (nope + R), dtype, lead=lead),
        "wkv_a": dense_init(gen, d, r + R, dtype, lead=lead),
        "kv_norm": rmsnorm_init(r, dtype, gen.device, lead=lead),
        "wkv_b": dense_init(gen, r, H * (nope + v), dtype, lead=lead),
        "wo": dense_init(gen, H * v, d, dtype, lead=lead),
    }


def project(p, h, positions, cfg, policy=None):
    """h (B, S, d) -> q_nope (B, S, H, nope), q_pe (B, S, H, R) rotated,
    and the latent (B, S, r + R): c normed, k_pe rotated."""
    B, S, _ = h.shape
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nope, R = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = matmul(h, p["wq"], policy).reshape(B, S, H, nope + R)
    ckv = matmul(h, p["wkv_a"], policy)
    inv, msc = rope_tables(cfg, h.device)
    q_pe = apply_rope_pairs(q[..., nope:], positions, inv, msc)
    k_pe = apply_rope_pairs(ckv[..., r:].reshape(B, S, 1, R), positions,
                            inv, msc)
    latent = torch.cat([rmsnorm(p["kv_norm"], ckv[..., :r]),
                        k_pe.reshape(B, S, R)], dim=-1)
    return q[..., :nope], q_pe, latent


def prefill(p, h, positions, cfg, *, policy=None,
            triangle_skip: bool = False):
    """Causal attention of the whole sequence h (B, S, d), expanded.
    Returns (out (B, S, H, v) before W_o, latent (B, S, r + R))."""
    B, S, _ = h.shape
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nope, R = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_pe, latent = project(p, h, positions, cfg, policy)
    kv = matmul(latent[..., :r], p["wkv_b"], policy).reshape(B, S, H, -1)
    k = torch.cat([kv[..., :nope], latent[..., None, r:].expand(
        B, S, H, R)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    out = flash_attention(q, k, kv[..., nope:], causal=True,
                          scale=softmax_scale(cfg),
                          triangle_skip=triangle_skip)
    return out, latent


def decode(p, h, cache, cache_len, cfg, *, keep, policy=None):
    """One position h (B, 1, d) per lane against the latent cache (B, Smax,
    r + R), absorbed.  The lane's latent is written in place at its
    ``cache_len`` where ``keep`` (B,) holds (the position lies in the
    cache and the lane writes); it then attends ``cache_len + 1`` entries.
    Returns (B, 1, H, v) before W_o.  The attention runs in the phase
    scope ``mla.decode`` (``lanes``; ``cache_len``, the longest valid
    length, a device tensor)."""
    B, Smax = cache.shape[:2]
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nope = cfg.qk_nope_head_dim
    q_nope, q_pe, latent = project(p, h, cache_len[:, None], cfg, policy)
    lanes = torch.arange(B, device=h.device)
    idx = cache_len.clamp(max=Smax - 1)
    cache[lanes, idx] = torch.where(keep[:, None],
                                    latent[:, 0].to(cache.dtype),
                                    cache[lanes, idx])
    valid = torch.clamp(cache_len + 1, max=Smax)
    with scope("mla.decode", device=h.device) as sc:
        if sc.on:
            sc.set(lanes=B, cache_len=valid.max())
        w = p["wkv_b"].reshape(r, H, -1)
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w[..., :nope])
        q = torch.cat([q_lat, q_pe[:, 0]], dim=-1)[:, None]
        o_lat = decode_attention(q, cache[:, :, None], cache[:, :, None, :r],
                                 valid, scale=softmax_scale(cfg))
        return torch.einsum("bhr,rhv->bhv", o_lat[:, 0],
                            w[..., nope:])[:, None]
