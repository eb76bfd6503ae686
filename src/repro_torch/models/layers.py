"""Shared model layers: norms, RoPE, MLPs, embeddings (counterpart of
``repro.models.layers``).

Params are nested dicts of tensors.  Matmuls route through
``repro_torch.models.numerics.matmul`` so the numerics policy applies
uniformly.  Where the JAX code asks for an f32 result of lower-precision
operands (``preferred_element_type``), the port widens the operands first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.numerics import matmul


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None, *, lead=()):
    scale = (d_in ** -0.5) if scale is None else scale
    w = torch.randn(tuple(lead) + (d_in, d_out), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)  # in place: one f32 copy at a time


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def rmsnorm_init(d: int, dtype, device, *, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dt)


def rope_frequencies(head_dim: int, theta: float, rotate_dims: int, device):
    """inv_freq for the rotated prefix of the head dim."""
    half = rotate_dims // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float = 10000.0, style: str = "full"):
    """x: (..., S, H, D). style 'half' rotates only the first D/2 dims
    (ChatGLM's 2d RoPE); 'full' rotates all D dims pairwise."""
    if style == "none":
        return x
    d = x.shape[-1]
    rot = d if style == "full" else d // 2
    inv_freq = rope_frequencies(d, theta, rot, x.device)
    ang = positions[..., None].to(torch.float32) * inv_freq
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.to(torch.float32).chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    out = torch.cat([y1, y2], dim=-1).to(x.dtype)
    if rot < d:
        out = torch.cat([out, x_pass], dim=-1)
    return out


def mlp_init(gen: torch.Generator, d: int, d_ff: int, act: str, dtype, *,
             lead=()):
    if act == "swiglu":
        return {"w_gate": dense_init(gen, d, d_ff, dtype, lead=lead),
                "w_up": dense_init(gen, d, d_ff, dtype, lead=lead),
                "w_down": dense_init(gen, d_ff, d, dtype, lead=lead)}
    return {"w_up": dense_init(gen, d, d_ff, dtype, lead=lead),
            "w_down": dense_init(gen, d_ff, d, dtype, lead=lead)}


def mlp_apply(params, x, act: str, policy=None):
    if act == "swiglu":
        gate = matmul(x, params["w_gate"], policy)
        up = matmul(x, params["w_up"], policy)
        h = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    else:
        up = matmul(x, params["w_up"], policy)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up.to(torch.float32), approximate="tanh").to(x.dtype)
    return matmul(h, params["w_down"], policy)


def embed_apply(table, tokens):
    return table[tokens]


def unembed_apply(table, x, policy=None):
    """Logits in f32.  Under an emulating policy the product goes through
    the policy matmul with ``table.T`` read in place."""
    if policy is not None and getattr(policy, "emulate", False):
        return matmul(x, table.T, policy).to(torch.float32)
    return torch.matmul(x.to(torch.float32), table.to(torch.float32).T)
