"""The plain float32 reference of the dense decoder family.

Plain PyTorch in float32 with TF32 off: GQA causal attention, full or half
RoPE, gelu (tanh) or swiglu MLP, qkv bias, RMSNorm, the unembed by the
embedding table.  It follows the block the configuration file states under
``block`` (the port's block; the file lists where that departs from the
published model), reads the weights the benchmark made, and imports
nothing of the program.  With ``fp8`` it is the lower-precision control:
every matmul operand rounded to float8_e4m3fn with a scale per row of the
activations and per output column of the weights.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_f32():
    """float32 matmuls in float32: TF32 off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8_e4m3fn with a power-free scale per slice along
    ``dim`` (amax / 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    w = w.to(torch.float32)
    if fp8:
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.to(torch.float32)


def _rope(x, pos, theta: float, style: str):
    """x (B, S, H, D): the first D (full) or D/2 (half) dims rotated, the
    i-th dim of the first half of them paired with the i-th of the
    second."""
    D = x.shape[-1]
    rot = D if style == "full" else D // 2
    half = rot // 2
    inv = 1.0 / theta ** (torch.arange(half, device=x.device,
                                       dtype=torch.float32) / half)
    ang = pos.to(torch.float32)[:, None] * inv[None, :]  # (S, half)
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


def _attention(q, k, v, block: int = 1024):
    """Causal GQA softmax attention in float32, query rows in blocks:
    q (B, S, Hq, D), k and v (B, S, Hkv, D) -> (B, S, Hq * D)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)  # B Hkv G S D
    kt = k.permute(0, 2, 3, 1)[:, :, None]  # B Hkv 1 D S
    vt = v.permute(0, 2, 1, 3)[:, :, None]  # B Hkv 1 S D
    out = torch.empty_like(qg)
    kpos = torch.arange(S, device=q.device)
    for i in range(0, S, block):
        s = (qg[:, :, :, i:i + block] @ kt) / math.sqrt(D)
        qpos = torch.arange(i, min(i + block, S), device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
        out[:, :, :, i:i + block] = torch.softmax(s, dim=-1) @ vt
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq * D)


def hidden(cfg: dict, w: Dict, tokens: torch.Tensor,
           fp8: bool = False) -> torch.Tensor:
    """The final normed hidden states (B, S, d) in float32, layer by
    layer (each layer's weights widened to float32 in turn)."""
    blk = cfg["block"]
    eps, hd = float(blk["norm_eps"]), cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    lw = w["layers"]
    with full_f32():
        x = w["embed"][tokens].to(torch.float32)
        for i in range(cfg["num_hidden_layers"]):
            h = _rms(x, lw["ln1"]["scale"][i], eps)
            q, k, v = (_mm(h, lw[n][i], fp8) for n in ("wq", "wk", "wv"))
            if blk["qkv_bias"]:
                q = q + lw["bq"][i].to(torch.float32)
                k = k + lw["bk"][i].to(torch.float32)
                v = v + lw["bv"][i].to(torch.float32)
            q = _rope(q.reshape(B, S, hq, hd), pos, blk["rope_theta"],
                      blk["rope"])
            k = _rope(k.reshape(B, S, hkv, hd), pos, blk["rope_theta"],
                      blk["rope"])
            a = _attention(q, k, v.reshape(B, S, hkv, hd))
            x = x + _mm(a, lw["wo"][i], fp8)
            h = _rms(x, lw["ln2"]["scale"][i], eps)
            mlp = lw["mlp"]
            if blk["mlp"] == "swiglu":
                u = F.silu(_mm(h, mlp["w_gate"][i], fp8)) \
                    * _mm(h, mlp["w_up"][i], fp8)
            else:
                u = F.gelu(_mm(h, mlp["w_up"][i], fp8), approximate="tanh")
            x = x + _mm(u, mlp["w_down"][i], fp8)
        return _rms(x, w["final_norm"]["scale"], eps)


def logits(cfg: dict, w: Dict, h: torch.Tensor,
           fp8: bool = False) -> torch.Tensor:
    """float32 logits of hidden states ``h`` (..., d): by the embedding
    table (the port's tied unembed)."""
    with full_f32():
        return _mm(h, w["embed"].T, fp8)


def reference_logits(cfg: dict, w: Dict, tokens: torch.Tensor,
                     rows: Optional[torch.Tensor] = None,
                     fp8: bool = False) -> torch.Tensor:
    """Logits (B, S, V) of ``tokens``, or with ``rows`` (an index into S)
    only at those positions (B, len(rows), V)."""
    h = hidden(cfg, w, tokens, fp8)
    if rows is not None:
        h = h[:, rows]
    return logits(cfg, w, h, fp8)
