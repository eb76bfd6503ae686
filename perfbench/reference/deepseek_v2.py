"""The plain float32 reference of the DeepSeek-V2 family (DeepSeek-V2-Lite,
arXiv:2405.04434).

Plain PyTorch in float32 with TF32 off, with no cache, no batching and no
kernel: multi-head latent attention without a query low-rank, in the
non-absorbed form (the latent goes up through W_kv_b to per-head keys and
values); YaRN RoPE on the 64 rope dims, pairing dims (2i, 2i+1) at
frequency f_i (the published code de-interleaves the dims and rotates
halves: the same map); the softmax scale (q width)^-1/2 times YaRN's
attention factor squared; ``first_k_dense_replace`` leading layers with a
swiglu MLP, then MoE layers: a float32 softmax over the router's logits,
the top ``num_experts_per_tok`` with ties to the lower expert, weights not
renormalised (``norm_topk_prob`` false) times ``routed_scaling_factor``,
each expert computed over the tokens routed to it (gathered), and the
shared experts added; RMSNorm; the unembed by the embedding table.  It
reads the configuration file's published keys and the weights the
benchmark made, laid out as the program's parameter tree, and imports
nothing of the program.  Attention runs in blocks of query rows so that
one 4120-token request fits on the card.

Departures from the published model, each also in the configuration's
``departures``:

- the unembed is tied to the embedding table, as the program ties it (the
  published model has a separate ``lm_head``);
- the weights are random, from the seed (the file's ``assumed``).

With ``fp8`` it is the lower-precision control: every matmul operand, the
router's too, rounded to float8_e4m3fn with a scale per row of the
activations and per output column of the weights (``reference.dense``'s
rounding).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from perfbench.reference.dense import _mm, _rms, full_f32


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_frequencies(cfg: dict, device) -> torch.Tensor:
    """YaRN's inverse frequencies of the rope dims' pairs: f_i =
    theta^(-2i/R) below the ramp's low end, f_i / factor from its high end
    on, blended linearly between; the ends are floor and ceil of
    R ln(L0 / (2 pi beta)) / (2 ln theta) at beta_fast and beta_slow."""
    R, theta = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg["rope_scaling"]
    f = 1.0 / theta ** (torch.arange(0, R, 2, dtype=torch.float32,
                                     device=device) / R)
    if not rs:
        return f

    def end(beta):
        return R * math.log(rs["original_max_position_embeddings"]
                            / (beta * 2 * math.pi)) / (2 * math.log(theta))

    lo = max(math.floor(end(rs["beta_fast"])), 0)
    hi = min(math.ceil(end(rs["beta_slow"])), R - 1)
    ramp = ((torch.arange(R // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    return f * (1 - ramp) + f / rs["factor"] * ramp


def softmax_scale(cfg: dict) -> float:
    s = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg["rope_scaling"]
    if rs and rs.get("mscale_all_dim"):
        s *= yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return s


def _rope(x, pos, cfg):
    """x (S, H, R): dims (2i, 2i+1) rotated by pos * f_i, cos and sin
    times mscale / mscale_all_dim."""
    rs = cfg["rope_scaling"]
    m = yarn_mscale(rs["factor"], rs["mscale"]) \
        / yarn_mscale(rs["factor"], rs["mscale_all_dim"]) if rs else 1.0
    ang = pos.to(torch.float32)[:, None] * rope_frequencies(cfg, x.device)
    cos, sin = (ang.cos() * m)[:, None], (ang.sin() * m)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       -1).flatten(-2)


def _attention(q, k, v, scale: float, block: int = 1024):
    """Causal softmax attention in float32, query rows in blocks: q and k
    (S, H, Dqk), v (S, H, Dv) -> (S, H * Dv)."""
    S, H = q.shape[:2]
    qt, kt, vt = q.transpose(0, 1), k.permute(1, 2, 0), v.transpose(0, 1)
    out = torch.empty((H, S, v.shape[-1]), device=q.device)
    kpos = torch.arange(S, device=q.device)
    for i in range(0, S, block):
        s = (qt[:, i:i + block] @ kt) * scale
        qpos = torch.arange(i, min(i + block, S), device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
        out[:, i:i + block] = torch.softmax(s, dim=-1) @ vt
    return out.transpose(0, 1).reshape(S, -1)


def _mla(h, a: Dict, cfg: dict, eps: float, fp8: bool):
    """Multi-head latent attention of one sequence's normed h (S, d),
    expanded, through W_o."""
    S = h.shape[0]
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, R = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    pos = torch.arange(S, device=h.device)
    q = _mm(h, a["wq"], fp8).reshape(S, H, nope + R)
    ckv = _mm(h, a["wkv_a"], fp8)
    c = _rms(ckv[:, :r], a["kv_norm"]["scale"], eps)
    k_pe = _rope(ckv[:, None, r:], pos, cfg)  # one head, shared
    kv = _mm(c, a["wkv_b"], fp8).reshape(S, H, -1)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], pos, cfg)], -1)
    k = torch.cat([kv[..., :nope], k_pe.expand(S, H, R)], -1)
    o = _attention(q, k, kv[..., nope:], softmax_scale(cfg))
    return _mm(o, a["wo"], fp8)


def _swiglu(x, gate, up, down, fp8: bool):
    return _mm(F.silu(_mm(x, gate, fp8)) * _mm(x, up, fp8), down, fp8)


def _moe(x, m: Dict, cfg: dict, fp8: bool):
    """The MoE FFN of x (S, d): routed experts over the tokens routed to
    each, weighted, plus the shared experts."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(_mm(x, m["router"], fp8), dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    if cfg["norm_topk_prob"]:
        top_w = top_w / top_w.sum(-1, keepdim=True)
    top_w = top_w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel():
            y = _swiglu(x[tok], m["w_gate"][e], m["w_up"][e],
                        m["w_down"][e], fp8)
            out.index_add_(0, tok, y * top_w[tok, slot, None])
    sh = m["shared"]
    return out + _swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"], fp8)


def _layers(w: Dict, cfg: dict):
    """(stacked tree, index, is dense) of every layer in order."""
    nd = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        yield (w["dense_layers"], i, True) if i < nd \
            else (w["layers"], i - nd, False)


def _pick(tree, i):
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def hidden(cfg: dict, w: Dict, tokens: torch.Tensor,
           fp8: bool = False) -> torch.Tensor:
    """The final normed hidden states (B, S, d) in float32, one sequence
    and one layer at a time."""
    eps = float(cfg["rms_norm_eps"])
    outs = []
    with full_f32():
        for seq in tokens:
            x = w["embed"][seq].to(torch.float32)
            for tree, i, dense in _layers(w, cfg):
                lw = _pick(tree, i)
                x = x + _mla(_rms(x, lw["ln1"]["scale"], eps), lw, cfg, eps,
                             fp8)
                h = _rms(x, lw["ln2"]["scale"], eps)
                if dense:
                    mlp = lw["mlp"]
                    x = x + _swiglu(h, mlp["w_gate"], mlp["w_up"],
                                    mlp["w_down"], fp8)
                else:
                    x = x + _moe(h, lw["moe"], cfg, fp8)
            outs.append(_rms(x, w["final_norm"]["scale"], eps))
    return torch.stack(outs)


def reference_logits(cfg: dict, w: Dict, tokens: torch.Tensor,
                     rows: Optional[torch.Tensor] = None,
                     fp8: bool = False) -> torch.Tensor:
    """Logits (B, S, V) of ``tokens``, or with ``rows`` (an index into S)
    only at those positions (B, len(rows), V)."""
    h = hidden(cfg, w, tokens, fp8)
    if rows is not None:
        h = h[:, rows]
    with full_f32():
        return _mm(h, w["embed"].T, fp8)
