"""Selective state-space blocks: Mamba-1 (falcon-mamba) and Mamba-2 (zamba2)
(counterpart of ``repro.models.ssm``).

Prefill runs a chunked linear scan: a Python loop over chunks carrying the
state, with a log-depth inclusive scan inside each chunk, so only one
chunk's (B, chunk, d_inner, d_state) expansion is live.  Decode is a single
O(1) state update.  Parameters are the JAX package's tree (nested dicts of
tensors, layer axis leading where ``lead`` is given).

Recurrence: h_t = a_t * h_{t-1} + b_t; associative combine
(aL, bL) o (aR, bR) = (aL * aR, bL * aR + bR).

The JAX package scans each chunk with ``lax.associative_scan``; the port's
``_inclusive_scan`` (Hillis-Steele: log2(chunk) doubling steps) combines in
another order, so the two agree within float32 reassociation, not bitwise.
Its result at a position depends only on the positions before it, so
padding a chunk's tail leaves the valid positions' bits unchanged: a
chunked prefill whose boundaries land on multiples of the scan chunk
reproduces the monolithic one.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init


def _combine(left, right):
    aL, bL = left
    aR, bR = right
    return aL * aR, bL * aR + bR


def _inclusive_scan(a, b):
    """Inclusive scan of ``_combine`` along dim 1 in log2(len) steps.
    ``a`` may broadcast against ``b`` in the dims after the second."""
    n = b.shape[1]
    off = 1
    while off < n:
        a_new, b_new = _combine((a[:, :-off], b[:, :-off]),
                                (a[:, off:], b[:, off:]))
        a = torch.cat([a[:, :off], a_new], dim=1)
        b = torch.cat([b[:, :off], b_new], dim=1)
        off *= 2
    return a, b


def _pad_time(t, pad: int, value: float = 0.0):
    """Pad dim 1 of ``t`` by ``pad`` entries of ``value`` at the end."""
    shape = (t.shape[0], pad) + tuple(t.shape[2:])
    return torch.cat([t, torch.full(shape, value, dtype=t.dtype,
                                    device=t.device)], dim=1)


def chunked_linear_scan(a, b, h0, chunk: int = 64):
    """a, b: (B, S, ...state dims); h0: (B, ...state).  Returns
    (h_seq, h_last)."""
    S = a.shape[1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        a = _pad_time(a, pad, 1.0)
        b = _pad_time(b, pad)
    h, outs = h0, []
    for s0 in range(0, S + pad, chunk):
        pa, pb = _inclusive_scan(a[:, s0:s0 + chunk], b[:, s0:s0 + chunk])
        h_seq = pb + pa * h[:, None]
        h = h_seq[:, -1]
        outs.append(h_seq)
    return torch.cat(outs, dim=1)[:, :S], h


# ---------------------------------------------------------------------------
# Depthwise causal conv (the short conv in both mamba versions)
# ---------------------------------------------------------------------------
def causal_conv1d(x, w, b, carry=None):
    """x: (B, S, C); w: (K, C) depthwise; carry: (B, K-1, C) past inputs.
    Returns (out, new_carry)."""
    K = w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xc = torch.cat([carry, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xc[:, i:i + x.shape[1]] * w[i]
    new_carry = xc[:, -(K - 1):] if K > 1 else carry
    return out + b, new_carry


def _silu_in(x):
    """silu in f32, back in x's dtype (jax.nn.silu on an f32 cast)."""
    return F.silu(x.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba-7b)
# ---------------------------------------------------------------------------
def mamba1_init(gen: torch.Generator, d_model: int, *, d_state: int,
                expand: int, conv: int, dtype, lead=()) -> Dict:
    """Parameters drawn from ``gen`` on its device; ``lead`` stacks layers.
    ``dt_bias``, ``A_log`` and ``D`` are float32 whatever ``dtype`` is."""
    d_in = expand * d_model
    dt_rank = max(d_model // 16, 1)
    dev, lead = gen.device, tuple(lead)
    conv_w = torch.randn(lead + (conv, d_in), generator=gen, device=dev)
    A = torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, d_model, 2 * d_in, dtype, lead=lead),
        "conv_w": (conv_w * (1.0 / conv)).to(dtype),
        "conv_b": torch.zeros(lead + (d_in,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, d_in, dt_rank + 2 * d_state, dtype,
                             lead=lead),
        "dt_proj": dense_init(gen, dt_rank, d_in, dtype, scale=dt_rank**-0.5,
                              lead=lead),
        "dt_bias": torch.full(lead + (d_in,), -4.6, dtype=torch.float32,
                              device=dev),  # softplus ~ 0.01
        "A_log": torch.log(A).expand(lead + (d_in, d_state)).contiguous(),
        "D": torch.ones(lead + (d_in,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d_in, d_model, dtype, lead=lead),
    }


def _mamba1_core(p, xc, d_state: int):
    """xc: (B, S, d_in) post-conv.  Returns the per-step (a, bx, C): a and
    bx (B, S, d_in, N), C (B, S, N), all f32."""
    dt_rank = p["dt_proj"].shape[0]
    proj = xc @ p["x_proj"]
    dt_low, Bm, Cm = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus((dt_low @ p["dt_proj"]).to(torch.float32)
                    + p["dt_bias"])  # (B, S, d_in)
    A = -torch.exp(p["A_log"])  # (d_in, n)
    a = torch.exp(dt[..., None] * A)
    bx = (dt * xc.to(torch.float32))[..., None] \
        * Bm.to(torch.float32)[..., None, :]
    return a, bx, Cm.to(torch.float32)


def _chunked_ssm(inputs, h0, expand_fn, chunk: int):
    """Chunked selective scan that never holds the full (B, S, *state)
    expansion: ``expand_fn`` maps one chunk of the raw per-token inputs (a
    tensor or a tuple of tensors, (B, S, ...)) to (a, bx, readout_fn).
    Returns (y (B, S, ...), h_last)."""
    leaves = inputs if isinstance(inputs, tuple) else (inputs,)
    B, S = leaves[0].shape[:2]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    mask = torch.ones((B, S), dtype=torch.float32, device=leaves[0].device)
    if pad:
        leaves = tuple(_pad_time(t, pad) for t in leaves)
        mask = _pad_time(mask, pad)
    h, ys = h0, []
    for s0 in range(0, S + pad, chunk):
        part = tuple(t[:, s0:s0 + chunk] for t in leaves)
        a_k, bx_k, readout = expand_fn(part if isinstance(inputs, tuple)
                                       else part[0])
        # padded positions are identity transitions (a = 1, b = 0)
        m = mask[:, s0:s0 + chunk]
        me = m.reshape(m.shape + (1,) * (a_k.dim() - 2))
        a_k = a_k * me + (1.0 - me)
        bx_k = bx_k * m.reshape(m.shape + (1,) * (bx_k.dim() - 2))
        pa, pb = _inclusive_scan(a_k, bx_k)
        h_seq = pb + pa * h[:, None]
        ys.append(readout(h_seq))
        h = h_seq[:, -1]
    return torch.cat(ys, dim=1)[:, :S], h


def mamba1_apply(p, x, *, d_state: int, chunk: int = 64,
                 state: Tuple | None = None, return_state: bool = False):
    """x: (B, S, d).  state: (conv_carry, h) for stepwise decode; with
    ``return_state`` returns (out, (conv_carry, h_last))."""
    B, S, _ = x.shape
    d_in = p["out_proj"].shape[0]
    xz = x @ p["in_proj"]
    x_in, z = torch.split(xz, [d_in, d_in], dim=-1)
    conv_carry = None if state is None else state[0]
    xc, new_conv = causal_conv1d(x_in, p["conv_w"], p["conv_b"], conv_carry)
    xc = _silu_in(xc)
    h0 = (torch.zeros((B, d_in, d_state), dtype=torch.float32,
                      device=x.device) if state is None else state[1])
    if S == 1:  # decode fast path: one state update
        a, bx, Cm = _mamba1_core(p, xc, d_state)
        h_last = a[:, 0] * h0 + bx[:, 0]
        y = torch.einsum("bdn,bn->bd", h_last, Cm[:, 0])[:, None]
    else:
        def expand(xc_k):
            a, bx, Cm = _mamba1_core(p, xc_k, d_state)
            return a, bx, (lambda h_seq:
                           torch.einsum("bsdn,bsn->bsd", h_seq, Cm))

        y, h_last = _chunked_ssm(xc, h0, expand, chunk)
    y = y + p["D"] * xc.to(torch.float32)
    y = y.to(x.dtype) * _silu_in(z)
    out = y @ p["out_proj"]
    if return_state:
        return out, (new_conv, h_last)
    return out


# ---------------------------------------------------------------------------
# Mamba-2 (zamba2-1.2b)
# ---------------------------------------------------------------------------
def mamba2_init(gen: torch.Generator, d_model: int, *, d_state: int,
                expand: int, conv: int, head_dim: int, dtype,
                lead=()) -> Dict:
    """Parameters drawn from ``gen``; ``A_log``, ``dt_bias`` and ``D`` are
    float32 whatever ``dtype`` is."""
    d_in = expand * d_model
    n_heads = d_in // head_dim
    d_conv_in = d_in + 2 * d_state  # x, B, C go through the conv
    dev, lead = gen.device, tuple(lead)
    conv_w = torch.randn(lead + (conv, d_conv_in), generator=gen, device=dev)
    return {
        "in_proj": dense_init(gen, d_model, 2 * d_in + 2 * d_state + n_heads,
                              dtype, lead=lead),
        "conv_w": (conv_w * (1.0 / conv)).to(dtype),
        "conv_b": torch.zeros(lead + (d_conv_in,), dtype=dtype, device=dev),
        "A_log": torch.zeros(lead + (n_heads,), dtype=torch.float32,
                             device=dev),
        "dt_bias": torch.full(lead + (n_heads,), -4.6, dtype=torch.float32,
                              device=dev),
        "D": torch.ones(lead + (n_heads,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_in, dtype, dev, lead=lead),
        "out_proj": dense_init(gen, d_in, d_model, dtype, lead=lead),
    }


def mamba2_apply(p, x, *, d_state: int, head_dim: int, chunk: int = 64,
                 state: Tuple | None = None, return_state: bool = False):
    """x: (B, S, d); heads of ``head_dim`` with one scalar decay each."""
    B, S, _ = x.shape
    d_in = p["out_proj"].shape[0]
    H = d_in // head_dim
    proj = x @ p["in_proj"]
    z, xbc, dt_raw = torch.split(proj, [d_in, d_in + 2 * d_state, H], dim=-1)
    conv_carry = None if state is None else state[0]
    xc_all, new_conv = causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                     conv_carry)
    xc_all = _silu_in(xc_all)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])  # (H,)

    def parts(xc_k, dt_k):
        xh = xc_k[..., :d_in].reshape(xc_k.shape[0], -1, H, head_dim)
        Bm = xc_k[..., d_in:d_in + d_state].to(torch.float32)
        Cm = xc_k[..., d_in + d_state:].to(torch.float32)
        a = torch.exp(dt_k * A)[..., None, None]  # (B, s, H, 1, 1)
        bx = (dt_k[..., None] * xh.to(torch.float32))[..., None] \
            * Bm[..., None, None, :]  # (B, s, H, P, N)
        return xh, a, bx, Cm

    h0 = (torch.zeros((B, H, head_dim, d_state), dtype=torch.float32,
                      device=x.device) if state is None else state[1])
    if S == 1:
        xh, a, bx, Cm = parts(xc_all, dt)
        h_last = a[:, 0] * h0 + bx[:, 0]
        y = torch.einsum("bhpn,bn->bhp", h_last, Cm[:, 0])[:, None]
    else:
        def expand(inputs):
            xc_k, dt_k = inputs
            _, a, bx, Cm = parts(xc_k, dt_k)
            return a, bx, (lambda h_seq:
                           torch.einsum("bshpn,bsn->bshp", h_seq, Cm))

        y, h_last = _chunked_ssm((xc_all, dt), h0, expand, chunk)
        xh = xc_all[..., :d_in].reshape(B, S, H, head_dim)
    y = y + p["D"][:, None] * xh.to(torch.float32)
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rmsnorm(p["norm"], y * _silu_in(z))
    out = y @ p["out_proj"]
    if return_state:
        return out, (new_conv, h_last)
    return out


def mamba_state_shapes(cfg, batch: int):
    """((shape, dtype) of the conv carry, (shape, dtype) of h): one layer's
    decode state."""
    d_in = cfg.ssm_expand * cfg.d_model
    conv_c = d_in if cfg.ssm_version == 1 else d_in + 2 * cfg.ssm_state
    conv = ((batch, cfg.ssm_conv - 1, conv_c), getattr(torch, cfg.dtype))
    if cfg.ssm_version == 1:
        h = ((batch, d_in, cfg.ssm_state), torch.float32)
    else:
        H = d_in // cfg.ssm_head_dim
        h = ((batch, H, cfg.ssm_head_dim, cfg.ssm_state), torch.float32)
    return conv, h
