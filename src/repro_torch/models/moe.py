"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``):
deterministic top-k routing with sort-based capacity dispatch.

Both MoE configs: deepseek-moe-16b (2 shared always-on experts + 64 routed,
top-6) and mixtral-8x7b (8 routed, top-2, no shared).  The expert products
are plain ``torch`` batched matmuls, as the JAX package computes them
outside any Pallas kernel; no policy reaches them.

Where the JAX code leaves an order to XLA, the port fixes it, so the layer
is bitwise deterministic on the card and agrees with XLA:CPU:

  * **top-k ties** go to the lower expert index (``jax.lax.top_k``): a
    stable descending sort, where ``torch.topk`` promises no order;
  * the dispatch sort is stable (``jnp.argsort``);
  * **dispatch**: every (token, choice) entry adds into its slot; a dropped
    entry adds a zero (its activation times 0) into its expert's clipped
    slot ``cap - 1``.  Each slot holds at most one non-zero term, so the sum
    does not depend on the order the terms arrive in;
  * **combine**: each token's k weighted expert outputs are added into a
    zero row in the activations' dtype, one rounded add at a time, in
    dispatch-sort order (ascending expert id), which is the order XLA:CPU's
    scatter-add takes; no atomics.

Which entries drop depends on every token of the call (the capacity is a
share of ``T * k``), so padding and the inactive lanes of a batched decode
step change the result of real tokens, in both packages.

A config that asks for it (``moe_dropless``, DeepSeek-V2-Lite) routes
**dropless** instead, a path the JAX package does not have: every (token,
pick) is computed whatever an expert's load, so which picks a token gets
and that all of them count do not depend on the other tokens of the call
or on padding.  The tokens go in chunks of ``DROPLESS_CHUNK_TOKENS``, each
expert's rows padded to the chunk's largest load, and a token's k
weighted outputs are summed in float32.

Every call runs in the phase scope ``moe`` (``tokens``, padding included;
``picks``; ``experts``; ``max_load``, the most picks on one expert, a
device tensor that ``Scope.resolve`` reads).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.telemetry.tracer import scope

#: a dropless call of at most this many tokens pads every expert's rows to
#: all of them, with no read of the loads on the host: below ~295 rows (the
#: H100's bf16 FLOP/s over its HBM bytes/s) an expert's padded product
#: costs no more than reading its weights, which a call that reaches most
#: experts does anyway
PAD_ALL_TOKENS = 256
#: a dropless call routes its tokens in chunks of at most this many: the
#: padded buffers then stay under ~4 GB at DeepSeek-V2-Lite's widths (64
#: experts, top-6, 2048 x 1408) whatever the call's size, where a 32 x 4096
#: prefill routed whole takes ~20 GB
DROPLESS_CHUNK_TOKENS = 16384


def _randn_scaled(gen: torch.Generator, shape, scale: float, dtype, lead):
    """N(0, scale^2) draws of ``lead + shape`` in ``dtype``, one leading
    slice at a time so only one slice's float32 copy is live."""
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype,
                      device=gen.device)
    for view in (out.reshape((-1,) + tuple(shape)) if lead else out[None]):
        w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                        dtype=torch.float32)
        view.copy_(w.mul_(scale))
    return out


def moe_init(gen: torch.Generator, d: int, *, n_experts: int, moe_d_ff: int,
             n_shared: int, dtype, lead=()) -> Dict:
    """Parameters drawn from ``gen``; the router is float32 whatever
    ``dtype`` is."""
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, d, n_experts, torch.float32, scale=0.02,
                             lead=lead),
        "w_gate": _randn_scaled(gen, (n_experts, d, moe_d_ff), d ** -0.5,
                                dtype, lead),
        "w_up": _randn_scaled(gen, (n_experts, d, moe_d_ff), d ** -0.5,
                              dtype, lead),
        "w_down": _randn_scaled(gen, (n_experts, moe_d_ff, d),
                                moe_d_ff ** -0.5, dtype, lead),
    }
    if n_shared:
        dff_sh = n_shared * moe_d_ff
        p["shared"] = {
            "w_gate": dense_init(gen, d, dff_sh, dtype, lead=lead),
            "w_up": dense_init(gen, d, dff_sh, dtype, lead=lead),
            "w_down": dense_init(gen, dff_sh, d, dtype, lead=lead),
        }
    return p


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: the JAX formula, ``int()`` truncation, a floor of
    4, rounded up to a multiple of 128 from 128 on, at most ``T * k``."""
    cap = int(capacity_factor * n_tokens * top_k / n_experts)
    cap = max(cap, 4)
    if cap >= 128:
        cap = ((cap + 127) // 128) * 128
    return min(cap, n_tokens * top_k)


class Routing(NamedTuple):
    """One call's routing.  ``top_i``/``top_w``: (T, k) picks and their
    renormalised weights; ``order``: the stable sort of the flat picks by
    expert; ``keep``/``slot``/``tok``: per sorted entry, whether it fits
    its expert's capacity, its dispatch-buffer row and its token."""

    probs: torch.Tensor
    top_i: torch.Tensor
    top_w: torch.Tensor
    cap: int
    order: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    tok: torch.Tensor


def pick(router: torch.Tensor, xf: torch.Tensor, *, top_k: int,
         norm_topk: bool = True, scaling: float = 1.0):
    """(probs (T, E), top_i (T, k), top_w (T, k)) of ``xf`` (T, d): the
    float32 softmax over the router's logits, the k largest with ties to
    the lower index, their weights renormalised to sum to 1 when
    ``norm_topk``, then times ``scaling``."""
    probs = torch.softmax(xf.to(torch.float32) @ router, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :top_k], top_i[:, :top_k]
    if norm_topk:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    if scaling != 1.0:
        top_w = top_w * scaling
    return probs, top_i, top_w


def route(router: torch.Tensor, xf: torch.Tensor, *, top_k: int,
          capacity_factor: float, norm_topk: bool = True,
          scaling: float = 1.0) -> Routing:
    """Top-k routing (``pick``) and capacity dispatch plan of ``xf`` (T,
    d)."""
    T = xf.shape[0]
    E = router.shape[1]
    probs, top_i, top_w = pick(router, xf, top_k=top_k, norm_topk=norm_topk,
                               scaling=scaling)
    cap = capacity(T, top_k, E, capacity_factor)
    e_flat = top_i.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    starts = torch.searchsorted(
        e_sorted, torch.arange(E, device=xf.device, dtype=e_sorted.dtype))
    pos = torch.arange(T * top_k, device=xf.device) - starts[e_sorted]
    keep = pos < cap
    slot = e_sorted * cap + pos.clamp(0, cap - 1)
    return Routing(probs, top_i, top_w, cap, order, keep, slot,
                   order // top_k)


def _expert_ffn(p, xbuf):
    """xbuf: (E, C, d) -> (E, C, d), swiglu per expert (silu in float32,
    rounded back before the product with u).  Without autograd the
    product is taken in place, so at most two (E, C, f) buffers are live
    at once; under autograd an in-place product would save a copy of h for
    u's gradient, so it is taken out of place (the same numbers)."""
    h = F.silu(torch.bmm(xbuf, p["w_gate"]).to(torch.float32)) \
        .to(xbuf.dtype)
    u = torch.bmm(xbuf, p["w_up"])
    h = h * u if torch.is_grad_enabled() and u.requires_grad else h.mul_(u)
    return torch.bmm(h, p["w_down"])


def combine(y_slot: torch.Tensor, r: Routing, n_tokens: int) -> torch.Tensor:
    """Sum each token's ``k`` entries of ``y_slot`` (sorted order, (T*k, d))
    into a zero row, one add in the buffer's dtype at a time, in sorted
    order (ascending expert id for one token's distinct picks)."""
    k = r.top_i.shape[1]
    where = torch.empty_like(r.order)
    where[r.order] = torch.arange(r.order.numel(), device=r.order.device)
    where = where.reshape(n_tokens, k).sort(dim=-1).values
    y = torch.zeros((n_tokens, y_slot.shape[1]), dtype=y_slot.dtype,
                    device=y_slot.device)
    for i in range(k):
        y = y + y_slot[where[:, i]]
    return y


def _aux_loss(probs, top_i):
    """The load-balancing aux loss (Switch-style), from each token's first
    pick one-hot by a comparison, the same ops on every device (F.one_hot
    checks its indices on some devices only, so that the ops counted on
    meta stand-ins would not be the ones the card runs)."""
    E = probs.shape[1]
    top1 = top_i[:, 0, None] == torch.arange(E, device=top_i.device)
    frac_tokens = top1.to(torch.float32).mean(dim=0)
    return E * torch.sum(frac_tokens * probs.mean(dim=0))


def _shared_ffn(sp, xf):
    """The shared experts' swiglu on ``xf`` (T, d), in xf's dtype."""
    g = xf @ sp["w_gate"]
    u = xf @ sp["w_up"]
    h = F.silu(g.to(torch.float32)).to(xf.dtype) * u
    return h @ sp["w_down"]


def moe_apply(p, x, *, top_k: int, capacity_factor: float = 1.25,
              shard_fn=None, norm_topk: bool = True, scaling: float = 1.0,
              dropless: bool = False) -> Tuple[torch.Tensor, Dict]:
    """x: (B,S,d). Returns (out, {"aux_loss", "dropped_frac"}).
    ``shard_fn(t, kind)`` is applied to the (E, cap, d) expert buffer with
    ``kind="expert_buffer"`` (a layout hook; the identity by default).
    ``norm_topk`` and ``scaling``: ``pick``'s; ``dropless``: the dropless
    path (``capacity_factor`` and ``shard_fn`` unused)."""
    E = p["router"].shape[1]
    T = x.shape[0] * x.shape[1]
    with scope("moe", device=x.device) as sc:
        if dropless:
            out, aux, top_i = _dropless(p, x, top_k, norm_topk, scaling)
        else:
            out, aux, top_i = _capacity(p, x, top_k, capacity_factor,
                                        shard_fn, norm_topk, scaling)
        if sc.on:
            sc.set(tokens=T, picks=T * top_k, experts=E,
                   max_load=torch.bincount(top_i.reshape(-1),
                                           minlength=E).max())
    return out, aux


def _capacity(p, x, top_k, capacity_factor, shard_fn, norm_topk, scaling):
    """The capacity dispatch: (out, aux, top_i)."""
    B, S, d = x.shape
    shard_fn = shard_fn or (lambda t, kind: t)
    E = p["router"].shape[1]
    T = B * S
    xf = x.reshape(T, d)
    r = route(p["router"], xf, top_k=top_k, capacity_factor=capacity_factor,
              norm_topk=norm_topk, scaling=scaling)
    aux_loss = _aux_loss(r.probs, r.top_i)
    gathered = xf[r.tok] * r.keep[:, None].to(x.dtype)
    xbuf = torch.zeros((E * r.cap, d), dtype=x.dtype, device=x.device)
    xbuf.index_put_((r.slot,), gathered, accumulate=True)
    xbuf = shard_fn(xbuf.reshape(E, r.cap, d), "expert_buffer")
    ybuf = _expert_ffn(p, xbuf).reshape(E * r.cap, d)
    w_sorted = r.top_w.reshape(-1)[r.order]
    y_slot = ybuf[r.slot] * (r.keep.to(torch.float32)
                             * w_sorted)[:, None].to(x.dtype)
    out = combine(y_slot, r, T).reshape(B, S, d)
    if "shared" in p:
        out = out + _shared_ffn(p["shared"], xf).reshape(B, S, d)
    # times the float32 reciprocal: XLA evaluates the reference's division
    # so (a true division differs in the last bit for some T * k)
    dropped = torch.sum(1.0 - r.keep.to(torch.float32)) * (1.0 / (T * top_k))
    return out, {"aux_loss": aux_loss, "dropped_frac": dropped}, r.top_i


def _dropless(p, x, top_k, norm_topk, scaling):
    """The dropless dispatch: (out, aux, top_i), the tokens routed in
    chunks of at most ``DROPLESS_CHUNK_TOKENS`` (``_dropless_rows``)."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    probs, top_i, top_w = pick(p["router"], xf, top_k=top_k,
                               norm_topk=norm_topk, scaling=scaling)
    out = torch.empty_like(xf)
    for a in range(0, T, DROPLESS_CHUNK_TOKENS):
        b = a + DROPLESS_CHUNK_TOKENS
        out[a:b] = _dropless_rows(p, xf[a:b], top_i[a:b], top_w[a:b])
    aux = {"aux_loss": _aux_loss(probs, top_i),
           "dropped_frac": torch.zeros((), device=x.device)}
    return out.reshape(B, S, d), aux, top_i


def _dropless_rows(p, xf, top_i, top_w):
    """Tokens ``xf`` (T, d) through their picks: the (token, pick) entries
    sorted by expert fill each expert's rows of an (E, cap, d) buffer in
    token order, ``cap`` the largest load (one read of the loads on the
    host; all T tokens when T is at most ``PAD_ALL_TOKENS``, with no read),
    the rest zeros; each token's k outputs are weighted and summed in
    float32 in pick order, the shared experts' added, and the sum rounded
    once to xf's dtype."""
    T, d = xf.shape
    top_k = top_i.shape[1]
    E = p["router"].shape[1]
    e_flat = top_i.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    load = torch.bincount(e_flat, minlength=E)
    pos = torch.arange(T * top_k, device=xf.device) \
        - (torch.cumsum(load, 0) - load)[e_sorted]
    cap = T if T <= PAD_ALL_TOKENS else int(load.max())
    # each buffer row's token, T (a zero row) where the row is padding
    row_tok = torch.full((E * cap,), T, dtype=torch.int64, device=xf.device)
    row_tok[e_sorted * cap + pos] = order // top_k
    xbuf = torch.cat([xf, xf.new_zeros(1, d)])[row_tok]
    ybuf = _expert_ffn(p, xbuf.reshape(E, cap, d)).reshape(E * cap, d)
    # each (token, pick)'s buffer row
    row = torch.empty_like(order)
    row[order] = e_sorted * cap + pos
    row = row.reshape(T, top_k)
    acc = torch.zeros((T, d), dtype=torch.float32, device=xf.device)
    for i in range(top_k):
        acc += ybuf[row[:, i]].to(torch.float32) * top_w[:, i, None]
    if "shared" in p:
        acc += _shared_ffn(p["shared"], xf).to(torch.float32)
    return acc.to(xf.dtype)
