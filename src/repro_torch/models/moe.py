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
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


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


def route(router: torch.Tensor, xf: torch.Tensor, *, top_k: int,
          capacity_factor: float) -> Routing:
    """Top-k routing and capacity dispatch plan of ``xf`` (T, d)."""
    T = xf.shape[0]
    E = router.shape[1]
    probs = torch.softmax(xf.to(torch.float32) @ router, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :top_k], top_i[:, :top_k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
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
    rounded back before the product with u); at most two (E, C, f)
    buffers are live at once."""
    h = F.silu(torch.bmm(xbuf, p["w_gate"]).to(torch.float32)) \
        .to(xbuf.dtype)
    h.mul_(torch.bmm(xbuf, p["w_up"]))
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


def moe_apply(p, x, *, top_k: int, capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, Dict]:
    """x: (B,S,d). Returns (out, {"aux_loss", "dropped_frac"})."""
    B, S, d = x.shape
    E = p["router"].shape[1]
    T = B * S
    xf = x.reshape(T, d)
    r = route(p["router"], xf, top_k=top_k, capacity_factor=capacity_factor)
    # load-balancing aux loss (Switch-style), from each token's first pick
    frac_tokens = F.one_hot(r.top_i[:, 0], E).to(torch.float32).mean(dim=0)
    aux_loss = E * torch.sum(frac_tokens * r.probs.mean(dim=0))
    gathered = xf[r.tok] * r.keep[:, None].to(x.dtype)
    xbuf = torch.zeros((E * r.cap, d), dtype=x.dtype, device=x.device)
    xbuf.index_put_((r.slot,), gathered, accumulate=True)
    ybuf = _expert_ffn(p, xbuf.reshape(E, r.cap, d)).reshape(E * r.cap, d)
    w_sorted = r.top_w.reshape(-1)[r.order]
    y_slot = ybuf[r.slot] * (r.keep.to(torch.float32)
                             * w_sorted)[:, None].to(x.dtype)
    out = combine(y_slot, r, T).reshape(B, S, d)
    if "shared" in p:
        sp = p["shared"]
        g = xf @ sp["w_gate"]
        u = xf @ sp["w_up"]
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        out = out + (h @ sp["w_down"]).reshape(B, S, d)
    # times the float32 reciprocal: XLA evaluates the reference's division
    # so (a true division differs in the last bit for some T * k)
    dropped = torch.sum(1.0 - r.keep.to(torch.float32)) * (1.0 / (T * top_k))
    return out, {"aux_loss": aux_loss, "dropped_frac": dropped}
