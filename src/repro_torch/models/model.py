"""Model assembly: the decoder LM (counterpart of ``repro.models.model``).

Families:
  dense  : L x [GQA attention + MLP]
  vlm    : dense, with precomputed patch embeddings (``prefix_embeds``)
           in front of the tokens (internvl2; the vision tower is a stub)
  audio  : dense over precomputed frame embeddings (``frame_embeds``) in
           place of the token embedding (musicgen; the codec is a stub)
  moe    : L x [GQA attention + MoE]   (deepseek-moe, mixtral)
  ssm    : L x [Mamba-1]               (attention-free; falcon-mamba)
  hybrid : L x [Mamba-2] + one *shared* attention+MLP block applied after
           every ``shared_attn_every`` layers (zamba2)

The JAX package stacks each layer's parameters along a leading axis and
runs the stack with ``lax.scan``; the port keeps the same parameter tree
(so ``models.convert.params_from_jax`` is a plain copy) and loops over the
layers.  Decode is a single-token step against a cache (KV for the
attention families, a ring of ``window`` slots with sliding-window
attention; conv + state carries for ssm; both for hybrid, whose shared
block keeps one KV cache per application) that the port updates in place
(the JAX function returns a new one); the returned ``DecodeCache`` shares
the caller's storage.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (chunk_attention, decode_attention,
                                          flash_attention)
from repro_torch.models.flash_vjp import flash_attention_trainable
from repro_torch.models import ssm
from repro_torch.models.layers import (apply_rope, dense_init, embed_apply,
                                       embed_init, mlp_apply, mlp_init,
                                       rmsnorm, rmsnorm_init, unembed_apply)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.numerics import matmul
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import (constrain_layer_params, shard,
                                           tensor_size)
from repro_torch.telemetry.tracer import scope
from repro_torch.train import tree as tree_util

_ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to the KV cache's ``dtype``.  Into ``float8_e4m3fn``,
    |x| > 464 and +-inf become NaN, as the JAX package's ``astype`` gives
    them, where torch's cast saturates to +-448 (464 is the tie between
    448 and the next step, which rounds to 448)."""
    if dtype == torch.float8_e4m3fn:
        x = torch.where(x.abs() > 464, x.new_tensor(float("nan")), x)
    return x.to(dtype)


def _positions(tokens, prefix_embeds, frame_embeds) -> int:
    """The positions of a forward's batch: B x (prefix + sequence)."""
    x = frame_embeds if frame_embeds is not None else tokens
    n = x.shape[0] * x.shape[1]
    if prefix_embeds is not None:
        n += prefix_embeds.shape[0] * prefix_embeds.shape[1]
    return n


def _pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def _whole_layer_axis(t):
    """A stacked leaf with its leading (layer) axis whole.  Under a mesh the
    rules may shard it (the hybrid's stacked (L, H) ``A_log`` is sized as
    a 2-D leaf), and DTensor has no rule to index or unbind a sharded dim,
    so it is gathered first."""
    if not sh.is_dtensor(t) or not any(p.is_shard(0) for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_shard(0)
                                          else p for p in t.placements])


def _layer(tree: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the stacked parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict)
            else _whole_layer_axis(v)[i] for k, v in tree.items()}


def _refuse_plain_cache(cache, what: str):
    """The cache writers run under a mesh only on a cache whose leaves are
    DTensors: each rank writes its own shard, and a plain cache has none."""
    if sh.active() is not None and not all(
            sh.is_dtensor(t) for t in cache.data.values()):
        raise RuntimeError(f"{what} writes a plain cache in place and does "
                           f"not run it under a mesh; lay the cache out on "
                           f"the mesh (launch.specs' shardings)")


def _lanes(t, ids, dim: int):
    """Lanes ``ids`` of ``t`` along ``dim`` as a plain tensor; under a mesh
    the leaf is gathered whole on every rank first."""
    return sh.full(t)[(slice(None),) * dim + (ids,)]


def _write_lanes(t, new, ids, dim: int):
    """``t``'s lanes ``ids`` along ``dim`` set to ``new`` (plain, the whole
    lanes) in place.  Under a mesh each rank writes its own shard of ``t``:
    its lanes among ``ids``, and its slice of every other dim."""
    if not sh.is_dtensor(t):
        t[(slice(None),) * dim + (ids,)] = new
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local = t.to_local()
    _, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    own = ids - offset[dim]
    mine = torch.nonzero((own >= 0) & (own < local.shape[dim])).flatten()
    new = new[tuple(slice(None) if d == dim else slice(o, o + n)
                    for d, (o, n) in enumerate(zip(offset, local.shape)))]
    local[(slice(None),) * dim + (own[mine],)] = new.index_select(dim, mine)


def _unstack(tree: Dict, start: int, end: int):
    """Layers ``start`` to ``end`` of the stacked parameter tree as
    per-layer trees of views (one ``unbind`` a leaf, whose gradient is one
    ``stack``, where indexing each layer would add a full-size gradient
    per layer)."""
    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        return _whole_layer_axis(node)[start:end].unbind(0)

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]

    parts = split(tree)
    return [pick(parts, i) for i in range(end - start)]


def _needs_grad(tree: Dict, x) -> bool:
    """Autograd records this forward: grad mode is on and the input or a
    parameter requires grad."""
    if not torch.is_grad_enabled():
        return False
    if x.requires_grad:
        return True
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif node.requires_grad:
            return True
    return False


def _remat(fn, *args, on: bool):
    """``fn(*args)``, its activations recomputed in the backward when
    ``on`` (the JAX package's ``jax.checkpoint`` of each layer)."""
    if on:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _emulates(policy) -> bool:
    return policy is not None and getattr(policy, "emulate", False)


# ---------------------------------------------------------------------------
# Attention transformer block (dense / moe; the hybrid's shared block)
# ---------------------------------------------------------------------------
def attn_block_init(gen: torch.Generator, cfg: ArchConfig, dtype,
                    n: Optional[int]):
    """``n`` stacked blocks' parameters (leading axis = layer), or one
    block's with ``n=None``."""
    d, hd, dev = cfg.d_model, cfg.head_dim, gen.device
    lead = () if n is None else (n,)
    p = {
        "ln1": rmsnorm_init(d, dtype, dev, lead=lead),
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, lead=lead),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, lead=lead),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, lead=lead),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, lead=lead),
        "ln2": rmsnorm_init(d, dtype, dev, lead=lead),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads * hd),
                            ("bk", cfg.n_kv_heads * hd),
                            ("bv", cfg.n_kv_heads * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=dtype, device=dev)
    if cfg.family == "moe":
        p["moe"] = moe_init(gen, d, n_experts=cfg.n_experts,
                            moe_d_ff=cfg.moe_d_ff,
                            n_shared=cfg.n_shared_experts, dtype=dtype,
                            lead=lead)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dtype, lead=lead)
    return p


def _split_heads(t, B, S, n, hd):
    """(B, S, n * hd) -> (B, S, n, hd).  Under a mesh, a feature dim
    sharded over mesh axes whose size does not divide ``n`` is gathered
    first (DTensor cannot split it into uneven head shards; GSPMD gathers
    it too, by a full rematerialization), and the caller's ``shard``
    places the heads after the split."""
    if sh.is_dtensor(t):
        mesh, last = t.device_mesh, t.dim() - 1
        over = [i for i, p in enumerate(t.placements) if p.is_shard(last)]
        if n % math.prod(mesh.shape[i] for i in over):
            from torch.distributed.tensor import Replicate
            t = t.redistribute(mesh, [Replicate() if i in over else p
                                      for i, p in enumerate(t.placements)])
    return t.reshape(B, S, n, hd)


def _qkv(p, h, cfg: ArchConfig, positions, policy):
    B, S, _ = h.shape
    # under a mesh, the projections' input gathered over the model axis, as
    # the MLP's is (``_ffn``)
    h = shard(h, "batch", None, None)
    q = matmul(h, p["wq"], policy)
    k = matmul(h, p["wk"], policy)
    v = matmul(h, p["wv"], policy)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, B, S, cfg.n_heads, cfg.head_dim)
    k = _split_heads(k, B, S, cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(v, B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_style)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_style)
    return q, k, v


def _ffn(p, h2, cfg: ArchConfig, policy):
    """The MLP, or for the moe family the MoE (which no policy reaches:
    the JAX ``_ffn`` passes none to ``moe_apply``): under a mesh with a
    'data' axis of more than one rank, the expert-parallel dispatch of
    ``moe_sharded``, and under any other mesh the single-program one on
    every rank.  Returns (out, aux)."""
    if cfg.family == "moe":
        ctx = sh.active()
        if ctx is not None:
            from repro_torch.models import moe_sharded
            if ctx.axes.get("data", 1) > 1:
                return moe_sharded.moe_apply_distributed(
                    p["moe"], h2, top_k=cfg.experts_per_token,
                    capacity_factor=cfg.capacity_factor, ctx=ctx)
            return moe_sharded._moe_apply_replicated(
                p["moe"], h2, top_k=cfg.experts_per_token,
                capacity_factor=cfg.capacity_factor)
        return moe_apply(p["moe"], h2, top_k=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor)
    # under a mesh, the MLP's input gathered over the model axis (Megatron's
    # layout, which GSPMD picks): DTensor's own choice after a
    # sequence-sharded residual can replicate the whole MLP over 'model'
    h2 = shard(h2, "batch", None, None)
    return mlp_apply(p["mlp"], h2, cfg.mlp_act, policy), {"aux_loss": 0.0}


def _embed(table, tokens):
    """``embed_apply``; under a mesh a lookup per rank of its batch shard
    of ``tokens`` in the table gathered to ``Replicate``, whose gradient
    comes back as a partial sum over the batch axes (DTensor's own
    lookup and its backward in torch 2.11 fail on a sharded table)."""
    if not sh.is_dtensor(table):
        return embed_apply(table, tokens)
    ctx = sh.active()
    mesh = ctx.mesh
    tl = sh.to_local(tokens, mesh, sh.spec_for(
        ("batch",) + (None,) * (tokens.dim() - 1), tuple(tokens.shape), ctx))
    out = embed_apply(sh.to_local(table, mesh, sh.P(), ctx.batch_axes), tl)
    shape = tuple(tokens.shape) + (table.shape[-1],)
    return sh.from_local(out, mesh, sh.spec_for(
        ("batch",) + (None,) * (len(shape) - 1), shape, ctx))


def _add_residual(x, y):
    """``x + y``.  Under a mesh ``y`` is first laid out as ``x`` (a partial
    sum reduced into the residual's layout), and its gradient is gathered
    over the model axis on the way back: the projection that made ``y``
    then takes a gathered gradient (DTensor's own choice would gather its
    weight and the heads instead, and torch 2.11's DTensor can neither
    flatten a sequence-sharded gradient into a matmul's rows nor turn a
    shard back into a partial sum)."""
    if not sh.is_dtensor(x):
        return x + y
    y = sh.redistribute(y, x.device_mesh, x.placements)
    return x + sh.grad_to(y, "batch", None, None)


def _residual_ffn(p, x, attn, cfg: ArchConfig, policy):
    """x + wo(attn), then + ffn(norm): the block's second half.  Returns
    (out, aux)."""
    B, S = attn.shape[:2]
    # under a mesh, the heads merged and sharded over the model axis (with
    # heads that the axis does not divide, the merge's backward then gets
    # a gathered gradient, which it can split into heads)
    flat = shard(attn.reshape(B, S, -1), "batch", None, "tensor")
    x = _add_residual(x, matmul(flat, p["wo"], policy))
    h2 = rmsnorm(p["ln2"], x)
    ff, aux = _ffn(p, h2, cfg, policy)
    return _add_residual(x, ff), aux


def _attend(q, k, v, cfg: ArchConfig, triangle_skip: bool):
    """Causal attention of (B, S, H, D) q, k, v.  With ``triangle_skip``
    the plain blockwise forward with the causal per-block kv extent
    (autograd through it keeps every block's probabilities), else the
    recompute-backward ``flash_vjp`` one.  Under a mesh it runs per rank
    on the local batch and head shards (``local_map``), as the JAX
    package's attention is batch- and head-parallel; its in-place block
    writes then stay on plain tensors."""
    def run(q, k, v):
        if triangle_skip:
            return flash_attention(q, k, v, causal=True, window=cfg.window,
                                   triangle_skip=True)
        return flash_attention_trainable(q, k, v, causal=True,
                                         window=cfg.window)

    ctx = sh.active()
    if ctx is None:
        return run(q, k, v)
    from torch.distributed.tensor.experimental import local_map
    return local_map(run, out_placements=(q.placements,),
                     in_placements=(q.placements, k.placements,
                                    v.placements),
                     device_mesh=ctx.mesh)(q, k, v)


def attn_block_apply(p, x, positions, cfg: ArchConfig, *, policy=None,
                     triangle_skip: bool = False):
    """Full-sequence block.  Returns (out, aux, (k, v)); ``_attend`` says
    which attention runs."""
    h = rmsnorm(p["ln1"], x)
    q, k, v = _qkv(p, h, cfg, positions, policy)
    # TP over heads: when Hkv doesn't divide the model axis but Hq does,
    # repeat KV to full heads so attention shards over the model axis
    ts = tensor_size()
    ka, va = k, v
    if ts > 1 and cfg.n_kv_heads % ts and cfg.n_heads % ts == 0:
        g = cfg.n_heads // cfg.n_kv_heads
        ka = torch.repeat_interleave(k, g, dim=2)
        va = torch.repeat_interleave(v, g, dim=2)
    q = shard(q, "batch", None, "tensor", None)
    ka = shard(ka, "batch", None, "tensor", None)
    va = shard(va, "batch", None, "tensor", None)
    attn = _attend(q, ka, va, cfg, triangle_skip)
    out, aux = _residual_ffn(p, x, attn, cfg, policy)
    # Megatron-SP: residual stream sequence-sharded over the model axis
    # between blocks
    out = shard(out, "batch", "tensor", None)
    return out, aux, (k, v)


def attn_block_decode(p, x, k_cache, v_cache, cache_len, cfg: ArchConfig, *,
                      ring: bool = False, policy=None, write_mask=None):
    """x: (B,1,d); caches (B,Smax,Hkv,D), written in place at each lane's
    ``cache_len`` (B,), or on a ring (sliding window) at ``cache_len %
    Smax`` — except lanes where ``write_mask`` is False or (not a ring) the
    position lies beyond the cache, whose cache bits stay as they were.  A
    ring holds exactly the window, so it needs no window mask."""
    B = x.shape[0]
    Smax = k_cache.shape[1]
    h = rmsnorm(p["ln1"], x)
    q, k, v = _qkv(p, h, cfg, cache_len[:, None], policy)
    if ring:
        idx = cache_len % Smax
        keep = torch.ones_like(cache_len, dtype=torch.bool)
    else:
        idx = cache_len.clamp(max=Smax - 1)
        keep = cache_len < Smax
    if write_mask is not None:
        keep = keep & write_mask
    valid = torch.clamp(cache_len + 1, max=Smax)
    window = 0 if ring else cfg.window
    if sh.is_dtensor(k_cache):
        for cache, fresh in ((k_cache, k), (v_cache, v)):
            _write_shard(cache, fresh, idx, keep)
        attn = _decode_attention_shards(q, k_cache, v_cache, valid, window)
        attn = shard(attn, "batch", None, "tensor", None)
        return _residual_ffn(p, x, attn, cfg, policy)[0]
    lanes = torch.arange(B, device=x.device)
    keep = keep[:, None, None]
    k_cache[lanes, idx] = torch.where(keep, to_cache(k[:, 0], k_cache.dtype),
                                      k_cache[lanes, idx])
    v_cache[lanes, idx] = torch.where(keep, to_cache(v[:, 0], v_cache.dtype),
                                      v_cache[lanes, idx])
    attn = decode_attention(q, k_cache, v_cache, valid, window=window)
    return _residual_ffn(p, x, attn, cfg, policy)[0]


def _shard_view(cache, like):
    """``like`` (B, 1, H, D) laid out as ``cache`` (B, Smax, Hkv, D) lays out
    its lanes, heads and head dims (replicated over the mesh axes that
    shard the sequence), and this rank's local tensors: (like's shard,
    cache's shard, the cache shard's global offsets, like's placements)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = cache.device_mesh
    pl = [Shard(p.dim) if p.is_shard() and p.dim != 1 else Replicate()
          for p in cache.placements]
    _, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    return (like.redistribute(mesh, pl).to_local(), cache.to_local(), offset,
            pl)


def _write_shard(cache, fresh, idx, keep):
    """Under a mesh, each rank writes ``fresh`` (B, 1, Hkv, D) into its own
    shard of ``cache`` (B, Smax, Hkv, D) at each lane's position ``idx``
    where ``keep``: its own lanes, heads or head dims; where the sequence
    is sharded only the rank that holds position ``idx`` writes, at its
    local index."""
    f, c, (b0, s0, _, _), _ = _shard_view(cache, fresh)
    idx, keep = sh.full(idx), sh.full(keep)
    nb, ns = c.shape[:2]
    local = idx[b0:b0 + nb] - s0
    keep = keep[b0:b0 + nb] & (local >= 0) & (local < ns)
    local = local.clamp(0, ns - 1)
    lanes = torch.arange(nb, device=c.device)
    c[lanes, local] = torch.where(keep[:, None, None],
                                  to_cache(f[:, 0], c.dtype), c[lanes, local])


def _decode_attention_shards(q, k_cache, v_cache, valid, window):
    """``decode_attention`` per rank over a sharded cache: lanes and kv
    heads (q's heads with them) are local; a head dim sharded over a mesh
    axis sums the scores across it; a sequence sharded over a mesh axis
    takes the row max and the exp sum across it before dividing, the
    unsharded softmax's order, and sums the p @ v partials.  Returns a
    DTensor laid out as the cache's lanes, heads and head dims."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.models.attention import NEG_INF, _f32
    mesh = k_cache.device_mesh
    ql, kc, (b0, s0, _, _), pl = _shard_view(k_cache, q)
    vc = v_cache.to_local()
    B, Smax, Hkv, D = kc.shape
    G = ql.shape[2] // Hkv
    groups = {dim: [mesh.get_group(i) for i, p in
                    enumerate(k_cache.placements) if p.is_shard(dim)]
              for dim in (1, 3)}

    def reduce(t, op, dim):
        for g in groups[dim]:
            dist.all_reduce(t, op=op, group=g)
        return t

    scale = 1.0 / math.sqrt(q.shape[3])
    qg = _f32(ql.reshape(B, Hkv, G, D))
    s = reduce(torch.einsum("bhgd,bkhd->bhgk", qg, _f32(kc.to(q.dtype))),
               dist.ReduceOp.SUM, 3) * scale
    k_pos = s0 + torch.arange(Smax, device=kc.device)
    cl = sh.full(valid)[b0:b0 + B].reshape(-1, 1)
    ok = k_pos[None, :] < cl
    if window:
        ok = ok & (k_pos[None, :] >= cl - window)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    if not groups[1]:
        p = torch.softmax(s, dim=-1)
    else:
        m = reduce(s.amax(dim=-1, keepdim=True), dist.ReduceOp.MAX, 1)
        e = torch.exp(s - m)
        p = e / reduce(e.sum(dim=-1, keepdim=True), dist.ReduceOp.SUM, 1)
    out = torch.einsum("bhgk,bkhd->bhgd", _f32(p.to(q.dtype)),
                       _f32(vc.to(q.dtype)))
    out = reduce(out, dist.ReduceOp.SUM, 1).reshape(B, 1, Hkv * G, D)
    return DTensor.from_local(out.to(q.dtype), mesh, pl, run_check=False,
                              shape=q.shape, stride=q.stride())


def _chunk_attn_block(p, x, k_cache, v_cache, offsets, chunk_lens, positions,
                      cfg: ArchConfig, *, ring: bool, policy=None):
    """Chunk-resumable attention block over gathered per-lane cache lanes.

    x: (M,Cb,d); k_cache/v_cache: (M,smax,Hkv,D); offsets/chunk_lens: (M,)
    tokens already prefilled / valid tokens in this chunk; positions:
    (M,Cb).  Attends against the history (on a ring: the last ``smax``
    positions, gathered in position order) + the fresh chunk, and returns
    (out, new_k, new_v) with only the valid chunk K/V written.  On a ring a
    chunk longer than ``smax`` writes only its last ``smax`` columns, the
    positions the ring keeps."""
    M, Cb, _ = x.shape
    smax = k_cache.shape[1]
    dev = x.device
    h = rmsnorm(p["ln1"], x)
    q, k, v = _qkv(p, h, cfg, positions, policy)
    mesh = q.device_mesh if sh.is_dtensor(q) else None
    if mesh is not None:
        # under a mesh the attention runs whole on every rank, over the
        # chunk's q, k, v gathered and the cache lanes (plain, gathered)
        q, k, v = sh.full(q), sh.full(k), sh.full(v)
    col = torch.arange(Cb, device=dev)[None, :]
    valid_new = col < chunk_lens[:, None]
    i = torch.arange(smax, device=dev)[None, :]
    if ring:
        hist_pos = offsets[:, None] - smax + i
        slot = (hist_pos % smax)[..., None, None]
        k_hist = torch.take_along_dim(k_cache, slot, dim=1)
        v_hist = torch.take_along_dim(v_cache, slot, dim=1)
        hist_valid = hist_pos >= 0
        write_pos = positions % smax
        written = valid_new & (col >= chunk_lens[:, None] - smax)
    else:
        hist_pos = i.expand(M, smax)
        k_hist, v_hist = k_cache, v_cache
        hist_valid = hist_pos < offsets[:, None]
        write_pos, written = positions, valid_new
    k_all = torch.cat([k_hist.to(k.dtype), k], dim=1)
    v_all = torch.cat([v_hist.to(v.dtype), v], dim=1)
    k_pos = torch.cat([hist_pos, positions], dim=1)
    k_valid = torch.cat([hist_valid, valid_new], dim=1)
    attn = chunk_attention(q, k_all, v_all, positions, k_pos, k_valid,
                           window=cfg.window)
    if mesh is not None:
        attn = sh.from_local(attn, mesh)
    # columns not written go to a scratch slot past the cache and are dropped
    write_idx = torch.where(written, write_pos, smax).clamp(max=smax)
    lanes = torch.arange(M, device=dev)[:, None]
    new_k, new_v = [], []
    for cache, fresh, out in ((k_cache, k, new_k), (v_cache, v, new_v)):
        ext = torch.cat([cache, cache[:, :1]], dim=1)
        ext[lanes, write_idx] = to_cache(fresh, cache.dtype)
        out.append(ext[:, :smax])
    out = shard(_residual_ffn(p, x, attn, cfg, policy)[0], "batch",
                "tensor", None)
    return out, new_k[0], new_v[0]


# ---------------------------------------------------------------------------
# SSM block (norm + mamba)
# ---------------------------------------------------------------------------
def ssm_block_init(gen: torch.Generator, cfg: ArchConfig, dtype, n: int):
    """``n`` stacked blocks' parameters (leading axis = layer)."""
    d, lead = cfg.d_model, (n,)
    p = {"ln": rmsnorm_init(d, dtype, gen.device, lead=lead)}
    if cfg.ssm_version == 1:
        p["mamba"] = ssm.mamba1_init(gen, d, d_state=cfg.ssm_state,
                                     expand=cfg.ssm_expand, conv=cfg.ssm_conv,
                                     dtype=dtype, lead=lead)
    else:
        p["mamba"] = ssm.mamba2_init(gen, d, d_state=cfg.ssm_state,
                                     expand=cfg.ssm_expand, conv=cfg.ssm_conv,
                                     head_dim=cfg.ssm_head_dim, dtype=dtype,
                                     lead=lead)
    return p


def _mamba(p, h, cfg: ArchConfig, state, return_state: bool):
    kw = dict(state=state, return_state=return_state,
              chunk=cfg.ssm_scan_chunk)
    if cfg.ssm_version == 1:
        return ssm.mamba1_apply(p, h, d_state=cfg.ssm_state, **kw)
    return ssm.mamba2_apply(p, h, d_state=cfg.ssm_state,
                            head_dim=cfg.ssm_head_dim, **kw)


class _SumOverRanks(torch.autograd.Function):
    """The sum over a group of per-rank partial sums that each rank then
    uses in its own way: the backward sums the ranks' gradients too."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ChannelShards:
    """Rank ``r`` of ``n`` along the model axis, holding one shard of a
    mamba block's inner channels (``ssm.mamba1_apply``'s ``shards``)."""

    def __init__(self, group, n: int, r: int):
        self.group, self.n, self.r = group, n, r

    def psum(self, t):
        return _SumOverRanks.apply(t, self.group)

    def gather(self, t):
        from repro_torch.models.moe_sharded import _GatherOver
        return _GatherOver.apply(t, self.group, t.dim() - 1)

    def slices(self, width: int, base: int = 0):
        """This shard's columns of a run of ``width`` starting at ``base``."""
        w = width // self.n
        return slice(base + self.r * w, base + (self.r + 1) * w)


def _channel_sharded(cfg: ArchConfig, n: int) -> bool:
    """The mamba block's channels (and, for Mamba-2, heads and B/C
    channels) split evenly into ``n`` shards."""
    d_in = cfg.ssm_expand * cfg.d_model
    if n < 2 or d_in % n:
        return False
    return cfg.ssm_version == 1 or (
        (d_in // cfg.ssm_head_dim) % n == 0 and (2 * cfg.ssm_state) % n == 0)


def _shard_params(p, cfg: ArchConfig, sd: _ChannelShards):
    """This shard's slice of a mamba block's whole parameters: its inner
    channels (for Mamba-2 its heads' channels, B/C channels and dt
    columns), with ``in_proj``'s and ``conv_w``'s pieces concatenated in
    the unsharded order."""
    d_in = p["out_proj"].shape[0]
    ch = sd.slices(d_in)
    if cfg.ssm_version == 1:
        w = p["in_proj"]
        return {"in_proj": torch.cat([w[:, ch], w[:, sd.slices(d_in, d_in)]],
                                     dim=-1),
                "conv_w": p["conv_w"][:, ch], "conv_b": p["conv_b"][ch],
                "x_proj": p["x_proj"][ch], "dt_proj": p["dt_proj"][:, ch],
                "dt_bias": p["dt_bias"][ch], "A_log": p["A_log"][ch],
                "D": p["D"][ch], "out_proj": p["out_proj"][ch]}
    bc = 2 * cfg.ssm_state
    H = d_in // cfg.ssm_head_dim
    hs = sd.slices(H)
    w = p["in_proj"]  # columns: z, x, B and C, dt
    cw, cb = p["conv_w"], p["conv_b"]  # channels: x, B and C
    return {"in_proj": torch.cat([w[:, ch], w[:, sd.slices(d_in, d_in)],
                                  w[:, sd.slices(bc, 2 * d_in)],
                                  w[:, sd.slices(H, 2 * d_in + bc)]], dim=-1),
            "conv_w": torch.cat([cw[:, ch], cw[:, sd.slices(bc, d_in)]], -1),
            "conv_b": torch.cat([cb[ch], cb[sd.slices(bc, d_in)]]),
            "A_log": p["A_log"][hs], "dt_bias": p["dt_bias"][hs],
            "D": p["D"][hs], "norm": {"scale": p["norm"]["scale"][ch]},
            "out_proj": p["out_proj"][ch]}


def _mamba_per_rank(p, h, cfg: ArchConfig, state, return_state: bool):
    """The mamba block under a mesh, run per rank on its batch shard.  The
    parameters are gathered to ``Replicate`` (the chunked scan's slices,
    pads and concatenations of the state expansion have no DTensor
    sharding rule).  When the model axis splits the inner channels evenly
    (``_channel_sharded``), each of its ranks runs one shard of them, as
    GSPMD partitions the JAX block: the contractions over the channels
    (x_proj's inside every scan chunk, Mamba-2's gated norm) are summed
    over the axis and out_proj's product leaves as a partial sum; the
    decode states keep the cache's layout (``launch.specs``: channels, or
    heads, on the model axis).  Otherwise each rank runs the whole block.
    Returns what ``_mamba`` returns, as DTensors."""
    from torch.distributed.tensor import DTensor, Partial
    ctx = sh.active()
    mesh = ctx.mesh
    names = list(sh.mesh_axes(mesh))
    n = ctx.tensor_size
    sd = None
    if _channel_sharded(cfg, n):
        sd = _ChannelShards(mesh.get_group(names.index(ctx.tensor_axis)), n,
                            mesh.get_local_rank(ctx.tensor_axis))

    def spec(logical, shape):
        return sh.spec_for(logical, tuple(shape), ctx)

    def batch_spec(shape):
        return spec(("batch",) + (None,) * (len(shape) - 1), shape)

    model = (ctx.tensor_axis,) if sd is not None else ()
    leaves = [sh.to_local(t, mesh, sh.P(), ctx.batch_axes + model)
              for t in tree_util.leaves(p)]
    whole = tree_util.unflatten(p, leaves)
    hl = sh.to_local(h, mesh, batch_spec(h.shape), model)
    if sd is None:
        local_state = None if state is None else tuple(
            sh.to_local(t, mesh, batch_spec(t.shape)) for t in state)
        out = _mamba(whole, hl, cfg, local_state, return_state)
        flat = [out[0], *out[1]] if return_state else [out]
        # each leads with the batch
        glob = [sh.from_local(t, mesh,
                              batch_spec((h.shape[0],) + t.shape[1:]))
                for t in flat]
        return (glob[0], tuple(glob[1:])) if return_state else glob[0]

    d_in = cfg.ssm_expand * cfg.d_model
    v1 = cfg.ssm_version == 1
    conv_logical = ("batch", None, "tensor" if v1 else None)
    h_logical = ("batch", "tensor") + (None,) * (1 if v1 else 2)
    local_state = None
    if state is not None:
        conv, hs = state
        conv = sh.to_local(conv, mesh, spec(conv_logical, conv.shape))
        if not v1:  # this shard's x and B/C channels of the whole carry
            conv = torch.cat([conv[..., sd.slices(d_in)], conv[
                ..., sd.slices(2 * cfg.ssm_state, d_in)]], dim=-1)
        local_state = (conv, sh.to_local(hs, mesh, spec(h_logical,
                                                        hs.shape)))
    kw = dict(state=local_state, return_state=return_state,
              chunk=cfg.ssm_scan_chunk, shards=sd)
    local = _shard_params(whole, cfg, sd)
    if v1:
        out = ssm.mamba1_apply(local, hl, d_state=cfg.ssm_state, **kw)
    else:
        out = ssm.mamba2_apply(local, hl, d_state=cfg.ssm_state,
                               head_dim=cfg.ssm_head_dim, **kw)
    y = out[0] if return_state else out
    pl = list(sh.placements(batch_spec(h.shape), mesh))
    pl[names.index(ctx.tensor_axis)] = Partial()
    y = DTensor.from_local(y, mesh, pl, run_check=False, shape=h.shape,
                           stride=h.stride())
    if not return_state:
        return y
    conv, hs = out[1]
    B = h.shape[0]
    if not v1:  # the whole carry, each shard's x and B/C channels joined
        conv = torch.cat([sd.gather(conv[..., :d_in // n]),
                          sd.gather(conv[..., d_in // n:])], dim=-1)
    conv_shape = (B,) + tuple(conv.shape[1:-1]) + (
        conv.shape[-1] * n if v1 else conv.shape[-1],)
    hs_shape = (B, hs.shape[1] * n) + tuple(hs.shape[2:])
    return y, (sh.from_local(conv, mesh, spec(conv_logical, conv_shape)),
               sh.from_local(hs, mesh, spec(h_logical, hs_shape)))


def ssm_block_apply(p, x, cfg: ArchConfig, state=None,
                    return_state: bool = False):
    """x + mamba(norm(x)); with ``return_state`` also the block's
    (conv carry, h) after the sequence."""
    h = rmsnorm(p["ln"], x)
    run = _mamba_per_rank if sh.active() is not None else _mamba
    out = run(p["mamba"], h, cfg, state, return_state)
    if return_state:
        y, new_state = out
        return shard(_add_residual(x, y), "batch", "tensor", None), new_state
    return shard(_add_residual(x, out), "batch", "tensor", None)


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DecodeCache:
    """Decode state: ``data`` {"k", "v"} of shape (L, B, Smax, Hkv, D)
    (dense, moe; Smax = min(max_len, window) with a window), {"conv" (L, B,
    K-1, C), "h" (L, B, ...)} (ssm), or both (hybrid, with k/v of shape
    (n_shared_applications, B, max_len, Hkv, D)), and ``length``, a 0-d
    (single sequence) or (B,) per-slot int64 tensor."""

    data: Dict
    length: torch.Tensor


class _MetaGenerator(torch.Generator):
    """A CPU generator whose draws land on the ``meta`` device (torch has no
    meta generator): ``LM(cfg, device="meta").init`` builds the parameter
    shapes of any config without memory."""

    @property
    def device(self):
        return torch.device("meta")


class LM:
    """Decoder LM for one ArchConfig, on ``device`` (default CUDA;
    ``"meta"`` gives shapes only)."""

    def __init__(self, cfg: ArchConfig, device=None):
        if cfg.family not in _ATTN_FAMILIES + ("ssm", "hybrid"):
            raise ValueError(cfg.family)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vocab_padded = _pad_vocab(cfg.vocab_size)
        self.dtype = _DTYPES[cfg.dtype]

    @property
    def ring(self) -> bool:
        """The KV cache is a ring of ``window`` slots (sliding-window
        attention); the hybrid's shared-block caches never are."""
        return bool(self.cfg.window) and self.cfg.family != "hybrid"

    # ------------------------------------------------------------- init ----
    def init(self, seed: int) -> Dict:
        """Random parameters drawn on the model's device from a
        ``torch.Generator`` seeded with ``seed``."""
        cfg, dtype = self.cfg, self.dtype
        gen = _MetaGenerator() if self.device.type == "meta" \
            else torch.Generator(device=self.device)
        gen.manual_seed(seed)
        block_init = attn_block_init if cfg.family in _ATTN_FAMILIES \
            else ssm_block_init
        params = {
            "embed": embed_init(gen, self.vocab_padded, cfg.d_model, dtype),
            "final_norm": rmsnorm_init(cfg.d_model, dtype, self.device),
            "layers": block_init(gen, cfg, dtype, cfg.n_layers),
        }
        if cfg.family == "hybrid":
            params["shared_attn"] = attn_block_init(gen, cfg, dtype, None)
        return params

    # ------------------------------------------------------- segments ------
    def _segments(self):
        """[(start, end, apply_shared_after), ...]: the hybrid's Mamba-2
        runs of ``shared_attn_every`` layers, each followed by the shared
        block, and a shorter trailing run without it; one run otherwise."""
        cfg = self.cfg
        if cfg.family != "hybrid":
            return [(0, cfg.n_layers, False)]
        every = cfg.shared_attn_every
        segs, start = [], 0
        while start < cfg.n_layers:
            end = min(start + every, cfg.n_layers)
            segs.append((start, end, end - start == every))
            start = end
        return segs

    @property
    def n_shared_applications(self) -> int:
        return sum(1 for _, _, s in self._segments() if s)

    # ------------------------------------------------------- forward -------
    def _embed_inputs(self, params, tokens, prefix_embeds, frame_embeds):
        """The stack's input: ``frame_embeds`` (B, S, d) in place of the
        token embedding, cast to the model dtype, and ``prefix_embeds``
        (B, P, d), cast likewise, concatenated in front."""
        if frame_embeds is not None:
            x = frame_embeds.to(self.dtype)
        else:
            x = _embed(params["embed"], tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(self.dtype), x], dim=1)
        return shard(x, "batch", None, None)

    def apply(self, params, tokens=None, *, prefix_embeds=None,
              frame_embeds=None, policy=None, collect_kv: bool = False,
              collect_states: bool = False, triangle_skip: bool = False,
              logits_last_only: bool = False, last_index=None,
              moe_stats: bool = False):
        """Full-sequence forward over ``tokens`` (B, S), or over
        ``frame_embeds`` (B, S, d) (audio), with ``prefix_embeds`` (B, P, d)
        in front (vlm; their positions come first and are unembedded too).
        Returns (logits, aux), with
        ``collect_kv`` (attention families, hybrid) then (k, v) of shape
        (L or n_shared_applications, B, S, Hkv, D) in the cache dtype (None
        for a hybrid without a shared application), and with
        ``collect_states`` (ssm, hybrid) then (conv, h): each layer's
        decode state after the sequence, stacked.  ``aux`` is the MoE
        load-balance loss summed over the layers (0.0 without experts);
        with ``moe_stats`` (moe family) it is instead a dict of that sum
        (``aux_loss``) and each layer's dropped share (``dropped_frac``,
        (L,) float32).

        logits_last_only: unembed only the final position; last_index: (B,)
        per-sample position to unembed instead (bucket-padded prefill).
        triangle_skip: the attention blocks visit only the kv blocks the
        causal mask reaches (``attention.flash_attention``).  When autograd
        records the forward and ``cfg.remat`` is set, each layer's
        activations are recomputed in the backward.
        Under a policy, only the attention projections, the dense MLPs and
        the unembed are emulated: the ssm family's only policy-routed
        matmul is the unembed, the moe family's experts and router take
        none, nor do the hybrid's Mamba-2 blocks.

        Under a mesh (``parallel.sharding.use_mesh``) the parameters are
        DTensors and so are the results.  Runs in the phase scope
        ``model.apply`` (``tokens``: the positions of the batch)."""
        with scope("model.apply") as sc, sh.mesh_region():
            if sc.on:
                sc.set(tokens=_positions(tokens, prefix_embeds,
                                         frame_embeds))
            return self._apply(params, tokens, prefix_embeds, frame_embeds,
                               policy, collect_kv, collect_states,
                               triangle_skip, logits_last_only, last_index,
                               moe_stats)

    def _apply(self, params, tokens, prefix_embeds, frame_embeds, policy,
               collect_kv, collect_states, triangle_skip, logits_last_only,
               last_index, moe_stats):
        x = self._embed_inputs(params, tokens, prefix_embeds, frame_embeds)
        B = x.shape[0]
        x, aux, kv, states = self._stack(params, x, policy, collect_kv,
                                         collect_states, triangle_skip)
        if not moe_stats:
            aux = aux["aux_loss"]
        x = rmsnorm(params["final_norm"], x)
        if last_index is not None:
            x = x[torch.arange(B, device=x.device), last_index][:, None]
        elif logits_last_only:
            x = x[:, -1:]
        # under a mesh, the unembed's input gathered over the model axis
        # (the blocks leave the sequence sharded on it, which DTensor
        # cannot flatten into a matmul's rows in every torch release)
        x = shard(x, "batch", None, None)
        # (and the tied table's gradient from the unembed laid out as the
        # table, as the lookup's comes back: torch 2.11's DTensor cannot
        # add a shard to a partial sum)
        table = sh.grad_to(params["embed"], "tensor", "fsdp")
        logits = shard(unembed_apply(table, x, policy), "batch", None,
                       "tensor")
        return (logits, aux) + ((kv,) if collect_kv else ()) \
            + ((states,) if collect_states else ())

    def _stack(self, params, x, policy, collect_kv: bool,
               collect_states: bool, triangle_skip: bool = False):
        """The layers over the embedded x.  Returns (x, aux, kv or None,
        states or None); aux: the summed ``aux_loss`` and, for the moe
        family, each layer's ``dropped_frac`` stacked."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux, ks, vs, states = 0.0, [], [], None
        dropped = []
        remat = cfg.remat and _needs_grad(params, x)
        if cfg.family in _ATTN_FAMILIES:
            def block(lp, x):
                lp = constrain_layer_params(lp, cfg.n_experts)
                return attn_block_apply(lp, x, positions, cfg, policy=policy,
                                        triangle_skip=triangle_skip)

            for lp in _unstack(params["layers"], 0, cfg.n_layers):
                x, a, (k, v) = _remat(block, lp, x, on=remat)
                aux = aux + a["aux_loss"]
                if "dropped_frac" in a:
                    dropped.append(a["dropped_frac"])
                if collect_kv:
                    ks.append(k)
                    vs.append(v)
        elif cfg.family == "ssm":
            x, states = self._ssm_stack(params["layers"], x,
                                        collect=collect_states)
        else:  # hybrid
            convs, hs = [], []
            for s, e, shared in self._segments():
                x, st = self._ssm_stack(params["layers"], x,
                                        collect=collect_states, start=s,
                                        end=e)
                if collect_states:
                    convs.append(st[0])
                    hs.append(st[1])
                if shared:
                    x, _, (k, v) = attn_block_apply(
                        params["shared_attn"], x, positions, cfg,
                        policy=policy, triangle_skip=triangle_skip)
                    if collect_kv:
                        ks.append(k)
                        vs.append(v)
            if collect_states:
                states = (torch.cat(convs), torch.cat(hs))
        kv = None
        if ks:
            kv = (torch.stack([to_cache(k, self.cache_dtype) for k in ks]),
                  torch.stack([to_cache(v, self.cache_dtype) for v in vs]))
        aux = {"aux_loss": aux}
        if dropped:
            aux["dropped_frac"] = torch.stack(dropped)
        return x, aux, kv, states

    def _ssm_stack(self, layers, x, states=None, collect: bool = False,
                   start: int = 0, end: Optional[int] = None):
        """Layers ``start`` to ``end`` (default all) of the ssm stack over
        x.  ``states``: per-layer (conv, h) stacked on a leading axis over
        every layer, to resume from (None: zeros).  Returns (x, (conv, h)
        of those layers stacked) when collecting or resuming, else (x,
        None)."""
        convs, hs = [], []
        keep = collect or states is not None
        cfg = self.cfg
        end = cfg.n_layers if end is None else end
        remat = cfg.remat and not keep and _needs_grad(layers, x)

        def block(lp, x):
            return ssm_block_apply(constrain_layer_params(lp, cfg.n_experts),
                                   x, cfg)

        for i, lp in enumerate(_unstack(layers, start, end), start):
            if not keep:
                x = _remat(block, lp, x, on=remat)
                continue
            lp = constrain_layer_params(lp, cfg.n_experts)
            st = None if states is None else (states[0][i], states[1][i])
            x, (conv, h) = ssm_block_apply(lp, x, cfg, state=st,
                                           return_state=True)
            convs.append(conv)
            hs.append(h)
        return x, ((torch.stack(convs), torch.stack(hs)) if keep else None)

    # --------------------------------------------------------- loss --------
    def loss_fn(self, params, batch, *, policy=None):
        """batch: ``labels`` (B, S) with ``tokens`` (B, S), or
        ``frame_embeds`` (audio), and any ``prefix_embeds`` (vlm), whose
        positions are not scored.  Labels < 0 are masked.  Returns (loss,
        metrics): the mean cross-entropy over the scored tokens, plus the
        z-loss 1e-4 * mean(logsumexp^2 * mask), plus 0.01 * the MoE
        load-balance loss; metrics ``ce``, ``z_loss``, ``aux_loss`` and
        ``tokens`` (the scored count, at least 1), f32 tensors (DTensors
        under a mesh)."""
        with sh.mesh_region():
            return self._loss_fn(params, batch, policy)

    def _loss_fn(self, params, batch, policy):
        logits, aux = self.apply(
            params, batch.get("tokens"),
            prefix_embeds=batch.get("prefix_embeds"),
            frame_embeds=batch.get("frame_embeds"), policy=policy)
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, logits.shape[1] - labels.shape[1]:]
            if sh.is_dtensor(logits):
                # DTensor's sharding rule for log_softmax runs the op on a
                # fake tensor of the mesh's device type, and on a strided
                # one a torch built without CUDA cannot for a "cuda" mesh
                logits = logits.contiguous()
        mask = (labels >= 0).to(torch.float32)
        safe = labels.clamp(min=0)
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, safe[..., None])[..., 0]
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = -(ll * mask).sum() / denom
        zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2 * mask) * 1e-4
        if sh.is_dtensor(ce):
            # a sum and a mean over sharded dims are partial sums of two
            # kinds, which DTensor in torch 2.11 cannot add: reduce both
            mesh = ce.device_mesh
            ce, zl = (sh.redistribute(t, mesh, sh.placements(sh.P(), mesh))
                      for t in (ce, zl))
        aux = torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
        loss = ce + zl + 0.01 * aux
        return loss, {"ce": ce, "z_loss": zl, "aux_loss": aux,
                      "tokens": denom}

    def _decode_states(self, params, tokens, policy, states,
                       prefix_embeds=None, frame_embeds=None):
        """The hybrid's decode states after a prefill, the JAX package's
        way: from a second forward whose shared blocks run with no policy
        (``_prefill_ssm_states``).  Under an emulating policy they differ
        from the first pass's after the first shared application, so that
        pass runs here; otherwise the first pass's are the same numbers."""
        if self.cfg.family != "hybrid" or not _emulates(policy):
            return states
        x = self._embed_inputs(params, tokens, prefix_embeds, frame_embeds)
        return self._stack(params, x, None, False, True)[3]

    # -------------------------------------------------------- caches -------
    @property
    def cache_dtype(self):
        return _DTYPES[self.cfg.kv_cache_dtype or self.cfg.dtype]

    def init_cache(self, batch: int, max_len: int) -> DecodeCache:
        """Zeroed decode state for ``batch`` lanes: KV of ``max_len``
        positions (a ring of min(max_len, window) slots with a window) and,
        for ssm and hybrid, conv and h carries (which do not grow with the
        length)."""
        cfg, dev = self.cfg, self.device
        data = {}
        if cfg.family in ("ssm", "hybrid"):
            (conv_s, conv_t), (h_s, h_t) = ssm.mamba_state_shapes(cfg, batch)
            L = cfg.n_layers
            data["conv"] = torch.zeros((L,) + conv_s, dtype=conv_t,
                                       device=dev)
            data["h"] = torch.zeros((L,) + h_s, dtype=h_t, device=dev)
        if cfg.family != "ssm":
            n = cfg.n_layers if cfg.family in _ATTN_FAMILIES \
                else self.n_shared_applications
            smax = min(max_len, cfg.window) if self.ring else max_len
            shp = (n, batch, smax, cfg.n_kv_heads, cfg.head_dim)
            for name in ("k", "v"):
                data[name] = torch.zeros(shp, dtype=self.cache_dtype,
                                         device=dev)
        return DecodeCache(data, torch.zeros((), dtype=torch.int64,
                                             device=dev))

    def cache_at_length(self, cache: DecodeCache, length) -> DecodeCache:
        return DecodeCache(cache.data, torch.as_tensor(
            length, dtype=torch.int64, device=self.device))

    # -------------------------------------------------------- decode -------
    def _ssm_decode(self, lp, x, data, i, write_mask):
        """One ssm layer's decode step; layer ``i``'s carries are written in
        place (masked-off lanes keep theirs)."""
        x, new = ssm_block_apply(lp, x, self.cfg, return_state=True,
                                 state=(data["conv"][i], data["h"][i]))
        for old, fresh in zip((data["conv"][i], data["h"][i]), new):
            if write_mask is not None:
                keep = write_mask.reshape((x.shape[0],) + (1,) *
                                          (fresh.dim() - 1))
                fresh = torch.where(keep, fresh, old)
            old.copy_(fresh)
        return x

    def decode_step(self, params, cache: DecodeCache, tokens, *, policy=None,
                    write_mask=None):
        """tokens: (B,1) -> (logits (B,1,V), cache advanced by one).

        The cache is written in place; ``write_mask`` (B,) bool leaves the
        cache bits of masked-off lanes untouched.  Under a mesh the cache's
        leaves are DTensors laid out as ``launch.specs`` lays them out, and
        each rank writes its own shard."""
        with sh.mesh_region():
            return self._decode_step(params, cache, tokens, policy,
                                     write_mask)

    def _decode_step(self, params, cache, tokens, policy, write_mask):
        _refuse_plain_cache(cache, "decode_step")
        cfg = self.cfg
        x = shard(_embed(params["embed"], tokens), "batch", None, None)
        B = x.shape[0]
        clen = cache.length
        lens = clen.expand(B) if clen.dim() == 0 else clen
        data = cache.data
        if cfg.family in _ATTN_FAMILIES:
            for i in range(cfg.n_layers):
                x = attn_block_decode(_layer(params["layers"], i), x,
                                      data["k"][i], data["v"][i], lens, cfg,
                                      ring=self.ring, policy=policy,
                                      write_mask=write_mask)
        else:
            app = 0
            for s, e, shared in self._segments():
                for i in range(s, e):
                    x = self._ssm_decode(_layer(params["layers"], i), x,
                                         data, i, write_mask)
                if shared:
                    x = attn_block_decode(params["shared_attn"], x,
                                          data["k"][app], data["v"][app],
                                          lens, cfg, ring=False,
                                          policy=policy,
                                          write_mask=write_mask)
                    app += 1
        # under a mesh, the unembed's input laid out by the batch (DTensor
        # otherwise gathers the batch and splits the contraction)
        x = shard(rmsnorm(params["final_norm"], x), "batch", None, None)
        logits = shard(unembed_apply(params["embed"], x, policy), "batch",
                       None, "tensor")
        return logits, DecodeCache(cache.data, clen + 1)

    # -------------------------------------------------------- prefill ------
    def _collect(self, params, tokens, policy, prefix_embeds=None,
                 frame_embeds=None, **kw):
        """One forward that returns what a prefill keeps: (logits, kv or
        None, states or None)."""
        fam = self.cfg.family
        out = self.apply(params, tokens, prefix_embeds=prefix_embeds,
                         frame_embeds=frame_embeds, policy=policy,
                         collect_kv=fam != "ssm",
                         collect_states=fam in ("ssm", "hybrid"), **kw)
        kv = out[2] if fam != "ssm" else None
        states = out[-1] if fam in ("ssm", "hybrid") else None
        return out[0], kv, self._decode_states(
            params, tokens, policy, states, prefix_embeds, frame_embeds)

    def prefill(self, params, tokens=None, *, prefix_embeds=None,
                frame_embeds=None, max_len: Optional[int] = None,
                policy=None):
        """Run the full prompt (``tokens``, or ``frame_embeds``, after any
        ``prefix_embeds``: ``apply``'s inputs), build a decode cache.
        Returns (last_logits (B,V), cache); the cache's length counts the
        prefix.  A ring cache shorter than the prompt keeps the prompt's
        tail, ring-aligned: position p at slot p % smax, where decode
        writes next."""
        with sh.mesh_region():
            return self._prefill(params, tokens, prefix_embeds, frame_embeds,
                                 max_len, policy)

    def _prefill(self, params, tokens, prefix_embeds, frame_embeds, max_len,
                 policy):
        logits, kv, states = self._collect(
            params, tokens, policy, prefix_embeds, frame_embeds,
            logits_last_only=True)
        B, S = (tokens if frame_embeds is None else frame_embeds).shape[:2]
        if prefix_embeds is not None:
            S += prefix_embeds.shape[1]
        if self.cfg.family == "ssm":  # the state does not grow with max_len
            cache = DecodeCache(dict(zip(("conv", "h"), states)), None)
            return logits[:, -1], self.cache_at_length(cache, S)
        cache = self.init_cache(B, max_len or S)
        data = cache.data
        # under a mesh kv and states are DTensors: the cache is built from
        # them, not written in place into the plain zeros
        meshed = sh.active() is not None
        if kv is not None:
            smax = data["k"].shape[2]
            for name, t in zip(("k", "v"), kv):
                if smax >= S and meshed:
                    data[name] = torch.cat([t, data[name][:, :, S:]], dim=2)
                elif smax >= S:
                    data[name][:, :, :S] = t
                elif meshed:
                    data[name] = torch.roll(t[:, :, S - smax:], S % smax,
                                            dims=2)
                else:
                    data[name].copy_(torch.roll(t[:, :, S - smax:], S % smax,
                                                dims=2))
        if states is not None and meshed:
            data["conv"], data["h"] = states
        elif states is not None:
            data["conv"].copy_(states[0])
            data["h"].copy_(states[1])
        return logits[:, -1], self.cache_at_length(cache, S)

    def prefill_batched(self, params, tokens, true_lens, *, policy=None):
        """Bucket-padded batched prefill for the serving engine.

        tokens: (M, Lb) right-padded to one bucket length; true_lens: (M,).
        Returns ``(last_logits (M, V), kv or None, states or None)``: k, v
        of shape (L or n_shared_applications, M, Lb, Hkv, D) and the ssm
        and hybrid families' (conv, h).  Right-padding is exact for causal
        attention: a pad never enters a valid position's context.  SSM
        state carries run through pads, so those families must be called
        with exact lengths (all ``true_lens == Lb``).  Runs in the phase
        scope ``model.prefill_batched`` (``tokens``: M x Lb)."""
        with scope("model.prefill_batched") as sc:
            if sc.on:
                sc.set(tokens=tokens.numel())
            true_lens = torch.as_tensor(true_lens, dtype=torch.int64,
                                        device=self.device)
            logits, kv, states = self._collect(params, tokens, policy,
                                               last_index=true_lens - 1)
            return logits[:, 0], kv, states

    def prefill_chunk(self, params, cache: DecodeCache, tokens, offsets,
                      chunk_lens, slot_ids, *, policy=None):
        """One chunk of a chunk-resumable prefill over M lanes of a batched
        decode cache (``cache.length`` per slot, (B,)).

        tokens: (M, Cb) right-padded chunk tokens; offsets: (M,) tokens
        already prefilled per lane; chunk_lens: (M,) valid tokens; slot_ids:
        (M,) cache lanes (out-of-range = pad lane, dropped by every
        scatter).  A pad lane reads the last lane, as the JAX package's
        gather clamps its index, and writes nothing; its row of
        ``last_logits`` is computed and has no meaning.  Returns
        ``(last_logits (M, V), cache)`` with the chunk's KV written at the
        offsets (ring-aligned on a ring) and the lane lengths advanced to
        ``offsets + chunk_lens``.  History is read back from the cache, so
        the cache dtype must equal the compute dtype.

        The ssm and hybrid families resume each lane from its conv/h
        carries (a lane with offset 0 starts from zeros, whatever the slot
        held) and write them back; their chunks must be exact length
        (``chunk_lens == Cb``: the conv carry is the raw chunk tail), and
        the prefill equals the monolithic one when every non-final boundary
        lands on a multiple of ``cfg.ssm_scan_chunk``.

        Under a mesh the cache's leaves are DTensors laid out as
        ``launch.specs`` lays them out: every rank gathers the picked lanes
        whole and runs the chunk's attention over all of them, and each
        rank writes its own shard back, so the cache keeps its layout."""
        with sh.mesh_region():
            return self._prefill_chunk(params, cache, tokens, offsets,
                                       chunk_lens, slot_ids, policy)

    def _prefill_chunk(self, params, cache, tokens, offsets, chunk_lens,
                       slot_ids, policy):
        _refuse_plain_cache(cache, "prefill_chunk")
        cfg, dev = self.cfg, self.device
        x = shard(_embed(params["embed"], tokens), "batch", None, None)
        M, Cb = tokens.shape
        offsets = torch.as_tensor(offsets, dtype=torch.int64, device=dev)
        chunk_lens = torch.as_tensor(chunk_lens, dtype=torch.int64,
                                     device=dev)
        slot_ids = torch.as_tensor(slot_ids, dtype=torch.int64, device=dev)
        positions = offsets[:, None] + torch.arange(Cb, device=dev)[None, :]
        data = cache.data
        # pad lanes read a clamped lane; rows: the real lanes, written at
        # their slots
        n_lanes = cache.length.shape[0]
        reads = slot_ids.clamp(max=n_lanes - 1)
        rows = torch.nonzero(slot_ids < n_lanes).flatten()
        slots = slot_ids[rows]

        def attend(p, x, i, ring):
            x, k2, v2 = _chunk_attn_block(
                p, x, _lanes(data["k"][i], reads, 0),
                _lanes(data["v"][i], reads, 0), offsets, chunk_lens,
                positions, cfg, ring=ring, policy=policy)
            _write_lanes(data["k"][i], k2[rows], slots, 0)
            _write_lanes(data["v"][i], v2[rows], slots, 0)
            return x

        if cfg.family in _ATTN_FAMILIES:
            for i in range(cfg.n_layers):
                lp = constrain_layer_params(_layer(params["layers"], i),
                                            cfg.n_experts)
                x = attend(lp, x, i, self.ring)
        else:
            fresh = offsets == 0
            lanes = []
            for name in ("conv", "h"):
                t = _lanes(data[name], reads, 1)
                lanes.append(t.masked_fill(
                    fresh.reshape((1, M) + (1,) * (t.dim() - 2)), 0))
            convs, hs, app = [], [], 0
            for s, e, shared in self._segments():
                x, (conv, h) = self._ssm_stack(params["layers"], x,
                                               states=lanes, start=s, end=e)
                convs.append(conv)
                hs.append(h)
                if shared:
                    x = attend(params["shared_attn"], x, app, False)
                    app += 1
            for name, new in (("conv", convs), ("h", hs)):
                _write_lanes(data[name], sh.full(torch.cat(new))[:, rows],
                             slots, 1)
        length = cache.length.clone()
        _write_lanes(length, (offsets + chunk_lens)[rows], slots, 0)
        # each lane's last valid position, picked from the whole x as a
        # plain tensor (the pick's advanced indexing stays off DTensors, as
        # the cache's does)
        x = sh.full(rmsnorm(params["final_norm"], x))
        x = shard(x[torch.arange(M, device=dev), chunk_lens - 1][:, None],
                  "batch", None, None)
        logits = shard(unembed_apply(params["embed"], x, policy), "batch",
                       None, "tensor")
        return logits[:, 0], DecodeCache(data, length)

    def prefill_chunked(self, params, tokens, chunk_size: int, *,
                        max_len: Optional[int] = None, policy=None):
        """The monolithic prefill built from ``prefill_chunk`` steps of
        ``chunk_size`` tokens.  tokens: (B, S) exact (no pads).  Returns
        ``(last_logits (B, V), cache)`` with per-lane lengths, equal to
        ``prefill``'s for any chunk size obeying the family's boundary
        contract (see ``prefill_chunk``).  Under a mesh the cache is laid
        out as ``launch.specs`` lays out a decode cache."""
        B, S = tokens.shape
        base = self.init_cache(B, max_len or S)
        cache = DecodeCache(base.data, torch.zeros(B, dtype=torch.int64,
                                                   device=self.device))
        ctx = sh.active()
        if ctx is not None:
            from repro_torch.launch.specs import _cache_specs
            cache = tree_util.map(
                lambda t, s: sh.redistribute(t, s.mesh, s.placements), cache,
                _cache_specs(self, cache, B, ctx))
        slot_ids = torch.arange(B, device=self.device)
        last = None
        for off in range(0, S, chunk_size):
            clen = min(chunk_size, S - off)
            last, cache = self.prefill_chunk(
                params, cache, tokens[:, off:off + clen],
                torch.full((B,), off), torch.full((B,), clen), slot_ids,
                policy=policy)
        return last, cache

    def decode_scan(self, params, cache: DecodeCache, tok, active, budget,
                    n_steps: int, *, pad_id: int = 0, policy=None,
                    stop_tokens: tuple = ()):
        """Greedy multi-token decode: ``n_steps`` decode_step + argmax
        iterations with no host sync.

        cache.length must be per-slot (B,); tok: (B, 1) next token per
        slot; active: (B,) bool gates which lanes sample/advance; budget:
        (B,) remaining tokens per slot.  Inactive lanes ride the batched
        step but keep their cache bits (a ring write or an ssm state is not
        masked by length), length, token and budget.  A lane
        deactivates when its budget hits zero or, with ``stop_tokens``,
        when it samples a stop token (which is still emitted).  Returns
        ``(cache, tok, active, budget, toks (n, B), emitted (n, B))``.
        Runs in the phase scope ``model.decode_scan`` (``tokens``: B x
        n_steps, the lanes' positions stepped, active or not)."""
        with scope("model.decode_scan") as sc:
            if sc.on:
                sc.set(tokens=tok.shape[0] * n_steps)
            return self._decode_scan(params, cache, tok, active, budget,
                                     n_steps, pad_id, policy, stop_tokens)

    def _decode_scan(self, params, cache, tok, active, budget, n_steps,
                     pad_id, policy, stop_tokens):
        stops = torch.tensor([int(s) for s in stop_tokens],
                             dtype=torch.int64, device=self.device)
        toks, emitted = [], []
        for _ in range(n_steps):
            logits, stepped = self.decode_step(params, cache, tok,
                                               policy=policy,
                                               write_mask=active)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            toks.append(torch.where(active, nxt, pad_id))
            emitted.append(active)
            budget = budget - active.to(budget.dtype)
            length = torch.where(active, stepped.length, cache.length)
            tok = torch.where(active[:, None], nxt[:, None], tok)
            new_active = active & (budget > 0)
            if len(stop_tokens):
                stopped = torch.isin(nxt, stops)
                new_active = new_active & ~(active & stopped)
            cache, active = DecodeCache(cache.data, length), new_active
        return (cache, tok, active, budget, torch.stack(toks),
                torch.stack(emitted))
