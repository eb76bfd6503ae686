"""Distributed MoE dispatch: the expert-parallel path over a mesh
(counterpart of ``repro.models.moe_sharded``).

The single-program dispatch (``moe.py``) sorts over every token of the
call.  Here routing, capacity and the sort run per rank on its own batch
shard, and only the dispatched expert buffers move:

  * **EP** (n_experts % data == 0): the expert weights are sharded over
    'data'; an ``all_to_all`` over 'data' sends each expert's rows to the
    rank that holds it, ``(E, C, d) -> (E/D, D*C, d)``, and a second one
    brings the outputs back;
  * the expert FFN is column/row-parallel over 'model'; the row-parallel
    down-projection is summed over 'model' (``all_reduce``);
  * **TP** (otherwise, mixtral's 8 experts on a wider 'data' axis): every
    rank keeps all experts and gathers the d-shard of their weights over
    'data' on use (ZeRO-3).

The JAX function is a ``shard_map`` body; the port runs the same per-rank
code on each rank's local shards (``DTensor.to_local``) with explicit
``torch.distributed`` collectives, each an autograd function with the
collective's transpose as its backward.  The aux loss and the dropped
share are averaged over 'data'.  The shared experts run on the global
tensors outside.

Weight layouts are those of ``parallel/sharding.py``:
  EP : w_gate/w_up (E,d,f) = P('data', None, 'model'); w_down = P('data','model',None)
  TP : w_gate/w_up (E,d,f) = P(None, 'data', 'model'); w_down = P(None,'model','data')
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.moe import _expert_ffn, combine, moe_apply, route
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import P
from repro_torch.train import tree as tree_util


# ---------------------------------------------------------------------------
# Collectives with their transposes as backward
# ---------------------------------------------------------------------------
class _AllToAll(torch.autograd.Function):
    """Equal-split ``all_to_all`` along dim 0 (rank i's chunk j goes to rank
    j's slot i); it is its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _SumOver(torch.autograd.Function):
    """``psum``: the sum over the group, used identically on every rank,
    so its gradient is the output's, unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradSumOver(torch.autograd.Function):
    """The identity on an input every rank of the group holds whole, whose
    uses on the ranks each give part of its gradient: the backward sums
    them (Megatron's ``f`` before a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherOver(torch.autograd.Function):
    """``all_gather(tiled=True)`` along ``dim``; the backward sums each
    rank's gradient of the whole and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        ctx.rank = dist.get_rank(group)
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * moved.shape[0],) + moved.shape[1:],
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, moved, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, dim=ctx.dim)[ctx.rank], None, None


class _MeanOver(torch.autograd.Function):
    """``pmean`` of a value used identically on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


# ---------------------------------------------------------------------------
# Per-rank pieces
# ---------------------------------------------------------------------------
def _local_dispatch(xf, router, top_k, capacity_factor):
    """Local routing + sort-based dispatch of xf (T, d): the (E, C, d)
    buffer, the routing, and the local aux loss and dropped share."""
    T, d = xf.shape
    E = router.shape[1]
    # the capacity of the local tokens, by the JAX formula with its
    # rounding up to a multiple of 128 from 128 on: it decides which
    # entries drop
    r = route(router, xf, top_k=top_k, capacity_factor=capacity_factor)
    gathered = xf[r.tok] * r.keep[:, None].to(xf.dtype)
    xbuf = torch.zeros((E * r.cap, d), dtype=xf.dtype, device=xf.device)
    xbuf = xbuf.index_put((r.slot,), gathered, accumulate=True)
    # one-hot by a comparison, the same ops on every device (F.one_hot
    # checks its indices on some devices only, so that the ops counted on
    # meta stand-ins would not be the ones the card runs)
    top1 = r.top_i[:, 0, None] == torch.arange(E, device=r.top_i.device)
    frac_tokens = top1.to(torch.float32).mean(dim=0)
    aux = E * torch.sum(frac_tokens * r.probs.mean(dim=0))
    dropped = torch.sum(1.0 - r.keep.to(torch.float32)) * (1.0 / (T * top_k))
    return xbuf.reshape(E, r.cap, d), r, aux, dropped


def _local_combine(ybuf, r, T, d):
    w_sorted = r.top_w.reshape(-1)[r.order]
    y_slot = ybuf.reshape(-1, d)[r.slot] * (
        r.keep.to(torch.float32) * w_sorted)[:, None].to(ybuf.dtype)
    return combine(y_slot, r, T)


def _moe_apply_replicated(p, x, *, top_k: int, capacity_factor: float):
    """``moe_apply`` under a mesh, every operand gathered to ``Replicate``
    and the layer run whole on each rank: its ``argsort`` and
    ``index_put_(accumulate=True)`` have no DTensor sharding rule.  Returns
    (out, aux) as replicated DTensors."""
    mesh = sh.active().mesh
    leaves = [sh.to_local(t, mesh, P()) for t in tree_util.leaves(p)]
    out, aux = moe_apply(tree_util.unflatten(p, leaves),
                         sh.to_local(x, mesh, P()), top_k=top_k,
                         capacity_factor=capacity_factor)
    return sh.from_local(out, mesh), {k: sh.from_local(v, mesh)
                                      for k, v in aux.items()}


def moe_apply_distributed(p, x, *, top_k: int, capacity_factor: float,
                          ctx: sh.MeshContext) -> Tuple[torch.Tensor, Dict]:
    """x: (B,S,d) global (batch-sharded). Returns (out, aux): out a DTensor
    sharded over the batch axes, aux's ``aux_loss`` and ``dropped_frac``
    replicated 0-d DTensors (each the mean over its 'data' group)."""
    mesh = ctx.mesh
    E = p["router"].shape[1]
    d_size = ctx.axes["data"]
    m_axis = ctx.tensor_axis
    ep = E % d_size == 0
    B, S, d = x.shape
    if B % ctx.batch_size_shards:
        # tiny-batch decode (e.g. long-context B=1): the token count is
        # trivial, use the single-program dispatch on every rank
        return _moe_apply_replicated(p, x, top_k=top_k,
                                     capacity_factor=capacity_factor)
    batch = ctx.batch_axes
    batch_spec = P(tuple(batch), None, None)
    if ep:
        w_spec = dict(wg=P("data", None, m_axis), wu=P("data", None, m_axis),
                      wd=P("data", m_axis, None))
    else:
        w_spec = dict(wg=P(None, "data", m_axis), wu=P(None, "data", m_axis),
                      wd=P(None, m_axis, "data"))
    g_data, g_model = mesh.get_group("data"), mesh.get_group(m_axis)

    wg = sh.to_local(p["w_gate"], mesh, w_spec["wg"], batch)
    wu = sh.to_local(p["w_up"], mesh, w_spec["wu"], batch)
    wd = sh.to_local(p["w_down"], mesh, w_spec["wd"], batch)
    router = sh.to_local(p["router"], mesh, P(None, None), batch)
    xl = sh.to_local(x, mesh, batch_spec)
    bl, sl, _ = xl.shape
    xbuf, r, aux, dropped = _local_dispatch(xl.reshape(bl * sl, d), router,
                                            top_k, capacity_factor)
    cap = xbuf.shape[1]
    if ep:
        # (E, C, d) -> (E/D, D*C, d): experts to their owning data shard
        e_loc = E // d_size
        xbuf = _AllToAll.apply(xbuf.reshape(d_size, e_loc, cap, d), g_data)
        xbuf = xbuf.permute(1, 0, 2, 3).reshape(e_loc, d_size * cap, d)
        xbuf = _GradSumOver.apply(xbuf, g_model)
        ybuf = _expert_ffn({"w_gate": wg, "w_up": wu, "w_down": wd}, xbuf)
        ybuf = _SumOver.apply(ybuf, g_model)  # row-parallel down-proj
        ybuf = ybuf.reshape(e_loc, d_size, cap, d).permute(1, 0, 2, 3)
        ybuf = _AllToAll.apply(ybuf.contiguous(), g_data).reshape(E, cap, d)
    else:
        # ZeRO-3: gather the d-shard of expert weights on use
        wg_full = _GatherOver.apply(wg, g_data, 1)
        wu_full = _GatherOver.apply(wu, g_data, 1)
        wd_full = _GatherOver.apply(wd, g_data, 2)
        xbuf = _GradSumOver.apply(xbuf, g_model)
        ybuf = _expert_ffn({"w_gate": wg_full, "w_up": wu_full,
                            "w_down": wd_full}, xbuf)
        ybuf = _SumOver.apply(ybuf, g_model)
    out = _local_combine(ybuf, r, bl * sl, d).reshape(bl, sl, d)
    aux = sh.from_local(_MeanOver.apply(aux, g_data), mesh)
    dropped = sh.from_local(_MeanOver.apply(dropped, g_data), mesh)
    out = sh.from_local(out, mesh, batch_spec)

    if "shared" in p:
        sp = p["shared"]
        # the shared experts run on the global tensors (x may be plain)
        # (under a mesh, their input gathered over the model axis and the
        # down projection's gradient gathered over it on the way back, the
        # Megatron layout GSPMD picks: DTensor's own choices replicate the
        # shared experts over 'model')
        with sh.mesh_region(ctx):
            xf = sh.shard(x, "batch", None, None).reshape(-1, d)
            g = xf @ sp["w_gate"]
            u = xf @ sp["w_up"]
            h = F.silu(g.to(torch.float32)).to(x.dtype) * u
            y = sh.grad_to(h @ sp["w_down"], "batch", None)
            out = out + y.reshape(B, S, d)

    return out, {"aux_loss": aux, "dropped_frac": dropped}
