"""Sharding rules: logical-axis -> mesh-axis mapping for every parameter and
activation (counterpart of ``repro.parallel.sharding``).

Strategy (production mesh (pod=2,) data=16, model=16):
  * batch            -> ('pod', 'data')   (DP across pods by default)
  * d_model (embed)  -> 'data'            (FSDP/ZeRO-3 parameter shard)
  * heads/ffn/vocab  -> 'model'           (Megatron TP)
  * experts          -> 'data' (EP when E % data == 0), else the expert
                        weights shard d over 'data' and ffn over 'model'
  * long KV seq      -> 'data'            (SP for B=1 long-context decode)

The rules are name+rank based over the param tree; a dimension its mesh
axis does not divide is replicated (never uneven sharding).  ``_resolve``
and ``param_specs`` are pure functions of the mesh's ``{axis: size}``, so
a ``MeshContext`` may hold only the sizes (``make_context({"data": 4,
"model": 2})``); placing tensors needs a ``DeviceMesh``.

The JAX package's ``PartitionSpec`` is ``P`` here, ``NamedSharding`` pairs
a ``DeviceMesh`` with one, and ``placements`` turns a spec into DTensor
placements, one per mesh dim: a tensor dim sharded over several axes
(``batch -> ('pod', 'data')``) is ``Shard(d)`` on each of them, major to
minor in mesh order, so rank r holds the slice JAX's device r holds.
``shard`` (a ``with_sharding_constraint`` there) redistributes a DTensor,
and returns its argument itself when no mesh is active.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from typing import Dict, Optional, Tuple

import torch

from repro_torch.train import tree as tree_util


class P:
    """A partition spec: per tensor dim, ``None`` (replicated), a mesh axis
    name, or a tuple of names (major to minor); a tuple of one name is that
    name, as JAX normalises it.  A leaf of a tree (it is not a tuple, so
    ``train.tree`` does not descend into it)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e
        self.entries = tuple(norm(e) for e in entries)

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __iter__(self):
        return iter(self.entries)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self.entries)) + ")"


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis: size}`` in mesh order, of a ``DeviceMesh`` or of such a
    dict itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass
class MeshContext:
    axes: Dict[str, int]  # mesh axis -> size, in mesh order
    batch_axes: Tuple[str, ...]  # ('pod','data') or ('data',)
    fsdp_axis: Optional[str] = "data"
    tensor_axis: str = "model"
    mesh: object = None  # the DeviceMesh (None: sizes only)

    @property
    def tensor_size(self) -> int:
        return self.axes.get(self.tensor_axis, 1)

    @property
    def fsdp_size(self) -> int:
        return self.axes[self.fsdp_axis] if self.fsdp_axis else 1

    @property
    def batch_size_shards(self) -> int:
        return math.prod(self.axes[a] for a in self.batch_axes)


_ACTIVE: list = []


def make_context(mesh, *, fsdp: bool = True) -> MeshContext:
    """The context of a ``DeviceMesh``, or of ``{axis: size}`` alone."""
    axes = mesh_axes(mesh)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    return MeshContext(axes=axes, batch_axes=batch,
                       fsdp_axis="data" if fsdp and "data" in axes else None,
                       tensor_axis="model",
                       mesh=None if isinstance(mesh, dict) else mesh)


@contextlib.contextmanager
def use_mesh(ctx: Optional[MeshContext]):
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


def active() -> Optional[MeshContext]:
    return _ACTIVE[-1] if _ACTIVE else None


# ---------------------------------------------------------------------------
# Logical axis resolution
# ---------------------------------------------------------------------------
def _resolve(ctx: MeshContext, logical: Tuple, shape: Tuple[int, ...]) -> P:
    """Map logical axis names to mesh axes, dropping non-divisible shards."""
    out = []
    for ax_name, dim in zip(logical, shape):
        if ax_name is None:
            out.append(None)
            continue
        if ax_name == "batch":
            axes = list(ctx.batch_axes)
            total = math.prod(ctx.axes[a] for a in axes) or 1
            out.append(tuple(axes) if axes and dim % total == 0 else None)
            continue
        mesh_ax = {"fsdp": ctx.fsdp_axis, "tensor": ctx.tensor_axis,
                   "data": "data"}.get(ax_name, ax_name)
        if mesh_ax is None or mesh_ax not in ctx.axes:
            out.append(None)
        elif dim % ctx.axes[mesh_ax] == 0:
            out.append(mesh_ax)
        else:
            out.append(None)
    return P(*out)


def spec_for(logical: Tuple, shape: Tuple[int, ...],
             ctx: Optional[MeshContext] = None) -> P:
    ctx = ctx or active()
    if ctx is None:
        return P()
    return _resolve(ctx, logical, shape)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` or its
    ``{axis: size}``): ``Shard(d)`` on each mesh dim of more than one rank
    that tensor dim d is sharded over, ``Replicate()`` on the others (a
    shard over one rank is the whole tensor, and DTensor's rules in torch
    2.11 refuse to flatten a dim sharded even over one rank)."""
    from torch.distributed.tensor import Replicate, Shard
    axes = mesh_axes(mesh)
    names = list(axes)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a)
               for a in (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes of one dim must follow the "
                             f"mesh order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards "
                                 "two dims")
            if axes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


class NamedSharding:
    """A spec on a ``DeviceMesh`` (JAX's ``NamedSharding``); a leaf of a
    tree, like ``P``."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    def __repr__(self):
        return f"NamedSharding({self.spec})"

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def is_dtensor(x) -> bool:
    # no DTensor exists before its module is imported; importing it here
    # would cost every unsharded caller a second
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def full(x):
    """The global value of a DTensor on every rank (a collective); any
    other value as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def redistribute(x, mesh, pl):
    """``x`` as a DTensor on ``mesh`` with placements ``pl``.  A plain
    tensor is taken to hold the full value on every rank (as the batch and
    the model's own positions and masks do)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(mesh, pl)


def to_local(x, mesh, spec: P, partial_axes=()):
    """This rank's shard of ``x`` laid out by ``spec``, for per-rank code
    (a ``shard_map`` body's operand).  Its gradient comes back as the
    shard's own, or as a partial sum on the mesh axes in ``partial_axes``
    over which ``x`` is replicated (each rank there used it on other
    tokens)."""
    from torch.distributed.tensor import Partial, Replicate
    pl = placements(spec, mesh)
    names = list(mesh_axes(mesh))
    grad = tuple(Partial() if names[i] in partial_axes
                 and isinstance(p, Replicate) else p
                 for i, p in enumerate(pl))
    return redistribute(x, mesh, pl).to_local(grad_placements=grad)


def from_local(t, mesh, spec: P = P()):
    """Per-rank results as one DTensor laid out by ``spec`` (a value the
    same on every rank as a replicated one, whose gradient then comes back
    as a plain tensor)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements(spec, mesh),
                              run_check=False)


def shard(x, *logical):
    """``x`` redistributed to the layout of ``logical`` when a mesh context
    is active, else ``x`` itself."""
    ctx = active()
    if ctx is None:
        return x
    if ctx.mesh is None:
        raise ValueError("shard() under a MeshContext without a DeviceMesh")
    spec = _resolve(ctx, logical, tuple(x.shape))
    return redistribute(x, ctx.mesh, placements(spec, ctx.mesh))


class _GradTo(torch.autograd.Function):
    """The identity, whose gradient is redistributed to ``pl`` on ``mesh``."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.mesh, ctx.pl = mesh, pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return redistribute(g, ctx.mesh, ctx.pl), None, None


def grad_to(x, *logical):
    """``x`` itself, whose gradient is redistributed to the layout of
    ``logical`` on its way back when a mesh context is active (where
    DTensor's rule for the op that made ``x`` would otherwise pick a
    costlier backward); ``x`` itself without a mesh."""
    ctx = active()
    if ctx is None:
        return x
    spec = _resolve(ctx, logical, tuple(x.shape))
    return _GradTo.apply(x, ctx.mesh, placements(spec, ctx.mesh))


_IN_REGION: list = []


@contextlib.contextmanager
def mesh_region(ctx: Optional[MeshContext] = None):
    """A region in which plain tensors meet DTensors as replicated values
    (``implicit_replication``) while a mesh is active (or ``ctx`` is
    given): the model's own positions, masks and ``arange``s, the batch
    and 0-d scalars hold the same full value on every rank.  Re-entrant
    (``implicit_replication`` itself clears its flag on any exit); a no-op
    without a mesh."""
    if (ctx or active()) is None or _IN_REGION:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _IN_REGION.append(True)
    try:
        with implicit_replication():
            yield
    finally:
        _IN_REGION.pop()


def tensor_size() -> int:
    """Model-axis size of the active mesh (1 when unmeshed)."""
    ctx = active()
    return ctx.tensor_size if ctx is not None else 1


# ---------------------------------------------------------------------------
# Parameter sharding rules (by leaf name + rank)
# ---------------------------------------------------------------------------
# name -> logical axes for the *unstacked* (per-layer) rank
_PARAM_RULES = {
    "embed": ("tensor", "fsdp"),
    "unembed": ("tensor", "fsdp"),
    "wq": ("fsdp", "tensor"),
    "wk": ("fsdp", "tensor"),
    "wv": ("fsdp", "tensor"),
    "wo": ("tensor", "fsdp"),
    "bq": ("tensor",),
    "bk": ("tensor",),
    "bv": ("tensor",),
    "w_gate": ("fsdp", "tensor"),
    "w_up": ("fsdp", "tensor"),
    "w_down": ("tensor", "fsdp"),
    "router": (None, None),  # replicated: shard_map routing needs full d
    "in_proj": ("fsdp", "tensor"),
    "out_proj": ("tensor", "fsdp"),
    "x_proj": ("tensor", None),
    "dt_proj": (None, "tensor"),
    "conv_w": (None, "tensor"),
    "conv_b": ("tensor",),
    "dt_bias": ("tensor",),
    "A_log": ("tensor", None),
    "A_log_1d": ("tensor",),
    "D": ("tensor",),
    "scale": (None,),
}
# rank-3 MoE expert tensors (layouts consumed by models/moe_sharded.py):
# EP (E % data == 0): experts over the data axis, ffn dim over model.
_MOE_EP_RULES = {
    "w_gate": ("data", None, "tensor"),
    "w_up": ("data", None, "tensor"),
    "w_down": ("data", "tensor", None),
}
# TP-MoE (mixtral): d over data (ZeRO-3 gather-on-use), ffn over model.
_MOE_TP_RULES = {
    "w_gate": (None, "data", "tensor"),
    "w_up": (None, "data", "tensor"),
    "w_down": (None, "tensor", "data"),
}


def _leaf_rule(path_names, leaf_ndim, n_experts, ctx):
    name = path_names[-1]
    if name in ("w_gate", "w_up", "w_down") and leaf_ndim >= 3 \
            and "shared" not in path_names and n_experts:
        ep = n_experts % ctx.axes.get("data", 1) == 0
        rules = _MOE_EP_RULES if ep else _MOE_TP_RULES
        rule = rules[name]
    elif name == "A_log" and leaf_ndim <= 2:
        rule = _PARAM_RULES["A_log"] if leaf_ndim >= 2 \
            else _PARAM_RULES["A_log_1d"]
    elif name in _PARAM_RULES:
        rule = _PARAM_RULES[name]
    else:
        return None  # replicate
    # stacked layer dim(s): pad rule with leading None
    extra = leaf_ndim - len(rule)
    if extra > 0:
        rule = (None,) * extra + tuple(rule)
    elif extra < 0:
        rule = tuple(rule[-leaf_ndim:]) if leaf_ndim else ()
    return rule


def _named_leaves(tree):
    """(path names, leaf) of each leaf in JAX's order."""
    return [(tuple(p.split("/")), leaf) for p, leaf in
            zip(tree_util.paths(tree), tree_util.leaves(tree))]


def constrain_layer_params(layer_params, n_experts: int = 0):
    """Each leaf of a per-layer param slice redistributed to its rule's
    layout when a mesh is active (the JAX package pins the layer's weight
    gradients' sharding this way); the slice itself otherwise."""
    ctx = active()
    if ctx is None:
        return layer_params
    out = []
    for names, leaf in _named_leaves(layer_params):
        rule = _leaf_rule(names, leaf.dim(), n_experts, ctx)
        if rule is not None:
            spec = _resolve(ctx, rule, tuple(leaf.shape))
            leaf = redistribute(leaf, ctx.mesh, placements(spec, ctx.mesh))
        out.append(leaf)
    return tree_util.unflatten(layer_params, out)


def param_specs(params, n_experts: int = 0,
                ctx: Optional[MeshContext] = None):
    """Tree of ``P`` matching a params (or train state) tree."""
    ctx = ctx or active()
    out = []
    for names, leaf in _named_leaves(params):
        rule = None if ctx is None else _leaf_rule(names, leaf.dim(),
                                                   n_experts, ctx)
        out.append(P() if rule is None
                   else _resolve(ctx, rule, tuple(leaf.shape)))
    return tree_util.unflatten(params, out)


def named_shardings(specs, ctx: Optional[MeshContext] = None):
    ctx = ctx or active()
    return tree_util.map(lambda s: NamedSharding(ctx.mesh, s), specs)


def distribute_tree(tree, specs, ctx: Optional[MeshContext] = None):
    """Each leaf of ``tree`` as a DTensor laid out by its spec (JAX's
    ``device_put`` onto ``named_shardings``).  Every rank must hold the
    same full tree: each keeps its own slice, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    ctx = ctx or active()
    return tree_util.map(
        lambda leaf, spec: distribute_tensor(
            leaf, ctx.mesh, placements(spec, ctx.mesh), src_data_rank=None),
        tree, specs)
