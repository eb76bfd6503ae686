"""Per-device cost of one eager step, counted op by op (the port's
counterpart of ``repro.roofline.hlo_parse``, which counts the compiled HLO
text of the JAX package's step instead).

``count(fn, *args)`` runs ``fn(*args)`` under a ``TorchDispatchMode`` and
returns ``(out, OpCost)``, with every number per device (per rank), at the
shapes of each rank's local shards:

  * ``flops``: matmul-class ops only (mm, bmm, addmm, baddbmm, the einsums
    they lower to, convolutions), by ``torch.utils.flop_counter``'s
    formulas, as ``hlo_parse`` counts dot and convolution only;
  * ``traffic_bytes``: operand plus result bytes of every op that is not a
    view.  A gather reads and writes only its result (2x result bytes plus
    the indices), a scatter only its update (2x update bytes plus the
    indices), as ``hlo_parse`` counts dynamic-slice and
    dynamic-update-slice.  The port runs eagerly with no fusion, so this is
    the traffic the port moves, op by op: it is not XLA's fused traffic;
  * ``collective_bytes`` per XLA kind (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``), counted as
    XLA counts them, by the result's bytes: the functional collectives
    DTensor issues (``_c10d_functional.*``) and the ``c10d.*`` ones that
    ``models/moe_sharded.py`` and ``parallel/pipeline.py`` call.  A send
    and its receive are one permute: the received bytes count.
    ``wait_tensor`` counts nothing, as ``hlo_parse`` skips ``-done``.

DTensor ops are counted once, at the local level: the mode declines an op
on DTensors (``NotImplemented``), so DTensor runs it and the mode sees what
DTensor runs for it, each rank's local op and the collectives of any
redistribution.  Not counted: the ops DTensor runs on fake tensors of the
global shapes to propagate a sharding, and the index arithmetic its
redistribution planner runs to size strided shards (only when a plan is
not yet cached, so that counting them would make a count depend on what
the process ran before).

``torch.profiler.record_function`` scopes are tracked: the traffic of each
op and, for matmul-class ops, their operand and result bytes are also
added up per innermost scope (``scope_traffic``, ``scope_dot_bytes``), for
``fused_model``.  ``peak_live_bytes`` is the most bytes the step's own
allocations held at once (storages created during the step and still
alive).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict

import torch

#: each collective op the port issues: (XLA's collective kind, the
#: argument holding its result or None for the op's own output, the
#: argument it reads); a c10d op writes in place
_COLLECTIVES = {
    "_c10d_functional.all_reduce": ("all-reduce", None, 0),
    "_c10d_functional.all_reduce_": ("all-reduce", None, 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", None, 0),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", None, 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", None, 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", None, 0),
    "c10d.allreduce_": ("all-reduce", 0, 0),
    "c10d._allgather_base_": ("all-gather", 0, 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 0, 1),
    "c10d.alltoall_base_": ("all-to-all", 0, 1),
    "c10d.recv_": ("collective-permute", 0, None),
    # the receive of the same permute counts its bytes
    "c10d.send": ("collective-permute", None, 0),
}
#: ops that move no bytes: allocation, aliasing and bookkeeping
_NO_TRAFFIC = {"aten.empty", "aten.empty_strided", "aten.empty_like",
               "aten._unsafe_view", "aten.lift_fresh", "aten.detach",
               "aten.alias", "aten.set_", "aten.resize_",
               "aten._local_scalar_dense"}
#: reads only the gathered region: (name, index of the index argument)
_GATHERS = {"aten.index": 1, "aten.index_select": 2, "aten.gather": 2,
            "aten.embedding": 1, "aten.take_along_dim": 1}
#: writes only the update region: (name, update argument, index argument)
_SCATTERS = {"aten.index_put_": (2, 1), "aten.index_put": (2, 1),
             "aten._index_put_impl_": (2, 1), "aten.scatter_": (3, 2),
             "aten.scatter": (3, 2), "aten.index_copy_": (3, 2),
             "aten.index_copy": (3, 2)}
_SCOPE_ENTER = "profiler._record_function_enter_new"
_SCOPE_EXIT = "profiler._record_function_exit"


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    scope_traffic: Dict[str, float] = dataclasses.field(default_factory=dict)
    scope_dot_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    peak_live_bytes: float = 0.0

    def add(self, other: "OpCost", times: float = 1.0):
        self.flops += other.flops * times
        self.traffic_bytes += other.traffic_bytes * times
        for mine, theirs in ((self.collective_bytes, other.collective_bytes),
                             (self.scope_traffic, other.scope_traffic),
                             (self.scope_dot_bytes, other.scope_dot_bytes)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v * times
        self.peak_live_bytes = max(self.peak_live_bytes,
                                   other.peak_live_bytes)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(x):
    """The tensors in an op's argument or result, lists flattened."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _is_view(func) -> bool:
    """The op returns aliases of its inputs and writes none of them."""
    if func.is_view:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _name(func) -> str:
    return str(func._overloadpacket) if hasattr(func, "_overloadpacket") \
        else str(func)


#: DTensor's functions that size strided shards with tensor ops: (module,
#: owner attribute or None, function name)
_PLANNER = (("torch.distributed.tensor.placement_types", "_StridedShard",
             "local_shard_size_and_offset"),
            ("torch.distributed.tensor._utils", None,
             "_get_shard_size_and_offsets"))


@contextlib.contextmanager
def _planner_uncounted(counter):
    """While DTensor's planner functions run, ``counter.paused`` is set."""
    import importlib
    saved = []
    for mod_name, owner, name in _PLANNER:
        try:
            mod = importlib.import_module(mod_name)
        except ImportError:
            continue
        host = getattr(mod, owner) if owner else mod
        raw = host.__dict__.get(name) if owner else getattr(mod, name, None)
        if raw is None:
            continue
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw

        def paused(*a, _fn=fn, **k):
            counter.paused += 1
            try:
                return _fn(*a, **k)
            finally:
                counter.paused -= 1

        setattr(host, name, staticmethod(paused)
                if isinstance(raw, staticmethod) else paused)
        saved.append((host, name, raw))
    try:
        yield
    finally:
        for host, name, raw in saved:
            setattr(host, name, raw)


class _Counter(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self.scopes: list = []
        self.live = 0
        self.seen = weakref.WeakSet()
        self.paused = 0

    def _freed(self, nbytes):
        self.live -= nbytes

    def _track(self, out, inputs):
        """Add the storages ``out`` allocated (not those of ``inputs``,
        which an in-place op returns) to the live bytes."""
        held = {id(t.untyped_storage()) for t in inputs}
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self.seen or id(st) in held:
                continue
            self.seen.add(st)
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._freed, n)
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it: count what it runs
        out = func(*args, **kwargs)
        if self.paused:
            return out  # DTensor's redistribution planner
        from torch._subclasses.fake_tensor import FakeTensor
        if any(isinstance(t, FakeTensor)
               for t in _tensors(list(args)) + _tensors(out)):
            return out  # DTensor's sharding propagation
        name = _name(func)
        if name == _SCOPE_ENTER:
            self.scopes.append(args[0])
            return out
        if name == _SCOPE_EXIT:
            if self.scopes:
                self.scopes.pop()
            return out
        self._count(func, name, args, kwargs, out)
        return out

    def _count(self, func, name, args, kwargs, out):
        cost = self.cost
        if name in _COLLECTIVES:
            kind, res_arg, in_arg = _COLLECTIVES[name]
            if name == "c10d.send":
                res = 0
            elif res_arg is None:
                res = _nbytes(out)
                self._track(out, _tensors(list(args)))
            else:
                res = _nbytes(args[res_arg])
            cost.collective_bytes[kind] = \
                cost.collective_bytes.get(kind, 0) + res
            self._add_traffic(res + (0 if in_arg is None
                                     else _nbytes(args[in_arg])))
            return
        if _is_view(func) or name.startswith(
                ("profiler.", "c10d.", "_c10d_functional.")):
            return
        tensors_in = _tensors(list(args)) + _tensors(list(kwargs.values()))
        self._track(out, tensors_in)
        if name in _NO_TRAFFIC:
            return
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func._overloadpacket)
        if name in _GATHERS:
            idx = args[_GATHERS[name]] if len(args) > _GATHERS[name] else None
            t = 2 * _nbytes(out) + _nbytes(idx)
        elif name in _SCATTERS:
            upd, idx = _SCATTERS[name]
            t = 2 * _nbytes(args[upd]) + _nbytes(args[idx])
        else:
            # a tensor passed twice (x * x) is read once
            uniq = {id(t): t for t in tensors_in}
            t = _nbytes(list(uniq.values())) + _nbytes(out)
        self._add_traffic(t)
        if formula is not None:
            cost.flops += formula(*args, **kwargs, out_val=out)
            if self.scopes:
                s = self.scopes[-1]
                cost.scope_dot_bytes[s] = cost.scope_dot_bytes.get(s, 0) + t

    def _add_traffic(self, t):
        self.cost.traffic_bytes += t
        if self.scopes:
            s = self.scopes[-1]
            self.cost.scope_traffic[s] = self.cost.scope_traffic.get(s, 0) + t


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), OpCost)``: the call's per-device flops,
    traffic and collective bytes, counted op by op as it runs."""
    counter = _Counter()
    with _planner_uncounted(counter), counter:
        out = fn(*args, **kwargs)
    return out, counter.cost
