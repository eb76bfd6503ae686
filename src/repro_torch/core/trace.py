"""Dependency-trace extraction from the aten ops of a PyTorch function.
Counterpart of ``repro.core.trace``.

The paper measures average latency penalty on SPEC FP traces.  Our framework
equivalent: run a real model step, classify every FP op into dependency
structure, and compute the trace-weighted penalty a given FPU design would
incur.  A matrix product of contraction length K is an accumulation chain of
length K (distance-1 acc dependencies — the structure CMA forwarding
targets); elementwise FP ops are issue-independent.

Where the reference walks a jaxpr, the port records the aten ops a call
dispatches (a ``TorchDispatchMode``, below autograd, so ``linear``,
``matmul`` and ``einsum`` arrive as ``mm``/``addmm``/``bmm``).  Two
differences follow: a ``lax.scan`` body appears once in a jaxpr while eager
torch runs (and records) every iteration, and elementwise ops and softmax
decompose differently in jaxprs and aten (``jnp.mean`` is ``reduce_sum`` and
``div``, torch's is one ``mean``; torch's softmax is one ``_softmax``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.fpu_arch import FPUDesign
from repro_torch.core.latency_sim import chain_penalty

# products: the operand whose last dim is the contraction is args[_LHS[op]]
_DOT_OPS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "linear": 0,
            "addmm": 1, "baddbmm": 1}
_CONV_OPS = {"convolution"}
# jnp.sum/max/min/prod are reduce_* primitives; jnp.mean is reduce_sum + div
_REDUCE_OPS = {"sum", "amax", "amin", "prod", "mean"}
_ELEMWISE_FP = {
    "add", "sub", "rsub", "mul", "div", "exp", "log", "tanh", "sigmoid",
    "rsqrt", "sqrt", "maximum", "minimum", "pow", "erf", "neg",
}


@dataclasses.dataclass
class OpProfile:
    kind: str  # 'chain' (acc-dependent) or 'independent'
    chain_len: int  # accumulation chain length (1 for independent)
    flops: float  # weight


def _profile_op(name: str, args, out, profiles: List[OpProfile]) -> None:
    name = name[:-1] if name.endswith("_") and name[:-1] in _ELEMWISE_FP \
        else name
    if name in _DOT_OPS:
        k = int(args[_DOT_OPS[name]].shape[-1])
        profiles.append(OpProfile("chain", max(k, 1),
                                  2.0 * k * out.numel()))
    elif name in _CONV_OPS:
        w = args[1]  # (out_channels, in_channels / groups, *kernel)
        k = w.numel() // max(int(w.shape[0]), 1)
        profiles.append(OpProfile("chain", max(k, 1),
                                  2.0 * k * out.numel()))
    elif name in _REDUCE_OPS:
        in_size = args[0].numel()
        out_size = max(out.numel(), 1)
        profiles.append(OpProfile("chain", max(in_size // out_size, 1),
                                  float(in_size)))
    elif name in _ELEMWISE_FP and isinstance(out, torch.Tensor) \
            and out.is_floating_point():
        profiles.append(OpProfile("independent", 1, float(out.numel())))


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.profiles: List[OpProfile] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        _profile_op(func.overloadpacket.__name__, args, out, self.profiles)
        return out


def trace_penalty(design: FPUDesign, profiles: List[OpProfile]) -> float:
    """FLOP-weighted average latency penalty of a design on a profile."""
    num, den = 0.0, 0.0
    for p in profiles:
        pen = chain_penalty(design, p.chain_len) if p.kind == "chain" else 0.0
        num += pen * p.flops
        den += p.flops
    return num / max(den, 1.0)


def profile_fn(fn, *example_args, **kw) -> List[OpProfile]:
    """Run ``fn(*example_args, **kw)`` and profile the aten ops it
    dispatches, in order.  The call runs where its tensors live."""
    rec = _Recorder()
    with rec:
        fn(*example_args, **kw)
    return rec.profiles


def summarize(profiles: List[OpProfile]) -> Dict[str, float]:
    tot = sum(p.flops for p in profiles)
    chain = sum(p.flops for p in profiles if p.kind == "chain")
    lens = np.array([p.chain_len for p in profiles if p.kind == "chain"])
    wts = np.array([p.flops for p in profiles if p.kind == "chain"])
    mean_len = float((lens * wts).sum() / wts.sum()) if len(lens) else 0.0
    return dict(total_flops=tot, chain_flop_frac=chain / max(tot, 1.0),
                mean_chain_len=mean_len, n_ops=len(profiles))
