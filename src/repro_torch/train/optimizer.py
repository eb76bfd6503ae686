"""AdamW with gradient clipping, a warmup-cosine schedule and optional int8
gradient compression with error feedback (counterpart of
``repro.train.optimizer``).

Moments are float32 whatever the parameters' dtype; each update is taken
in float32 and cast back.  Weight decay applies to leaves of two or more
dimensions, so the stacked (L, d) norm scales are decayed and
``final_norm`` is not, as in the JAX package.  The compression models a
compressed cross-pod gradient all-reduce: each leaf goes to int8 with a
per-tensor scale and keeps its rounding error as state added to the next
step's gradient, so the error does not accumulate as bias.

Where the JAX code computes on f32 arrays (``b1 ** count``, the schedule's
cosine), the port does so on f32 tensors, not in Python's float64.  The
port follows the JAX functions as they run op by op: every division is a
true division.  Inside ``jax.jit`` XLA turns a division by a constant into
a product with its f32 reciprocal and contracts some products and sums,
which moves the last bits of the jitted reference.  The functional update
returns new tensors and leaves the state it was given untouched.

On DTensor leaves (a sharded train state) every reduction is global: the
norm and each compressed leaf's max are taken over the whole tensor
(``full_tensor`` of the partial results), and the clip factor, the
learning rate and the bias corrections stay plain 0-d tensors, which
DTensor reads as replicated scalars.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.parallel import sharding as sh
from repro_torch.train import tree as tree_util

F32 = torch.float32


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor  # int32, 0-d
    err: Any  # error-feedback state ({} when compression is off)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    compress_grads: bool = False


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup over ``warmup_steps``, then a cosine from ``lr`` down
    to ``min_lr_frac * lr`` at ``total_steps``; f32 0-d at ``step``."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, the leaves summed
    in JAX's order; a plain tensor, each DTensor leaf's sum taken over its
    whole tensor."""
    return torch.sqrt(sum(sh.full(torch.sum(torch.square(leaf.to(F32))))
                          for leaf in tree_util.leaves(tree)))


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------
def _compress_leaf(g, e):
    gf = g.to(F32) + e
    scale = torch.clamp(sh.full(torch.max(torch.abs(gf))), min=1e-30) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(F32) * scale
    return deq, gf - deq  # the gradient sent, the new error state


def compress_grads(grads, err):
    """int8 error-feedback compression leaf by leaf: (sent, new err)."""
    outs = [_compress_leaf(g, e) for g, e in
            zip(tree_util.leaves(grads), tree_util.leaves(err))]
    return (tree_util.unflatten(grads, [o[0] for o in outs]),
            tree_util.unflatten(grads, [o[1] for o in outs]))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def init_state(params, cfg: AdamWConfig) -> AdamState:
    """Zero f32 moments (and error state with compression), count 0."""
    def zeros(p):  # a DTensor's keep its layout
        return torch.zeros_like(p, dtype=F32)

    device = tree_util.leaves(params)[0].device
    return AdamState(mu=tree_util.map(zeros, params),
                     nu=tree_util.map(zeros, params),
                     count=torch.zeros((), dtype=torch.int32, device=device),
                     err=(tree_util.map(zeros, params)
                          if cfg.compress_grads else {}))


def apply_updates(params, grads, state: AdamState, cfg: AdamWConfig
                  ) -> Tuple[Any, AdamState, Dict]:
    """One AdamW step.  Returns (new params, new state, {"grad_norm", "lr"})
    with the norm taken before clipping."""
    gnorm = global_norm(grads)
    # a tensor numerator: ``float / tensor`` is a reciprocal times the float
    clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                       / torch.clamp(gnorm, min=1e-9), max=1.0)
    grads = tree_util.map(lambda g: g.to(F32) * clip, grads)

    new_err = state.err
    if cfg.compress_grads:
        grads, new_err = compress_grads(grads, state.err)

    count = state.count + 1
    n = sh.full(count)
    lr = lr_schedule(cfg, n)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=n.device),
                        n.to(F32))
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=n.device),
                        n.to(F32))

    def upd(p, g, m, v):
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m2 / b1c
        vhat = v2 / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.to(F32)
        decay = cfg.weight_decay * pf if p.dim() >= 2 else 0.0
        p2 = pf - lr * (step + decay)
        return p2.to(p.dtype), m2, v2

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_util.leaves(params), tree_util.leaves(grads),
        tree_util.leaves(state.mu), tree_util.leaves(state.nu))]
    new_params = tree_util.unflatten(params, [o[0] for o in out])
    new_mu = tree_util.unflatten(params, [o[1] for o in out])
    new_nu = tree_util.unflatten(params, [o[2] for o in out])
    return new_params, AdamState(new_mu, new_nu, count, new_err), \
        {"grad_norm": gnorm, "lr": lr}
