"""The train step: loss, gradients and the AdamW update, with microbatched
gradient accumulation, and the host loop that runs it (counterpart of
``repro.train.train_loop``).

The JAX package differentiates ``LM.loss_fn`` with ``jax.value_and_grad``
and runs the step under ``jax.jit`` with the state donated; the port takes
the gradients with ``torch.autograd.grad`` over the parameter leaves and
runs eagerly.  Nothing here launches a kernel of K1-K6 unless a numerics
policy routes the model's matmuls to them, and on the card those kernels
have no backward: training under an emulating policy raises there
(``kernels._build.NoBackwardError``), as the JAX package's Pallas kernels
have no differentiation rule.

Under a mesh (``parallel.sharding.use_mesh``) the state's leaves are
DTensors laid out by ``param_specs``: the forward and backward run in the
mesh region, ``grad_shardings`` redistributes each gradient to its layout
before AdamW, and the metrics come back as plain tensors, the same on
every rank.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.parallel import sharding as sh
from repro_torch.train import tree as tree_util
from repro_torch.train.optimizer import (AdamState, AdamWConfig,
                                         apply_updates, init_state)


class TrainState(NamedTuple):
    params: Any
    opt: AdamState
    step: torch.Tensor  # int32, 0-d


def make_train_state(model, seed: int, opt_cfg: AdamWConfig) -> TrainState:
    """Parameters from ``model.init(seed)`` (on the model's device), zero
    moments, step 0."""
    params = model.init(seed)
    return TrainState(params, init_state(params, opt_cfg),
                      torch.zeros((), dtype=torch.int32,
                                  device=model.device))


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    policy=None, grad_shardings=None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``microbatches`` > 1 splits the batch on axis 0 and sums the gradients
    in f32 zeros, then divides by ``microbatches``, as does the loss; the
    per-microbatch metrics are dropped on that path (the metrics hold only
    ``grad_norm``, ``lr`` and ``loss``), as in the JAX package.
    ``grad_shardings``: a tree of ``parallel.sharding.NamedSharding`` like
    the params; each gradient is redistributed to its sharding before the
    update (the JAX package pins them with a sharding constraint)."""
    def grads_of(params, batch):
        leaves = tree_util.leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad(), sh.mesh_region():
            loss, metrics = model.loss_fn(tree_util.unflatten(params, live),
                                          batch, policy=policy)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if grad_shardings is not None:
            grads = [sh.redistribute(g, s.mesh, s.placements) for g, s in
                     zip(grads, tree_util.leaves(grad_shardings))]
        return (sh.full(loss.detach()),
                {k: sh.full(v.detach()) for k, v in metrics.items()},
                tree_util.unflatten(params, grads))

    def accumulate(params, batch):
        def split(x, i):
            n = x.shape[0] // microbatches
            return x[i * n:(i + 1) * n]

        acc = tree_util.map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tree_util.leaves(params)[0].device)
        for i in range(microbatches):
            loss, _, grads = grads_of(
                params, {k: split(v, i) for k, v in batch.items()})
            acc = tree_util.map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        grads = tree_util.map(lambda g: g / microbatches, acc)
        return loss_sum / microbatches, {}, grads

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if microbatches > 1:
            loss, metrics, grads = accumulate(state.params, batch)
        else:
            loss, metrics, grads = grads_of(state.params, batch)
        with torch.no_grad():
            params, opt, opt_metrics = apply_updates(state.params, grads,
                                                      state.opt, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def train_loop(model, state: TrainState, train_step, data_iter, *,
               n_steps: int, log_every: int = 10,
               checkpoint_manager=None, checkpoint_every: int = 0,
               telemetry=None, failure_hook=None):
    """Run ``train_step`` from ``state.step`` to ``n_steps`` on
    ``data_iter(step)``'s batches.  Every ``log_every`` steps (and at the
    last) a row of the metrics as floats, with ``step`` and anything
    ``telemetry(row)`` adds, goes into the history; every
    ``checkpoint_every`` steps the state goes to ``checkpoint_manager``.
    ``failure_hook(step)`` runs before each step (fault injection).
    Returns (state, history)."""
    history = []
    step0 = int(state.step)
    for i in range(step0, n_steps):
        if failure_hook is not None:
            failure_hook(i)
        batch = data_iter(i)
        state, metrics = train_step(state, batch)
        if (i + 1) % log_every == 0 or i + 1 == n_steps:
            # keys sorted, as the jitted reference step returns them
            row = {k: float(metrics[k]) for k in sorted(metrics)}
            row["step"] = i + 1
            if telemetry is not None:
                row.update(telemetry(row))
            history.append(row)
        if checkpoint_manager is not None and checkpoint_every \
                and (i + 1) % checkpoint_every == 0:
            checkpoint_manager.save(int(state.step), state)
    return state, history
