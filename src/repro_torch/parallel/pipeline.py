"""Pipeline parallelism over one mesh axis (counterpart of
``repro.parallel.pipeline``).

GPipe: the layer stack is split into one stage per rank of the axis, and
microbatches stream through the stages, each tick's activations passed to
the next stage (``ppermute`` in the JAX package's ``shard_map``,
``batch_isend_irecv`` here).  The link between stages then carries only
(microbatch x d_model) activations per hop.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.train import tree as tree_util


def _stage_params(params, stage: int, n_stages: int):
    """This stage's slice of ``params`` (leading axis = stage): the local
    shard of a DTensor sharded over the axis, or row ``stage`` of a full
    tensor."""
    from torch.distributed.tensor import DTensor

    def one(a):
        if isinstance(a, DTensor):
            return a.to_local()[0]
        if a.shape[0] != n_stages:
            raise ValueError(f"stage params lead with {a.shape[0]} stages, "
                             f"not {n_stages}")
        return a[stage]

    return tree_util.map(one, params)


def pipeline_forward(stage_fn: Callable, n_stages: int, mesh,
                     axis: str = "pod"):
    """Build fn(stage_params, x_microbatches) -> y_microbatches.

    stage_params: leading axis = stage; each rank uses the slice of its own
    position on ``axis`` (``stage_fn(params, h)``).  x: (n_micro, mb, ...),
    the same full feed on every rank; stage 0 consumes it.  Schedule:
    ``n_micro + n_stages - 1`` ticks; at each tick every stage processes its
    resident microbatch, then sends it to stage ``(i + 1) % n_stages``.  The
    last stage's outputs are summed over the axis, so every rank returns
    them."""
    group = mesh.get_group(axis)
    if dist.get_world_size(group) != n_stages:
        raise ValueError(f"axis {axis!r} has {dist.get_world_size(group)} "
                         f"ranks for {n_stages} stages")

    def fn(stage_params, x):
        stage = dist.get_rank(group)
        params = _stage_params(stage_params, stage, n_stages)
        n_micro = x.shape[0]
        total = n_micro + n_stages - 1
        state = torch.zeros_like(x[0])
        outputs = torch.zeros_like(x)
        nxt_rank = dist.get_global_rank(group, (stage + 1) % n_stages)
        prev_rank = dist.get_global_rank(group, (stage - 1) % n_stages)
        for t in range(total):
            # stage 0 ingests microbatch t (if in range)
            cur = x[min(t, n_micro - 1)] if stage == 0 else state
            out = stage_fn(params, cur)
            # the last stage writes the result for microbatch t - S + 1
            out_idx = t - (n_stages - 1)
            if stage == n_stages - 1 and out_idx >= 0:
                outputs[out_idx] = out
            # shift activations to the next stage
            if n_stages == 1:
                state = out
                continue
            recv = torch.empty_like(out)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out.contiguous(), nxt_rank, group),
                dist.P2POp(dist.irecv, recv, prev_rank, group)])
            for r in reqs:
                r.wait()
            state = recv
        # all-reduce so every stage holds the final outputs
        if stage != n_stages - 1:
            outputs.zero_()
        dist.all_reduce(outputs, group=group)
        return outputs

    return fn
