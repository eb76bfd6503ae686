"""Shape stand-ins and shardings for every production cell (counterpart of
``repro.launch.specs``).

``make_cell(arch, shape_name, ctx)`` returns what a cell runs without
allocating a real tensor: the step function, its arguments as ``meta``
tensors (JAX's ``eval_shape`` stand-ins) and their shardings.

  * train cells   -> (train_step, (TrainState, batch), shardings)
  * prefill cells -> (prefill_fn, (params, batch), shardings)
  * decode cells  -> (serve_step, (params, cache, tokens), shardings)

The shardings are ``parallel.sharding.NamedSharding`` leaves; with a
``MeshContext`` of sizes only their ``mesh`` is None and only the specs
are meant.  ``cfg=`` and ``shape=`` override the registry's config and
shape, and ``device=`` is where the cell's function runs (a reduced cell
run on a small mesh); the stand-ins are always ``meta``.  The decode cache's
length is int64 where the JAX package's is int32 (the port's cache
indices are int64 throughout).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeSpec, get_config
from repro_torch.models import LM
from repro_torch.parallel import sharding as sh
from repro_torch.train import tree as tree_util
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import make_train_state, make_train_step


class CellSpec(NamedTuple):
    fn: Any  # the step function
    arg_shapes: Tuple  # trees of meta tensors
    in_shardings: Tuple
    kind: str
    unit: str = ""  # chip FPU unit routed for this cell's execution phase


def _routed_unit(chip_policy, cfg: ArchConfig, shape: ShapeSpec) -> str:
    """Name of the chip unit the cell's phase routes to ('' without a chip)."""
    if chip_policy is None:
        return ""
    return chip_policy.unit_for_phase(
        shape.kind, precision=cfg.numerics_precision).name


def _sds(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch_shapes(cfg: ArchConfig, shape: ShapeSpec):
    b, s = shape.global_batch, shape.seq_len
    prefix = cfg.n_prefix_tokens if cfg.frontend == "vision" else 0
    s_text = s - prefix
    out: Dict[str, Any] = {}
    if cfg.frontend == "audio":
        out["frame_embeds"] = _sds((b, s, cfg.d_model), torch.float32)
        out["labels"] = _sds((b, s), torch.int32)
        return out
    out["tokens"] = _sds((b, s_text), torch.int32)
    out["labels"] = _sds((b, s_text), torch.int32)
    if prefix:
        out["prefix_embeds"] = _sds((b, prefix, cfg.d_model), torch.float32)
    return out


def _batch_specs(batch_shapes, ctx):
    def one(leaf):
        logical = ("batch",) + (None,) * (leaf.dim() - 1)
        return sh.NamedSharding(ctx.mesh, sh.spec_for(logical,
                                                      tuple(leaf.shape), ctx))
    return tree_util.map(one, batch_shapes)


def _cache_specs(model: LM, cache_shapes, batch: int, ctx):
    """Sharding for the decode cache (SP for B=1 long context)."""
    batch_ok = batch % ctx.batch_size_shards == 0

    def one(path, leaf):
        name = path.split("/")[-1]
        nd = leaf.dim()
        if nd == 0:
            return sh.NamedSharding(ctx.mesh, sh.P())
        if name in ("k", "v"):  # (L/apps, B, S, Hkv, D)
            heads_ok = leaf.shape[3] % ctx.tensor_size == 0
            if batch_ok and heads_ok:
                logical = (None, "batch", None, "tensor", None)
            elif batch_ok:
                # few KV heads (GQA): shard head_dim over the model axis, so
                # cache writes stay local and the contracted-D score product
                # sums only (B,H,S) scores per layer
                logical = (None, "batch", None, None, "tensor")
            else:
                logical = (None, None, "data", "tensor", None)
        elif name == "conv":  # (L, B, K-1, C)
            logical = (None, "batch" if batch_ok else None, None, "tensor")
        elif name == "h":  # (L,B,d_in,N) or (L,B,H,P,N)
            logical = (None, "batch" if batch_ok else None, "tensor") \
                + (None,) * (nd - 3)
        else:
            logical = (None,) * nd
        return sh.NamedSharding(ctx.mesh, sh.spec_for(logical,
                                                      tuple(leaf.shape), ctx))

    return tree_util.unflatten(cache_shapes, [
        one(p, leaf) for p, leaf in zip(tree_util.paths(cache_shapes),
                                        tree_util.leaves(cache_shapes))])


def make_cell(arch: str, shape_name: str, ctx: sh.MeshContext, *,
              opt_cfg: Optional[AdamWConfig] = None,
              microbatches: int = 1,
              triangle_skip: bool = False,
              chip_policy=None, cfg: Optional[ArchConfig] = None,
              shape: Optional[ShapeSpec] = None, device=None) -> CellSpec:
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    unit = _routed_unit(chip_policy, cfg, shape)
    meta = LM(cfg, device="meta")
    model = LM(cfg, device=device) if device is not None else meta
    opt_cfg = opt_cfg or AdamWConfig()

    param_shapes = meta.init(0)
    param_specs = sh.param_specs(param_shapes, cfg.n_experts, ctx)
    param_sh = sh.named_shardings(param_specs, ctx)

    if shape.kind == "train":
        state_shapes = make_train_state(meta, 0, opt_cfg)
        state_specs = sh.param_specs(state_shapes, cfg.n_experts, ctx)
        state_sh = sh.named_shardings(state_specs, ctx)
        batch_shapes = _batch_shapes(cfg, shape)
        batch_sh = _batch_specs(batch_shapes, ctx)
        step = make_train_step(model, opt_cfg, microbatches=microbatches,
                               grad_shardings=state_sh.params)
        return CellSpec(step, (state_shapes, batch_shapes),
                        (state_sh, batch_sh), "train", unit)

    if shape.kind == "prefill":
        batch_shapes = _batch_shapes(cfg, shape)
        batch_sh = _batch_specs(batch_shapes, ctx)

        def prefill_fn(params, batch):
            return model.prefill(
                params, batch.get("tokens"),
                prefix_embeds=batch.get("prefix_embeds"),
                frame_embeds=batch.get("frame_embeds"),
                max_len=shape.seq_len)

        return CellSpec(prefill_fn, (param_shapes, batch_shapes),
                        (param_sh, batch_sh), "prefill", unit)

    # decode: one new token against a cache of seq_len
    b = shape.global_batch
    cache_shapes = meta.init_cache(b, shape.seq_len)
    cache_sh = _cache_specs(meta, cache_shapes, b, ctx)
    tok_shape = _sds((b, 1), torch.int32)
    tok_sh = sh.NamedSharding(ctx.mesh,
                              sh.spec_for(("batch", None), (b, 1), ctx))

    def serve_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return CellSpec(serve_step, (param_shapes, cache_shapes, tok_shape),
                    (param_sh, cache_sh, tok_sh), "decode", unit)
