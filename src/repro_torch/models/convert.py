"""Parameters (and a train state) exported from the JAX package into the
port.

The JAX ``LM.init`` draws with the JAX PRNG, which PyTorch cannot replay, so
parity tests export the reference's parameter tree (as numpy arrays) and
load it here: both packages then compute from the same weights.

Each leaf takes the dtype the reference's ``init`` gives it: ``cfg.dtype``
for most, float32 for the Mamba blocks' ``dt_bias``, ``A_log`` and ``D``
and the MoE router (float32 even in a bfloat16 model).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import _DTYPES, _pad_vocab


def _to_tensor(arr, dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype)


def _ssm_layers(cfg: ArchConfig) -> Dict:
    d, L, N = cfg.d_model, cfg.n_layers, cfg.ssm_state
    d_in = cfg.ssm_expand * d
    f32 = torch.float32
    if cfg.ssm_version == 1:
        dt_rank = max(d // 16, 1)
        mamba = {
            "in_proj": (L, d, 2 * d_in), "conv_w": (L, cfg.ssm_conv, d_in),
            "conv_b": (L, d_in), "x_proj": (L, d_in, dt_rank + 2 * N),
            "dt_proj": (L, dt_rank, d_in), "dt_bias": ((L, d_in), f32),
            "A_log": ((L, d_in, N), f32), "D": ((L, d_in), f32),
            "out_proj": (L, d_in, d)}
    else:
        H, conv_c = d_in // cfg.ssm_head_dim, d_in + 2 * N
        mamba = {
            "in_proj": (L, d, 2 * d_in + 2 * N + H),
            "conv_w": (L, cfg.ssm_conv, conv_c), "conv_b": (L, conv_c),
            "A_log": ((L, H), f32), "dt_bias": ((L, H), f32),
            "D": ((L, H), f32), "norm": {"scale": (L, d_in)},
            "out_proj": (L, d_in, d)}
    return {"ln": {"scale": (L, d)}, "mamba": mamba}


def _attn_block(cfg: ArchConfig, lead) -> Dict:
    """One attention block's leaves, each with the leading ``lead``."""
    d, hd, q, kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def s(*shape, dtype=None):
        return (lead + shape, dtype) if dtype else lead + shape

    block = {"ln1": {"scale": s(d)}, "ln2": {"scale": s(d)},
             "wq": s(d, q * hd), "wk": s(d, kv * hd), "wv": s(d, kv * hd),
             "wo": s(q * hd, d)}
    if cfg.qkv_bias:
        block.update(bq=s(q * hd), bk=s(kv * hd), bv=s(kv * hd))
    if cfg.family == "moe":
        E, f = cfg.n_experts, cfg.moe_d_ff
        moe = {"router": s(d, E, dtype=torch.float32),
               "w_gate": s(E, d, f), "w_up": s(E, d, f),
               "w_down": s(E, f, d)}
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * f
            moe["shared"] = {"w_gate": s(d, fs), "w_up": s(d, fs),
                             "w_down": s(fs, d)}
        block["moe"] = moe
    elif cfg.mlp_act == "swiglu":
        block["mlp"] = {"w_gate": s(d, cfg.d_ff), "w_up": s(d, cfg.d_ff),
                        "w_down": s(cfg.d_ff, d)}
    else:
        block["mlp"] = {"w_up": s(d, cfg.d_ff), "w_down": s(cfg.d_ff, d)}
    return block


def _expected_shapes(cfg: ArchConfig) -> Dict:
    """The tree's keys with each leaf's shape, or (shape, dtype) where the
    leaf's dtype is not ``cfg.dtype``."""
    tree = {"embed": (_pad_vocab(cfg.vocab_size), cfg.d_model),
            "final_norm": {"scale": (cfg.d_model,)}}
    if cfg.family in ("ssm", "hybrid"):
        tree["layers"] = _ssm_layers(cfg)
    else:
        tree["layers"] = _attn_block(cfg, (cfg.n_layers,))
    if cfg.family == "hybrid":
        tree["shared_attn"] = _attn_block(cfg, ())
    return tree


def _convert(tree, shapes, dtype, device, path=""):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"params{path}: expected keys {sorted(shapes)}, "
                             f"got {got}")
        return {k: _convert(tree[k], shapes[k], dtype, device, f"{path}.{k}")
                for k in shapes}
    if isinstance(shapes[-1], torch.dtype):
        shapes, dtype = shapes
    if tuple(np.shape(tree)) != shapes:
        raise ValueError(f"params{path}: expected shape {shapes}, got "
                         f"{tuple(np.shape(tree))}")
    return _to_tensor(tree, dtype, device)


def params_from_jax(tree_of_numpy: Dict, cfg: ArchConfig,
                    device=None) -> Dict:
    """The JAX ``LM`` parameter tree of any family (stacked ``layers``,
    ``embed``, ``final_norm``, the hybrid's ``shared_attn``; the vlm and
    audio families' trees are the dense one's, with internvl2's qkv biases
    and musicgen's two-matrix gelu MLP; leaves as numpy arrays) as the
    port's parameters on ``device`` (default CUDA), each leaf in the dtype
    the reference gives it.  Keys and shapes are checked against ``cfg``."""
    return _convert(tree_of_numpy, _expected_shapes(cfg), _DTYPES[cfg.dtype],
                    resolve_device(device))


def train_state_from_jax(state_numpy, cfg: ArchConfig, device=None):
    """A JAX ``TrainState`` (params, AdamState(mu, nu, count, err), step),
    its leaves as numpy arrays, as the port's ``TrainState`` on ``device``
    (default CUDA): the params through ``params_from_jax``, the moments
    and any error-feedback state in float32 with the params' keys and
    shapes, ``count`` and ``step`` as int32 0-d tensors.  Both packages
    then start a step from the same state."""
    from repro_torch.train.optimizer import AdamState
    from repro_torch.train.train_loop import TrainState
    dev = resolve_device(device)
    params_np, opt, step = state_numpy
    mu, nu, count, err = opt
    shapes = _expected_shapes(cfg)

    def moments(tree):
        return _convert(tree, _all_f32(shapes), torch.float32, dev)

    def scalar(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=dev)

    return TrainState(params_from_jax(params_np, cfg, dev),
                      AdamState(moments(mu), moments(nu), scalar(count),
                                moments(err) if err else {}),
                      scalar(step))


def _all_f32(shapes):
    """``shapes`` with every leaf marked float32."""
    if isinstance(shapes, dict):
        return {k: _all_f32(v) for k, v in shapes.items()}
    if isinstance(shapes[-1], torch.dtype):
        shapes = shapes[0]
    return (shapes, torch.float32)
