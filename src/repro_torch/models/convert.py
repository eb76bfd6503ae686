"""Parameters exported from the JAX package into the port.

The JAX ``LM.init`` draws with the JAX PRNG, which PyTorch cannot replay, so
parity tests export the reference's parameter tree (as numpy arrays) and
load it here: both packages then compute from the same weights.

Each leaf takes the dtype the reference's ``init`` gives it: ``cfg.dtype``
for most, float32 for the ssm family's ``dt_bias``, ``A_log`` and ``D``
(float32 even in a bfloat16 model).
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
    dt_rank = max(d // 16, 1)
    f32 = torch.float32
    return {"ln": {"scale": (L, d)}, "mamba": {
        "in_proj": (L, d, 2 * d_in), "conv_w": (L, cfg.ssm_conv, d_in),
        "conv_b": (L, d_in), "x_proj": (L, d_in, dt_rank + 2 * N),
        "dt_proj": (L, dt_rank, d_in), "dt_bias": ((L, d_in), f32),
        "A_log": ((L, d_in, N), f32), "D": ((L, d_in), f32),
        "out_proj": (L, d_in, d)}}


def _expected_shapes(cfg: ArchConfig) -> Dict:
    """The tree's keys with each leaf's shape, or (shape, dtype) where the
    leaf's dtype is not ``cfg.dtype``."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    if cfg.family == "ssm":
        return {"embed": (_pad_vocab(cfg.vocab_size), d),
                "final_norm": {"scale": (d,)}, "layers": _ssm_layers(cfg)}
    layers = {
        "ln1": {"scale": (L, d)}, "ln2": {"scale": (L, d)},
        "wq": (L, d, cfg.n_heads * hd), "wk": (L, d, cfg.n_kv_heads * hd),
        "wv": (L, d, cfg.n_kv_heads * hd), "wo": (L, cfg.n_heads * hd, d),
        "mlp": ({"w_gate": (L, d, cfg.d_ff), "w_up": (L, d, cfg.d_ff),
                 "w_down": (L, cfg.d_ff, d)} if cfg.mlp_act == "swiglu"
                else {"w_up": (L, d, cfg.d_ff), "w_down": (L, cfg.d_ff, d)}),
    }
    if cfg.qkv_bias:
        layers.update(bq=(L, cfg.n_heads * hd), bk=(L, cfg.n_kv_heads * hd),
                      bv=(L, cfg.n_kv_heads * hd))
    return {"embed": (_pad_vocab(cfg.vocab_size), d),
            "final_norm": {"scale": (d,)}, "layers": layers}


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
    """The JAX ``LM`` parameter tree of the dense or ssm family (stacked
    ``layers``, ``embed``, ``final_norm``; leaves as numpy arrays) as the
    port's parameters on ``device`` (default CUDA), each leaf in the dtype
    the reference gives it.  Keys and shapes are checked against ``cfg``."""
    return _convert(tree_of_numpy, _expected_shapes(cfg), _DTYPES[cfg.dtype],
                    resolve_device(device))
