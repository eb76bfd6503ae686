"""Parameters exported from the JAX package into the port.

The JAX ``LM.init`` draws with the JAX PRNG, which PyTorch cannot replay, so
parity tests export the reference's parameter tree (as numpy arrays) and
load it here: both packages then compute from the same weights.
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


def _expected_shapes(cfg: ArchConfig) -> Dict:
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
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
    if tuple(np.shape(tree)) != shapes:
        raise ValueError(f"params{path}: expected shape {shapes}, got "
                         f"{tuple(np.shape(tree))}")
    return _to_tensor(tree, dtype, device)


def params_from_jax(tree_of_numpy: Dict, cfg: ArchConfig,
                    device=None) -> Dict:
    """The JAX dense ``LM`` parameter tree (stacked ``layers``, ``embed``,
    ``final_norm``; leaves as numpy arrays) as the port's parameters, in
    ``cfg.dtype`` on ``device`` (default CUDA).  Keys and shapes are
    checked against ``cfg``."""
    return _convert(tree_of_numpy, _expected_shapes(cfg), _DTYPES[cfg.dtype],
                    resolve_device(device))
