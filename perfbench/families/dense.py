"""The dense decoder family: the program's model for a configuration
file, the weights made from the seed, (from ``perfbench.reference``) the
plain float32 reference, and (from ``perfbench.counting``) model FLOPs
and K1's bound from the file's dense shapes."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from perfbench.counting import k1_forward_bound_s, model_flops  # noqa: F401
from perfbench.generate import torch_seed
from perfbench.reference.dense import reference_logits  # noqa: F401

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: the port's ArchConfig field of each configuration key
_PORT_FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
                "num_attention_heads": "n_heads",
                "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
                "intermediate_size": "d_ff", "vocab_size": "vocab_size",
                "dtype": "dtype"}
_PORT_MLP = {"gelu_tanh": "gelu", "swiglu": "swiglu"}


# ---------------------------------------------------------------- program
def port_config(cfg: dict):
    """The port's ArchConfig for ``cfg``: its registry entry with every
    number of the file put in, so the program runs what the file states."""
    from repro_torch.configs.base import get_config
    blk = cfg["block"]
    kw = {f: cfg[k] for k, f in _PORT_FIELDS.items()}
    kw.update(mlp_act=_PORT_MLP[blk["mlp"]], rope_style=blk["rope"],
              rope_theta=float(blk["rope_theta"]), qkv_bias=blk["qkv_bias"],
              kv_cache_dtype=cfg["kv_cache_dtype"], window=0)
    return dataclasses.replace(get_config(cfg["registry"]), **kw)


def program(cfg: dict, device):
    """The port's ``LM`` for ``cfg`` on ``device``."""
    from repro_torch.models import LM
    pc = port_config(cfg)
    if pc.family != "dense":
        raise ValueError(f"{cfg['registry']} is not a dense model")
    return LM(pc, device=device)


# ---------------------------------------------------------------- weights
def make_weights(cfg: dict, seed: int, device) -> Dict:
    """Random weights from ``seed`` on ``device`` in the served dtype, one
    draw per leaf over all layers, laid out as the port's parameter tree:
    projections ~ N(0, 1/fan_in), embedding ~ N(0, 0.02^2), norm scales
    1 + N(0, 0.1^2), qkv biases ~ N(0, 0.05^2)."""
    dt = _DTYPES[cfg["dtype"]]
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 3))
    L, d, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    hd, hq, hkv = (cfg["head_dim"], cfg["num_attention_heads"],
                   cfg["num_key_value_heads"])
    ff = cfg["intermediate_size"]

    def draw(shape, std, mean=0.0):
        t = torch.randn(shape, generator=g, device=device, dtype=dt)
        t.mul_(std)
        return t.add_(mean) if mean else t

    def proj(k, n):
        return draw((L, k, n), k ** -0.5)

    layers = {"ln1": {"scale": draw((L, d), 0.1, 1.0)},
              "wq": proj(d, hq * hd), "wk": proj(d, hkv * hd),
              "wv": proj(d, hkv * hd), "wo": proj(hq * hd, d),
              "ln2": {"scale": draw((L, d), 0.1, 1.0)}}
    if cfg["block"]["qkv_bias"]:
        layers.update(bq=draw((L, hq * hd), 0.05),
                      bk=draw((L, hkv * hd), 0.05),
                      bv=draw((L, hkv * hd), 0.05))
    if cfg["block"]["mlp"] == "swiglu":
        layers["mlp"] = {"w_gate": proj(d, ff), "w_up": proj(d, ff),
                         "w_down": proj(ff, d)}
    else:
        layers["mlp"] = {"w_up": proj(d, ff), "w_down": proj(ff, d)}
    return {"embed": draw((V, d), 0.02),
            "final_norm": {"scale": draw((d,), 0.1, 1.0)},
            "layers": layers}
