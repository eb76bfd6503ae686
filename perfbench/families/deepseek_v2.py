"""The DeepSeek-V2 family (DeepSeek-V2-Lite): the program's model for a
configuration file, the weights made from the seed, (from
``perfbench.reference``) the plain float32 reference, and the model FLOPs
from the file's published shapes.  No ``k1_forward_bound_s``: the family
has no eval cell."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from perfbench.generate import torch_seed
from perfbench.reference.deepseek_v2 import reference_logits  # noqa: F401

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: the port's ArchConfig field of each configuration key
_PORT_FIELDS = {
    "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff", "vocab_size": "vocab_size",
    "moe_intermediate_size": "moe_d_ff", "n_routed_experts": "n_experts",
    "n_shared_experts": "n_shared_experts",
    "num_experts_per_tok": "experts_per_token",
    "first_k_dense_replace": "n_dense_layers",
    "norm_topk_prob": "norm_topk_prob",
    "routed_scaling_factor": "routed_scaling_factor",
    "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_head_dim",
    "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
    "rope_theta": "rope_theta", "dtype": "dtype",
    "kv_cache_dtype": "kv_cache_dtype"}
_YARN_FIELDS = {"factor": "yarn_factor",
                "original_max_position_embeddings": "yarn_original_max_len",
                "beta_fast": "yarn_beta_fast", "beta_slow": "yarn_beta_slow",
                "mscale": "yarn_mscale",
                "mscale_all_dim": "yarn_mscale_all_dim"}
#: what the file may state and the program runs only this way
_FIXED = {"attention_bias": False, "hidden_act": "silu", "q_lora_rank": None,
          "scoring_func": "softmax", "topk_method": "greedy",
          "moe_layer_freq": 1, "n_group": 1, "topk_group": 1}


# ---------------------------------------------------------------- program
def port_config(cfg: dict):
    """The port's ArchConfig for ``cfg``: its registry entry with every
    number of the file put in, so the program runs what the file states,
    routing dropless."""
    from repro_torch.configs.base import get_config
    for k, want in _FIXED.items():
        if cfg.get(k, want) != want:
            raise ValueError(f"the port runs {k} = {want!r}, the file "
                             f"states {cfg[k]!r}")
    kw = {f: cfg[k] for k, f in _PORT_FIELDS.items()}
    rs = cfg.get("rope_scaling") or {}
    if rs and rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling {rs.get('type')!r} is not yarn")
    kw.update({f: rs[k] for k, f in _YARN_FIELDS.items() if rs})
    return dataclasses.replace(get_config(cfg["registry"]), **kw,
                               moe_dropless=True, window=0)


def program(cfg: dict, device):
    """The port's ``LM`` for ``cfg`` on ``device``."""
    from repro_torch.models import LM
    pc = port_config(cfg)
    if pc.family != "moe" or not pc.is_mla:
        raise ValueError(f"{cfg['registry']} is not an MLA MoE model")
    return LM(pc, device=device)


# ---------------------------------------------------------------- weights
def make_weights(cfg: dict, seed: int, device) -> Dict:
    """Random weights from ``seed`` on ``device`` in the served dtype (the
    router in float32), one draw per leaf over all layers, laid out as the
    port's parameter tree: projections, experts and router ~ N(0,
    1/fan_in), embedding ~ N(0, 0.02^2), norm scales 1 + N(0, 0.1^2)."""
    dt = _DTYPES[cfg["dtype"]]
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 3))
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, R, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    E, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    nd = cfg["first_k_dense_replace"]

    def draw(shape, std, mean=0.0, dtype=dt):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        t.mul_(std)
        return t.add_(mean) if mean else t

    def proj(lead, k, n, dtype=dt):
        return draw(lead + (k, n), k ** -0.5, dtype=dtype)

    def block(L, ffn):
        lead = (L,)
        return {"ln1": {"scale": draw(lead + (d,), 0.1, 1.0)},
                "wq": proj(lead, d, H * (nope + R)),
                "wkv_a": proj(lead, d, r + R),
                "kv_norm": {"scale": draw(lead + (r,), 0.1, 1.0)},
                "wkv_b": proj(lead, r, H * (nope + v)),
                "wo": proj(lead, H * v, d),
                "ln2": {"scale": draw(lead + (d,), 0.1, 1.0)}, **ffn(lead)}

    def mlp(lead, width):
        return {"w_gate": proj(lead, d, width), "w_up": proj(lead, d, width),
                "w_down": proj(lead, width, d)}

    def moe(lead):
        return {"moe": {
            "router": proj(lead, d, E, dtype=torch.float32),
            **mlp(lead + (E,), f),
            "shared": mlp(lead, cfg["n_shared_experts"] * f)}}

    out = {"embed": draw((V, d), 0.02),
           "final_norm": {"scale": draw((d,), 0.1, 1.0)},
           "layers": block(cfg["num_hidden_layers"] - nd, moe)}
    if nd:
        out["dense_layers"] = block(nd, lambda lead: {
            "mlp": mlp(lead, cfg["intermediate_size"])})
    return out


# ----------------------------------------------------------------- counts
def matmul_params(cfg: dict) -> int:
    """Matmul parameters a token passes through, from the published shapes
    in the non-absorbed form: every layer's MLA projections, the leading
    dense MLPs, each MoE layer's router, shared experts and
    ``num_experts_per_tok`` routed ones, and the unembed."""
    d, H, r = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["kv_lora_rank"])
    nope, R, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    L, nd = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    attn = d * H * (nope + R) + d * (r + R) + r * H * (nope + v) + H * v * d
    experts = cfg["num_experts_per_tok"] + cfg["n_shared_experts"]
    moe = experts * 3 * d * cfg["moe_intermediate_size"] \
        + d * cfg["n_routed_experts"]
    return L * attn + nd * 3 * d * cfg["intermediate_size"] \
        + (L - nd) * moe + cfg["vocab_size"] * d


def model_flops(cfg: dict, tokens: int, pairs: int) -> float:
    """2 x matmul parameters per token processed, plus 2 H (nope + R) (q.k)
    + 2 H v (p.v) per causal (query, key) pair per layer."""
    H = cfg["num_attention_heads"]
    per_pair = 2 * H * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) \
        + 2 * H * cfg["v_head_dim"]
    return 2.0 * matmul_params(cfg) * tokens \
        + float(per_pair) * cfg["num_hidden_layers"] * pairs
