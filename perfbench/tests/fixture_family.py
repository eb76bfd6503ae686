"""A fixture family for the tests: a configuration that spells its shapes
under keys of its own, with none of the dense family's (``head_dim``,
``intermediate_size``, ``block``), so the drivers reach its size only
through the family's ``model_flops`` and ``k1_forward_bound_s``.

The block it describes is one the port runs: ``dense_config`` writes it
as a dense configuration, and ``program``, ``make_weights`` and
``reference_logits`` are the dense family's on that.  The two counts are
this family's own, from ``CONFIG``'s keys.  A test registers the module as
``perfbench.families.fixture``.
"""
from __future__ import annotations

from perfbench.counting import matmul_bound_s
from perfbench.families import dense
from perfbench.reference import dense as reference

#: tiny widths: two kv heads of four query heads, half RoPE, swiglu
CONFIG = {
    "name": "fixture", "family": "fixture", "registry": "chatglm3-6b",
    "dtype": "bfloat16", "kv_cache_dtype": "bfloat16", "vocab_size": 256,
    "width": 64, "depth": 2, "norm_eps": 1e-6,
    "attention": {"query_heads": 4, "kv_heads": 2, "head_width": 16,
                  "rope": "half", "rope_base": 10000.0, "bias": True},
    "ffn": {"kind": "swiglu", "width": 96},
}


def dense_config(cfg: dict) -> dict:
    a, f = cfg["attention"], cfg["ffn"]
    return {
        "registry": cfg["registry"], "dtype": cfg["dtype"],
        "kv_cache_dtype": cfg["kv_cache_dtype"],
        "vocab_size": cfg["vocab_size"], "hidden_size": cfg["width"],
        "num_hidden_layers": cfg["depth"],
        "num_attention_heads": a["query_heads"],
        "num_key_value_heads": a["kv_heads"], "head_dim": a["head_width"],
        "intermediate_size": f["width"],
        "block": {"norm": "rmsnorm", "norm_eps": cfg["norm_eps"],
                  "rope": a["rope"], "rope_theta": a["rope_base"],
                  "mlp": f["kind"], "qkv_bias": a["bias"],
                  "tied_unembed": True}}


def program(cfg: dict, device):
    return dense.program(dense_config(cfg), device)


def make_weights(cfg: dict, seed: int, device):
    return dense.make_weights(dense_config(cfg), seed, device)


def reference_logits(cfg: dict, w, tokens, rows=None, fp8: bool = False):
    return reference.reference_logits(dense_config(cfg), w, tokens,
                                      rows=rows, fp8=fp8)


def matmuls(cfg: dict):
    """One block's (K, N) and the unembed's."""
    a, d, ff = cfg["attention"], cfg["width"], cfg["ffn"]["width"]
    q, kv = a["query_heads"] * a["head_width"], a["kv_heads"] * a[
        "head_width"]
    block = [(d, q), (d, kv), (d, kv), (q, d), (d, ff), (d, ff), (ff, d)]
    return block, (d, cfg["vocab_size"])


def model_flops(cfg: dict, tokens: int, pairs: int) -> float:
    block, unembed = matmuls(cfg)
    params = cfg["depth"] * sum(k * n for k, n in block) \
        + unembed[0] * unembed[1]
    a = cfg["attention"]
    return 2.0 * params * tokens \
        + 4.0 * a["query_heads"] * a["head_width"] * cfg["depth"] * pairs


def k1_forward_bound_s(cfg: dict, m: int) -> float:
    block, unembed = matmuls(cfg)
    return cfg["depth"] * sum(matmul_bound_s(m, k, n) for k, n in block) \
        + matmul_bound_s(m, *unembed)
