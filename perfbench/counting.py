"""The yardstick's arithmetic, frozen here: model FLOPs, K1's bound and the
card's peaks.  Everything is computed from a configuration file's
published shapes, never from the program's own counters, so it stays the
same whatever implements the model.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
"""
from __future__ import annotations

from typing import List, Tuple

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

#: the kernels of the port's ``csrc/qmm.cu`` (K1), by name
K1_KERNELS = ("qmm_tile_kernel", "qmm_rows_kernel", "qmm_fold_kernel",
              "scale_exp_kernel")


def is_k1(kernel_name: str) -> bool:
    return any(k in kernel_name for k in K1_KERNELS)


def projections(cfg: dict) -> List[Tuple[str, int, int]]:
    """One block's matmuls as (name, K, N) of its (M, K) @ (K, N)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    hq, hkv, ff = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["intermediate_size"])
    out = [("wq", d, hq * hd), ("wk", d, hkv * hd), ("wv", d, hkv * hd),
           ("wo", hq * hd, d)]
    if cfg["block"]["mlp"] == "swiglu":
        out += [("w_gate", d, ff), ("w_up", d, ff), ("w_down", ff, d)]
    else:
        out += [("w_up", d, ff), ("w_down", ff, d)]
    return out


def matmul_params(cfg: dict) -> int:
    """Matmul parameters a token passes through: every block's projections
    and the unembed (the embedding lookup is no matmul)."""
    per_layer = sum(k * n for _, k, n in projections(cfg))
    return cfg["num_hidden_layers"] * per_layer \
        + cfg["vocab_size"] * cfg["hidden_size"]


def causal_pairs(length: int) -> int:
    """(query, key) pairs of a causal pass over ``length`` positions."""
    return length * (length + 1) // 2


def model_flops(cfg: dict, tokens: int, pairs: int) -> float:
    """2 x matmul parameters per token processed, plus 4 Hq D per
    (query, key) pair per layer (q.k and p.v)."""
    return 2.0 * matmul_params(cfg) * tokens + 4.0 * cfg[
        "num_attention_heads"] * cfg["head_dim"] * cfg[
        "num_hidden_layers"] * pairs


def matmul_bound_s(m: int, k: int, n: int, a_bytes: int = 2,
                   b_bytes: int = 2, out_bytes: int = 4) -> float:
    """The least time of one (m, k) @ (k, n) on the card: each input read
    once and the output written once over HBM, against 2mkn at the bf16
    peak."""
    moved = m * k * a_bytes + k * n * b_bytes + m * n * out_bytes
    return max(moved / HBM_BYTES_PER_S, 2.0 * m * k * n / PEAK_BF16_FLOPS)


def k1_forward_bound_s(cfg: dict, m: int) -> float:
    """K1's bound over one emulated forward of ``m`` rows: every block's
    projections and the unembed, bf16 operands, f32 out."""
    per_layer = sum(matmul_bound_s(m, k, n) for _, k, n in projections(cfg))
    return cfg["num_hidden_layers"] * per_layer + matmul_bound_s(
        m, cfg["hidden_size"], cfg["vocab_size"])
