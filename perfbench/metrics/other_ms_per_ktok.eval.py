"""Device milliseconds outside K1 (the float32 blockwise attention,
norms, RoPE, casts, scoring) per 1000 scored tokens, over the traced
window."""
from perfbench.counting import is_k1


def read(record):
    prof = record.get("profile")
    if not prof or prof["busy_s"] <= 0 or not prof.get("scored_tokens"):
        return None
    other = sum(s for name, s in prof["kernels"].items() if not is_k1(name))
    return 1e3 * other / (prof["scored_tokens"] / 1e3)
