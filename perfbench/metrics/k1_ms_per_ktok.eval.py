"""K1's device milliseconds (the kernels of the port's ``csrc/qmm.cu``)
per 1000 scored tokens, over the traced window."""
from perfbench.counting import is_k1


def read(record):
    prof = record.get("profile")
    if not prof:
        return None
    k1 = sum(s for name, s in prof["kernels"].items() if is_k1(name))
    if k1 <= 0 or not prof.get("scored_tokens"):
        return None
    return 1e3 * k1 / (prof["scored_tokens"] / 1e3)
