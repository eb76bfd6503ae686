"""K1's share of its roofline over the traced window: the forwards'
projections and unembed, each bounded by max(bytes / 3.35 TB/s,
2MKN / 989 TFLOP/s) from the configuration's published shapes, over K1's
device time, in percent."""
from perfbench.counting import is_k1


def read(record):
    prof = record.get("profile")
    if not prof:
        return None
    k1 = sum(s for name, s in prof["kernels"].items() if is_k1(name))
    if k1 <= 0 or not prof.get("forwards"):
        return None
    return 100.0 * prof["forwards"] * record["k1_bound_s_per_forward"] / k1
