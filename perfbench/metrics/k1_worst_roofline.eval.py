"""K1's share of its roofline on its furthest shape, in percent: the
program's ``k1`` scopes over the traced window grouped by (nb x m, k, n),
each group's bound (``counting.matmul_bound_s``, bf16 operands and f32
out, per call) over its device time between the scopes' CUDA events; the
lowest group."""
from perfbench.counting import matmul_bound_s
from perfbench.program_spans import scopes


def read(record):
    bound, device = {}, {}
    for sc in scopes("k1") or ():
        if sc.device_s is None:
            continue
        a = sc.attrs
        shape = (a["nb"] * a["m"], a["k"], a["n"])
        bound[shape] = bound.get(shape, 0.0) + matmul_bound_s(*shape)
        device[shape] = device.get(shape, 0.0) + sc.device_s
    shares = [100.0 * bound[s] / device[s] for s in bound if device[s] > 0]
    return min(shares) if shares else None
