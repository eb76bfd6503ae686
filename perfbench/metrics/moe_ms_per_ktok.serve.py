"""Device milliseconds inside the program's ``moe`` scopes (every MoE
layer call, prefill and decode) per 1000 tokens routed through one MoE
layer (each call's ``tokens``, padding and inactive decode lanes
included), in the window."""
from perfbench.program_spans import window_scopes


def read(record):
    scopes = [sc for sc in window_scopes(record, "moe") or ()
              if sc.device_s is not None]
    tokens = sum(sc.attrs["tokens"] for sc in scopes)
    if not tokens:
        return None
    return 1e3 * sum(sc.device_s for sc in scopes) / (tokens / 1e3)
