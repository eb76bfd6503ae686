"""Device milliseconds inside the program's ``attn`` scopes (every layer's
full-sequence attention in a prefill, kernel or blockwise) per 1000 query
positions through one layer's attention (each scope's ``positions``, B x
Sq, padding included), in the window."""
from perfbench.program_spans import window_scopes


def read(record):
    timed = [sc for sc in window_scopes(record, "attn") or ()
             if sc.device_s is not None]
    positions = sum(sc.attrs["positions"] for sc in timed)
    if not positions:
        return None
    return 1e3 * sum(sc.device_s for sc in timed) / (positions / 1e3)
