"""The share of the query positions through the program's ``attn`` scopes
that took the tensor-core kernel (``path`` "kernel", not the blockwise
"blocks"), in percent, over the traced window."""
from perfbench.program_spans import scopes


def read(record):
    found = scopes("attn") or ()
    positions = sum(sc.attrs["positions"] for sc in found)
    if not positions:
        return None
    return 100.0 * sum(sc.attrs["positions"] for sc in found
                       if sc.attrs["path"] == "kernel") / positions
