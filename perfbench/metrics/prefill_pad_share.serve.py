"""The share of the prefill's positions that are bucket padding, in
percent: the program's ``serve.prefill`` scopes' padded tokens over their
rows x bucket, in the window."""
from perfbench.program_spans import window_scopes


def read(record):
    scopes = window_scopes(record, "serve.prefill") or ()
    positions = sum(sc.attrs["rows"] * sc.attrs["bucket"] for sc in scopes)
    if not positions:
        return None
    return 100.0 * sum(sc.attrs["padded_tokens"] for sc in scopes) \
        / positions
