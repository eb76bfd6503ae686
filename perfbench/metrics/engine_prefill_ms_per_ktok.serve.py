"""Host milliseconds inside the program's ``serve.prefill`` scopes (the
model call, the K/V scatter, the lanes' arming and the first-token fetch)
per 1000 real prompt tokens, in the window."""
from perfbench.program_spans import window_scopes


def read(record):
    scopes = window_scopes(record, "serve.prefill") or ()
    tokens = sum(sc.attrs["real_tokens"] for sc in scopes)
    if not tokens:
        return None
    return 1e3 * sum(sc.host_s for sc in scopes) / (tokens / 1e3)
