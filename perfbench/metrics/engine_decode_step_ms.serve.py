"""Host milliseconds inside the program's ``serve.decode`` scopes (the
fused decode dispatch through its token fetch) per decode step, in the
window."""
from perfbench.program_spans import window_scopes


def read(record):
    scopes = window_scopes(record, "serve.decode") or ()
    steps = sum(sc.attrs["steps"] for sc in scopes)
    if not steps:
        return None
    return 1e3 * sum(sc.host_s for sc in scopes) / steps
