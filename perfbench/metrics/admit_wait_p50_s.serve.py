"""The median wait of a request from its submission to the start of its
first prefill, on the engine's clock: the ``waited_s`` of the program's
``serve.prefill`` scopes in the window."""
import statistics

from perfbench.program_spans import window_scopes


def read(record):
    waits = [w for sc in window_scopes(record, "serve.prefill") or ()
             for w in sc.attrs.get("waited_s", ())]
    return statistics.median(waits) if waits else None
