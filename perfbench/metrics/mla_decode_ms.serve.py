"""Device milliseconds inside the program's ``mla.decode`` scopes (every
layer's absorbed decode attention over the latent cache) per decode step,
summed over the layers: over the steps of the window's ``serve.decode``
scopes."""
from perfbench.program_spans import window_scopes


def read(record):
    scopes = [sc for sc in window_scopes(record, "mla.decode") or ()
              if sc.device_s is not None]
    steps = sum(sc.attrs["steps"]
                for sc in window_scopes(record, "serve.decode") or ())
    if not scopes or not steps:
        return None
    return 1e3 * sum(sc.device_s for sc in scopes) / steps
