"""Telemetry of the port (counterpart of ``repro.telemetry``): span
tracing, metric timelines, exporters and trace-derived workload profiles.

The core (``Tracer``/``Span``/``Event``/``NULL_TRACER``) imports only the
standard library, so every serving layer can import it; the profile
functions import the tuner stack on first use.
"""
from repro_torch.telemetry.export import (coerce_tracer, load_jsonl,
                                          to_chrome_trace,
                                          write_chrome_trace, write_jsonl)
from repro_torch.telemetry.profile import (MIN_ACTIVITY, TraceSummary,
                                           phases_from_trace,
                                           profile_from_trace,
                                           summarize_trace)
from repro_torch.telemetry.tracer import (NULL_TRACER, Event, NullTracer,
                                          Span, Tracer)

__all__ = [
    "Event", "NullTracer", "NULL_TRACER", "Span", "Tracer",
    "coerce_tracer", "load_jsonl", "to_chrome_trace", "write_chrome_trace",
    "write_jsonl",
    "MIN_ACTIVITY", "TraceSummary", "phases_from_trace",
    "profile_from_trace", "summarize_trace",
]
