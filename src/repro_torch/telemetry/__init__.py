"""Telemetry of the port (this slice: the tracer hooks the engine calls)."""
from repro_torch.telemetry.tracer import NULL_TRACER, Event, NullTracer  # noqa: F401
