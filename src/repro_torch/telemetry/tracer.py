"""Tracing hooks of the port (counterpart of ``repro.telemetry.tracer``):
the event vocabulary and the disabled tracer the engine defaults to.

Every instrumentation site in the engine is guarded by
``if tracer.enabled:``; a recording tracer with the JAX package's data
model arrives with the telemetry slice.
"""
from __future__ import annotations


class Event:
    """Typed event vocabulary (string constants)."""

    ADMIT = "admit"                    # accepted by submit(), queued
    SEAT = "seat"                      # placed into a device lane
    PREFILL = "prefill"                # monolithic batched prefill
    PREFILL_CHUNK = "prefill_chunk"    # one chunked-prefill advance
    DECODE_DISPATCH = "decode_dispatch"  # tokens committed at a boundary
    FINISH = "finish"
    EXPIRE = "expire"
    REJECT = "reject"                  # structured admission reject


class NullTracer:
    """The disabled tracer: every hook is a no-op and ``enabled`` is False
    so instrumentation sites can skip even argument construction."""

    enabled = False

    def request_begin(self, uid, t, **attrs):
        return None

    def event(self, uid, type, t, **attrs):
        return None

    def begin_attempt(self, uid, t, site="", fleet="", **attrs):
        return None

    def end_attempt(self, uid, t, status="ok"):
        return None

    def end_request(self, uid, t, status="ok"):
        return None


#: the process-wide disabled tracer every engine defaults to
NULL_TRACER = NullTracer()
