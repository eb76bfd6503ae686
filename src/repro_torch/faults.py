"""Serving fault vocabulary of the port (counterpart of ``repro.faults``):
what the engine raises.  Fault kinds, injection and schedules arrive with
the resilience slice."""


class UnitFault(RuntimeError):
    """Unit-scoped serving fault surfaced to a caller that cannot recover
    (e.g. no serving fleet is in service)."""
