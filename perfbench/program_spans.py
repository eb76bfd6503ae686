"""The program's phase scopes for the readers of ``program_span``
metrics: ``repro_torch.telemetry.profiled_session()``, the scopes the
program recorded under the traced run's profiler, with their device times.

A program without that accessor, or one that recorded nothing, gives
None, and its metrics are left out of the result line.
"""
from __future__ import annotations

from typing import List, Optional


def _closed() -> Optional[List]:
    try:
        from repro_torch.telemetry import profiled_session
    except ImportError:
        return None
    tracer = profiled_session()
    if tracer is None:
        return None
    return [s for s in tracer.scopes if s.end_ns is not None]


def scopes(name: str) -> Optional[List]:
    """Every closed scope called ``name`` of the profiled session."""
    closed = _closed()
    return None if closed is None else [s for s in closed if s.name == name]


def window_scopes(record: dict, name: str) -> Optional[List]:
    """The scopes called ``name`` that start inside a serving run's window:
    the window ends at the last scope's end (each step ends in a host
    fetch, so on the window's clock) and lasts ``record["window_s"]``.
    That leaves out the last warm-up step, which the profile also holds."""
    closed = _closed()
    if not closed:
        return None
    start = max(s.end_ns for s in closed) - int(record["window_s"] * 1e9)
    return [s for s in closed if s.name == name and s.start_ns >= start]
