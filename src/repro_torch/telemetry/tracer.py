"""Structured tracing core of the port (counterpart of
``repro.telemetry.tracer``): spans, typed events and metric timelines.

One ``Tracer`` records everything the serving stack does with a request's
time and energy, on the stack's own injected clock (sim seconds under a
fake clock, wall seconds otherwise):

  * a **root span** per request uid (opened at ``submit``, closed at
    finish/expire/reject) carrying the request's routing attributes;
  * an **attempt span** per seating of the request on a fleet: a request
    drained off a failing fleet and re-admitted elsewhere gets a new
    attempt whose parent is the previous one, so its whole migration
    history is one causal tree rooted at the request span;
  * **typed events** (``Event.ADMIT``/``SEAT``/``PREFILL_CHUNK``/
    ``DECODE_DISPATCH``/``FAULT``/``PARK``/``REQUEUE`` ...) appended to
    the request's current attempt (the root when none is open);
  * **energy charges**: ``charge()`` is called from the engine's single
    energy choke point (``BatchedServer._charge_unit``), so the sum over
    span energies reconciles with the engine's chip-level ledger (to
    float addition order), replayed continuations and wasted
    corrupt-dispatch work included;
  * **metric timelines**: per-step counter/gauge samples (lane occupancy,
    queue depth, stall fractions ...) keyed by name and site.

Engines default to the module-level ``NULL_TRACER`` whose ``enabled`` is
False, and every instrumentation site is guarded by ``if
tracer.enabled:``, so a disabled tracer costs one attribute read per
guarded block.

Apart from that request-level data, a tracer keeps **phase scopes**
(``Tracer.scope``): nested host intervals on ``time.perf_counter_ns``
around the engine's phases, the model's entry points and each K1 launch,
each with its attributes and, given a CUDA device, its device time between
two timing events.  The module-level ``scope`` picks the tracer a site
records into: the one passed in when it is enabled, else, while a
``torch.profiler`` session records, the session's own tracer
(``profiled_session``), else none.  While the profiler records, a scope
also opens ``record_function("fpmax.<name>")``, so the same interval lies
on the device trace, and the tracer's ``clock_anchor`` converts a scope's
times to the profiler's clock (the epoch clock of ``time.time_ns``).

The module imports nothing beyond the standard library, so every layer can
depend on it without cycles; its JSONL logs load in either package (the
JAX package skips the scope rows).  Torch is imported only where a scope
records.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional, Tuple


class Event:
    """Typed event vocabulary (string constants: events serialize straight
    into the JSONL/Chrome exporters)."""

    ADMIT = "admit"                    # accepted by submit(), queued
    SEAT = "seat"                      # placed into a device lane
    PREFILL = "prefill"                # monolithic batched prefill
    PREFILL_CHUNK = "prefill_chunk"    # one chunked-prefill advance
    DECODE_DISPATCH = "decode_dispatch"  # tokens committed at a boundary
    FINISH = "finish"
    EXPIRE = "expire"
    REJECT = "reject"                  # structured admission reject
    SHED = "shed"                      # deadline-aware load shed
    REQUEUE = "requeue"                # drained, re-admitted continuation
    MIGRATE = "migrate"                # cross-die continuation placement
    PARK = "park"                      # no serving fleet/die: held, not lost
    UNPARK = "unpark"
    DRAIN = "drain"                    # slot released by a fleet drain
    FAULT = "fault"                    # unit/die fault detected (system)
    PROBE = "probe"                    # optimistic re-admission probe
    ARRIVAL = "arrival"                # load-generator arrival (system)

    #: event types whose ``tokens`` attr accumulates into the span's
    #: prefill / decode token counters
    PREFILL_TOKEN_EVENTS = (PREFILL, PREFILL_CHUNK)
    DECODE_TOKEN_EVENTS = (DECODE_DISPATCH,)


@dataclasses.dataclass
class Span:
    """One node of a request's causal tree (root or attempt)."""

    span_id: int
    uid: int
    parent_id: Optional[int]
    name: str          # "request:<uid>" | "attempt:<site>/<fleet>"
    site: str          # die name ('' for a bare server)
    fleet: str         # serving fleet (unit name) of an attempt
    start_s: float
    end_s: Optional[float] = None
    status: str = "open"  # open | ok | expired | drained | rejected
    energy_j: float = 0.0
    unit_energy_j: Dict[str, float] = dataclasses.field(default_factory=dict)
    prefill_tokens: int = 0
    decode_tokens: int = 0
    #: (event_type, t_s, attrs) rows in record order
    events: List[Tuple[str, float, dict]] = dataclasses.field(
        default_factory=list)
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def is_root(self) -> bool:
        return self.parent_id is None

    @property
    def duration_s(self) -> float:
        return (self.end_s if self.end_s is not None else self.start_s) \
            - self.start_s


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

    def charge(self, uid, unit, e_j, flops, t, phase="decode", tokens=0):
        return None

    def count(self, name, t, value, site=""):
        return None

    def system_event(self, type, t, site="", **attrs):
        return None

    def scope(self, name, device=None, **attrs):
        return NULL_SCOPE


#: the process-wide disabled tracer every engine defaults to
NULL_TRACER = NullTracer()


def _profiling() -> bool:
    """True while a ``torch.profiler`` session records (the profiler's own
    Python-side flag: no torch call, and False before torch is loaded)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class _NullScope:
    """The scope that records nothing: one shared instance."""

    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs):
        return None


NULL_SCOPE = _NullScope()


class Scope:
    """One phase scope of a ``Tracer``: ``start_ns``/``end_ns`` on
    ``time.perf_counter_ns``, ``parent_id`` the innermost scope of the same
    tracer open at entry, ``device_s`` the time between its two CUDA
    events (None without a CUDA device, or until
    ``Tracer.resolve_device_times``).  Entered, it is its own handle:
    ``on`` is True and ``set(**attrs)`` adds attributes."""

    __slots__ = ("scope_id", "parent_id", "name", "start_ns", "end_ns",
                 "attrs", "device_s", "_tracer", "_device", "_events",
                 "_range")
    on = True

    def __init__(self, scope_id: int, name: str, attrs: dict,
                 parent_id: Optional[int] = None, start_ns: int = 0,
                 end_ns: Optional[int] = None,
                 device_s: Optional[float] = None, tracer=None,
                 device=None):
        self.scope_id = scope_id
        self.parent_id = parent_id
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.attrs = attrs
        self.device_s = device_s
        self._tracer = tracer
        self._device = device
        self._events = None
        self._range = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def host_s(self) -> Optional[float]:
        return None if self.end_ns is None \
            else (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> "Scope":
        tr = self._tracer
        stack = tr._open_scopes
        self.parent_id = stack[-1].scope_id if stack else None
        stack.append(self)
        if _profiling():
            from torch.autograd.profiler import record_function
            self._range = record_function("fpmax." + self.name)
            self._range.__enter__()
        dev = self._device
        if dev is not None and getattr(dev, "type", None) == "cuda":
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            self._events = (start, end, torch.cuda.current_stream(dev))
        self.start_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[0].record(self._events[2])
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record(self._events[2])
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._tracer._open_scopes.pop()
        return None

    def resolve(self) -> None:
        """Read the device time from the two events, waiting for the end
        event (never called inside the scope)."""
        if self._events is None or self.end_ns is None:
            return
        start, end, _ = self._events
        end.synchronize()
        self.device_s = start.elapsed_time(end) * 1e-3
        self._events = None


class Tracer(NullTracer):
    """The recording tracer (see module docstring for the data model)."""

    enabled = True

    def __init__(self):
        self.spans: List[Span] = []
        self._root: Dict[int, Span] = {}      # uid -> root span
        self._attempt: Dict[int, Span] = {}   # uid -> open attempt span
        self._last_attempt: Dict[int, Span] = {}  # uid -> newest attempt
        #: metric name -> [(t_s, site, value)] sample timeline
        self.metrics: Dict[str, List[Tuple[float, str, float]]] = {}
        #: system-scope events (faults, probes, arrivals): not tied to one
        #: request span — (type, t_s, site, attrs)
        self.system_events: List[Tuple[str, float, str, dict]] = []
        self._next_id = 0
        #: phase scopes in entry order, apart from the request spans
        self.scopes: List[Scope] = []
        #: (perf_counter_ns, time_ns) read back to back at the first scope
        self.clock_anchor: Optional[Tuple[int, int]] = None
        self._open_scopes: List[Scope] = []

    # ------------------------------------------------------------- spans
    def _new_span(self, uid: int, parent: Optional[int], name: str,
                  site: str, fleet: str, t: float, attrs: dict) -> Span:
        span = Span(self._next_id, uid, parent, name, site, fleet, t,
                    attrs=attrs)
        self._next_id += 1
        self.spans.append(span)
        return span

    def request_begin(self, uid: int, t: float, **attrs) -> Span:
        """Open (or return) the request's root span — idempotent, so every
        admission path (submit, router park, requeue) can call it."""
        root = self._root.get(uid)
        if root is None:
            root = self._new_span(uid, None, f"request:{uid}", "", "", t,
                                  attrs)
            self._root[uid] = root
        elif attrs:
            root.attrs.update(attrs)
        return root

    def begin_attempt(self, uid: int, t: float, site: str = "",
                      fleet: str = "", **attrs) -> Span:
        """Open an attempt span for one seating of the request on a fleet.
        The parent is the request's previous attempt when one exists (the
        causal migration chain), else the root."""
        self.end_attempt(uid, t, status="drained")  # stale opens never leak
        root = self.request_begin(uid, t)
        prev = self._last_attempt.get(uid)
        parent = prev.span_id if prev is not None else root.span_id
        span = self._new_span(uid, parent, f"attempt:{site}/{fleet}", site,
                              fleet, t, attrs)
        self._attempt[uid] = span
        self._last_attempt[uid] = span
        return span

    def end_attempt(self, uid: int, t: float, status: str = "ok") -> None:
        span = self._attempt.pop(uid, None)
        if span is not None:
            span.end_s = t
            span.status = status

    def end_request(self, uid: int, t: float, status: str = "ok") -> None:
        root = self._root.get(uid)
        if root is not None and root.end_s is None:
            root.end_s = t
            root.status = status

    # ------------------------------------------------------------ events
    def _target(self, uid: int, t: float) -> Span:
        span = self._attempt.get(uid)
        return span if span is not None else self.request_begin(uid, t)

    def event(self, uid: int, type: str, t: float, **attrs) -> None:
        """Append a typed event to the request's current attempt (root when
        none is open).  A ``tokens=`` attr on prefill/decode event types
        also bumps the span's token counters."""
        span = self._target(uid, t)
        span.events.append((type, t, attrs))
        tokens = attrs.get("tokens")
        if tokens:
            if type in Event.PREFILL_TOKEN_EVENTS:
                span.prefill_tokens += int(tokens)
            elif type in Event.DECODE_TOKEN_EVENTS:
                span.decode_tokens += int(tokens)

    def charge(self, uid: int, unit: str, e_j: float, flops: float,
               t: float, phase: str = "decode", tokens: int = 0) -> None:
        """Attribute one dispatch-boundary energy charge to the request's
        current span — called from the engine's single charging choke
        point, so span totals reconcile against the chip ledger exactly."""
        span = self._target(uid, t)
        span.energy_j += e_j
        span.unit_energy_j[unit] = span.unit_energy_j.get(unit, 0.0) + e_j

    def count(self, name: str, t: float, value: float,
              site: str = "") -> None:
        """One sample of a step-level counter/gauge timeline."""
        self.metrics.setdefault(name, []).append((t, site, float(value)))

    def system_event(self, type: str, t: float, site: str = "",
                     **attrs) -> None:
        self.system_events.append((type, t, site, attrs))

    # ------------------------------------------------------ phase scopes
    def scope(self, name: str, device=None, **attrs) -> Scope:
        """A context manager that records one phase scope (see ``Scope``);
        with a CUDA ``device`` it records a timing event on the device's
        current stream at entry and at exit."""
        if self.clock_anchor is None:
            self.clock_anchor = (time.perf_counter_ns(), time.time_ns())
        sc = Scope(len(self.scopes), name, attrs, tracer=self,
                   device=device)
        self.scopes.append(sc)
        return sc

    def resolve_device_times(self) -> None:
        """Fill every closed scope's ``device_s`` from its events, waiting
        for the last of them: call it after the work, outside the scopes."""
        for sc in self.scopes:
            sc.resolve()

    def to_epoch_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the profiler's (epoch) clock."""
        pc, epoch = self.clock_anchor
        return epoch + (perf_ns - pc)

    def scopes_named(self, name: str) -> List[Scope]:
        return [s for s in self.scopes if s.name == name]

    # ----------------------------------------------------- introspection
    def roots(self) -> Dict[int, Span]:
        return dict(self._root)

    def spans_for(self, uid: int) -> List[Span]:
        return [s for s in self.spans if s.uid == uid]

    def attempts_for(self, uid: int) -> List[Span]:
        return [s for s in self.spans if s.uid == uid and not s.is_root]

    def events_for(self, uid: int,
                   type: Optional[str] = None) -> List[Tuple[str, float,
                                                             dict]]:
        out = []
        for s in self.spans_for(uid):
            out.extend(e for e in s.events
                       if type is None or e[0] == type)
        out.sort(key=lambda e: e[1])
        return out

    def total_energy_j(self) -> float:
        return sum(s.energy_j for s in self.spans)

    def unit_energy_j(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.spans:
            for unit, e in s.unit_energy_j.items():
                out[unit] = out.get(unit, 0.0) + e
        return out

    def request_energy_j(self, uid: int) -> float:
        return sum(s.energy_j for s in self.spans_for(uid))

    def check_integrity(self) -> List[str]:
        """Structural invariants of the recorded forest; returns human-
        readable problem strings (empty = clean):

          * exactly one root span per uid;
          * every attempt's parent exists and belongs to the same uid
            (no orphaned spans — the trace-continuity contract under
            faults/migration);
          * span times are ordered (end >= start) and every closed
            request's attempts are closed too.
        """
        problems: List[str] = []
        by_id = {s.span_id: s for s in self.spans}
        roots_of: Dict[int, int] = {}
        for s in self.spans:
            if s.is_root:
                roots_of[s.uid] = roots_of.get(s.uid, 0) + 1
            else:
                parent = by_id.get(s.parent_id)
                if parent is None:
                    problems.append(f"span {s.span_id} ({s.name}): orphaned "
                                    f"— parent {s.parent_id} not recorded")
                elif parent.uid != s.uid:
                    problems.append(f"span {s.span_id} ({s.name}): parent "
                                    f"{s.parent_id} belongs to uid "
                                    f"{parent.uid}, not {s.uid}")
            if s.end_s is not None and s.end_s < s.start_s:
                problems.append(f"span {s.span_id} ({s.name}): ends "
                                f"{s.end_s} before it starts {s.start_s}")
        for uid, n in roots_of.items():
            if n != 1:
                problems.append(f"uid {uid}: {n} root spans (want 1)")
        for s in self.spans:
            if s.is_root and s.end_s is not None:
                for a in self.attempts_for(s.uid):
                    if a.end_s is None:
                        problems.append(
                            f"uid {s.uid}: request closed but attempt "
                            f"{a.span_id} ({a.name}) still open")
        return problems


class _ProfiledSession:
    """The tracer of the latest ``torch.profiler`` session's scopes.  A new
    one starts at the first scope of a session; a session has ended once
    a scope site or ``profiled_session`` ran with the profiler off."""

    def __init__(self):
        self.tracer: Optional[Tracer] = None
        self.live = False

    def current(self) -> Tracer:
        if not self.live:
            self.tracer = Tracer()
            self.live = True
        return self.tracer


_SESSION = _ProfiledSession()


def scope(name: str, tracer=None, device=None, **attrs):
    """The phase scope of one site: recorded into ``tracer`` when it is an
    enabled ``Tracer`` (a tracer of another kind, such as the JAX
    package's, which the engine also accepts, takes none), else, while a
    ``torch.profiler`` session records, into that session's tracer, else
    nowhere (the shared ``NULL_SCOPE``, whose ``on`` is False: a site
    computes costly attributes only when ``on``).  With tracing off this
    costs a few attribute reads and no torch call."""
    if isinstance(tracer, Tracer) and tracer.enabled:
        return tracer.scope(name, device, **attrs)
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and prof._is_profiler_enabled:
        return _SESSION.current().scope(name, device, **attrs)
    if _SESSION.live:
        _SESSION.live = False
    return NULL_SCOPE


def profiled_session() -> Optional[Tracer]:
    """The scopes the program recorded under the latest ``torch.profiler``
    session, as a ``Tracer`` with its device times resolved, or None when
    no scope ran under a profiler.  The operator's way to get the
    program's phases of a profiled run: profile, then call this."""
    tr = _SESSION.tracer
    if tr is None:
        return None
    if not _profiling():
        _SESSION.live = False
    tr.resolve_device_times()
    return tr
