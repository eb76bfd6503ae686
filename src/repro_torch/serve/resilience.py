"""Fault-tolerant serving of the port (counterpart of
``repro.serve.resilience``): health monitoring and degrade-don't-drop
recovery.

The paper's FPUs run at aggressive electrical points (near-threshold V_DD,
adaptive body bias) where units throttle, degrade or fail.  This module
puts fault injection, health monitoring and recovery around the batched
engine:

  * ``HealthMonitor``: a trailing-median watchdog over per-unit dispatch
    times.  It detects the three fault kinds from *symptoms* only (it
    never talks to the injector): a dispatch that produced nothing ->
    ``dead``; dispatch times above the unit's healthy median for several
    dispatches in a row -> ``throttled`` (with an estimated derate);
    invalid token ids in a fetched stream -> ``corrupt`` symptoms, which
    the server's bounded-retry policy turns into a quarantine when they
    persist.
  * ``ResilientServer``: ``BatchedServer`` plus the recovery protocol.  At
    every dispatch boundary it polls the ``faults.FaultInjector`` (when
    one is armed), filters the fetched tokens through the fault symptoms,
    feeds the monitor and applies its verdicts to the ``ChipPolicy``
    health model.  The invariant is **degrade, never drop**:

      - a killed or quarantined fleet is drained: its requests are
        re-admitted as *continuations* on the cheapest surviving fleet that
        still meets their precision and accuracy class, which re-prefills
        the prompt and replays the committed tokens through the decode
        path, so the stream resumes as it would have gone on;
      - transient corruption is retried with exponential backoff on the
        same fleet before the unit is quarantined;
      - a throttled fleet keeps serving, repriced (leakage energy per FLOP
        grows with the derate) and deprioritised for new admissions;
      - when capacity shrinks, admission applies backpressure (structured
        rejects, never silent loss) and sheds queued requests that
        provably cannot meet their deadline.

    Corrupted or failed dispatch output is never committed; the energy a
    corrupt dispatch burned is still charged (``wasted_energy_j``).

Faults here are the injector's symptoms only.  An exception raised by the
device, a kernel or its build is not a fault verdict: it propagates to the
caller and never drains a fleet.

Recovery latency (fault detection -> every affected request re-seated),
requeues, sheds and wasted energy are in ``resilience_report()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.chip import UnitHealth
from repro_torch.faults import FaultInjector, FaultKind
from repro_torch.serve.engine import BatchedServer, Request
from repro_torch.telemetry.tracer import Event as TraceEvent


# ---------------------------------------------------------------------------
# Health monitoring (symptom -> verdict)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HealthVerdict:
    """One monitor decision about one unit."""

    unit: str
    status: str  # a UnitHealth status, or 'corrupt' (symptom, not a state)
    freq_scale: float = 1.0
    reason: str = ""

    CORRUPT = "corrupt"


class HealthMonitor:
    """Trailing-median watchdog over per-unit dispatch telemetry.

    Each unit keeps a trailing window of *healthy* per-dispatch times; a
    dispatch slower than ``tolerance`` x the healthy median for ``trip``
    consecutive observations flags the unit throttled
    (derate estimate = median / observed), and ``recover_trip`` consecutive
    in-budget dispatches on a throttled unit clear it.  Hard dispatch
    faults flag ``dead`` immediately; corrupted token streams yield
    ``corrupt`` symptoms the server's retry policy consumes.
    """

    def __init__(self, *, window: int = 32, tolerance: float = 1.5,
                 trip: int = 2, recover_trip: int = 2):
        self.window = window
        self.tolerance = tolerance
        self.trip = trip
        self.recover_trip = recover_trip
        self._baseline: Dict[str, List[float]] = {}
        self._slow_streak: Dict[str, int] = {}
        self._ok_streak: Dict[str, int] = {}
        self._throttled: Dict[str, float] = {}  # unit -> freq_scale estimate
        self.corrupt_dispatches: Dict[str, int] = {}
        self.fault_dispatches: Dict[str, int] = {}

    def median_dispatch_s(self, unit: str,
                          default: float = 0.0) -> float:
        """The unit's healthy-baseline median dispatch time (the service
        rate the load shedder estimates against)."""
        times = self._baseline.get(unit)
        if not times:
            return default
        return float(np.median(times[-self.window:]))

    def observe_fault(self, unit: str, reason: str = "dispatch fault"
                      ) -> HealthVerdict:
        """A dispatch on the unit produced nothing at all: hard failure."""
        self.fault_dispatches[unit] = self.fault_dispatches.get(unit, 0) + 1
        return HealthVerdict(unit, UnitHealth.DEAD, reason=reason)

    def observe_corruption(self, unit: str, n_bad: int) -> HealthVerdict:
        """Invalid token ids / NaN residue in the unit's fetched stream."""
        self.corrupt_dispatches[unit] = \
            self.corrupt_dispatches.get(unit, 0) + 1
        return HealthVerdict(
            unit, HealthVerdict.CORRUPT,
            reason=f"{n_bad} corrupted token(s) in one dispatch")

    def observe_dispatch(self, unit: str, dt_s: float
                         ) -> Optional[HealthVerdict]:
        """A completed (clean) dispatch took ``dt_s`` on the unit; returns
        a throttle/recovery verdict when the trailing-median watchdog
        trips, else None."""
        base = self._baseline.setdefault(unit, [])
        med = float(np.median(base[-self.window:])) if base else dt_s
        slow = bool(base) and dt_s > self.tolerance * med
        if slow:
            self._ok_streak[unit] = 0
            streak = self._slow_streak.get(unit, 0) + 1
            self._slow_streak[unit] = streak
            if streak >= self.trip:
                scale = min(max(med / dt_s, 0.05), 1.0)
                self._throttled[unit] = scale
                return HealthVerdict(
                    unit, UnitHealth.THROTTLED, freq_scale=scale,
                    reason=f"dispatch {dt_s / med:.2f}x the healthy median "
                           f"for {streak} consecutive dispatches")
            return None
        # in budget: feeds the healthy baseline; may clear a throttle
        self._slow_streak[unit] = 0
        base.append(dt_s)
        if unit in self._throttled:
            ok = self._ok_streak.get(unit, 0) + 1
            self._ok_streak[unit] = ok
            if ok >= self.recover_trip:
                del self._throttled[unit]
                self._ok_streak[unit] = 0
                return HealthVerdict(
                    unit, UnitHealth.HEALTHY,
                    reason=f"{ok} consecutive in-budget dispatches")
        return None

    def reset(self, unit: str) -> None:
        """Forget a unit's streaks (after quarantine/kill: its next life
        starts clean)."""
        self._slow_streak.pop(unit, None)
        self._ok_streak.pop(unit, None)
        self._throttled.pop(unit, None)


# ---------------------------------------------------------------------------
# The resilient server
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Recovery-policy knobs for ``ResilientServer``."""

    #: consecutive corrupt dispatches tolerated (with backoff) before the
    #: unit is quarantined and its traffic re-routed
    max_retries: int = 3
    #: first retry backoff; doubles per consecutive corrupt dispatch
    backoff_base_s: float = 0.25
    #: seconds after which an out-of-service fleet is optimistically
    #: re-probed (re-enabled for one admission wave; the next dispatch's
    #: symptoms re-kill it if the fault persists).  None = never probe.
    probe_interval_s: Optional[float] = 2.0
    #: queue-depth ceiling per fleet, as a multiple of its slot count,
    #: enforced on new submissions while the chip is degraded
    backpressure_depth: float = 4.0
    #: shed queued deadline requests that provably cannot finish in time
    #: once capacity shrinks
    shed_unmeetable: bool = True
    #: deterministic per-dispatch base time (sim seconds) for tests/benches
    #: driving a fake clock; None = measure wall time per dispatch
    synthetic_dispatch_s: Optional[float] = None


class ResilientServer(BatchedServer):
    """``BatchedServer`` + chip health model + degrade-don't-drop recovery.

    Requires a ``chip_policy`` (the health model and fleet routing live
    there).  ``injector`` is optional — without one the monitor still
    watches real dispatch timings, so an actually-slow fleet gets detected
    and repriced; with one, the seeded chaos schedule perturbs the
    dispatch symptoms and the whole recovery protocol is exercised
    deterministically.
    """

    def __init__(self, model, params, *, injector: Optional[FaultInjector]
                 = None, monitor: Optional[HealthMonitor] = None,
                 resilience: ResilienceConfig = ResilienceConfig(), **kw):
        super().__init__(model, params, **kw)
        if self.chip_policy is None:
            raise ValueError("ResilientServer needs a chip_policy: the "
                             "health model and fleet routing live there")
        self.injector = injector
        self.monitor = monitor or HealthMonitor()
        self.config = resilience
        #: consecutive corrupt dispatches per fleet (bounded-retry state)
        self._corrupt_streak: Dict[str, int] = {}
        #: fleet -> sim time before which admission must not retry it
        self._retry_until: Dict[str, float] = {}
        #: fleet -> time it was taken out of service (probe bookkeeping)
        self._downed_at: Dict[str, float] = {}
        #: fault log: dicts with unit/kind/detected_s/recovered_s
        self.fault_log: List[Dict[str, object]] = []
        #: drains awaiting re-seating: (log record, pending uids)
        self._recovering: List[Tuple[Dict[str, object], set]] = []
        self.wasted_energy_j = 0.0
        self.shed_requests: List[Request] = []

    # ---------------------------------------------------------- admission
    def _fleet_in_service(self, name: str) -> bool:
        if not super()._fleet_in_service(name):
            return False
        return self._clock() >= self._retry_until.get(name, 0.0)

    def _check_admission(self, req: Request, fleet: str) -> None:
        """Backpressure: while degraded, refuse a request whose fleet's
        queue is already ``backpressure_depth`` deep per slot."""
        if self._degraded():
            depth = len(self._queues[fleet])
            limit = self.config.backpressure_depth * max(
                1, len(self._fleets[fleet]))
            if depth >= limit:
                self._reject(
                    req, "backpressure",
                    f"fleet {fleet!r} is degraded-mode saturated "
                    f"({depth} queued >= {limit:.0f}); retry later or "
                    f"relax the precision/accuracy class")

    def _degraded(self) -> bool:
        """Any provisioned fleet out of service / cooling down / throttled?"""
        if self._out_of_service or self._retry_until:
            return True
        return any(
            self.chip_policy.unit_health(n).status != UnitHealth.HEALTHY
            for n, u in self._fleet_units.items() if u is not None)

    # ----------------------------------------------------- fault handling
    def _log_fault(self, unit: str, kind: str, now: float,
                   pending: List[Request]) -> None:
        rec = dict(unit=unit, kind=kind, detected_s=now, recovered_s=None,
                   requests_drained=len(pending))
        self.fault_log.append(rec)
        if self.tracer.enabled:
            self.tracer.system_event(TraceEvent.FAULT, now,
                                     site=self.trace_site, unit=unit,
                                     kind=kind, drained=len(pending))
        if pending:
            self._recovering.append((rec, list(pending)))
        else:
            rec["recovered_s"] = now

    def _down_fleet(self, name: str, status: str, reason: str,
                    now: float) -> None:
        """Mark a fleet's unit out of service and drain it (requests
        re-admitted as continuations on surviving fleets)."""
        self.chip_policy.set_health(name, status, reason=reason, now=now)
        self.monitor.reset(name)
        self._retry_until.pop(name, None)
        self._corrupt_streak.pop(name, None)
        self._downed_at[name] = now
        drained = self.drain_fleet(name, requeue=True)
        kind = (FaultKind.KILL if status == UnitHealth.DEAD
                else FaultKind.CORRUPT)
        self._log_fault(name, kind, now, drained)

    def _apply_verdict(self, v: HealthVerdict, now: float) -> None:
        if v.status == UnitHealth.DEAD:
            self._down_fleet(v.unit, UnitHealth.DEAD, v.reason, now)
        elif v.status == UnitHealth.THROTTLED:
            prev = self.chip_policy.unit_health(v.unit).status
            self.chip_policy.set_health(v.unit, UnitHealth.THROTTLED,
                                        freq_scale=v.freq_scale,
                                        reason=v.reason, now=now)
            if prev != UnitHealth.THROTTLED:  # log transitions, not repeats
                self._log_fault(v.unit, FaultKind.THROTTLE, now, [])
        elif v.status == UnitHealth.HEALTHY:
            self.chip_policy.clear_health(v.unit)
        elif v.status == HealthVerdict.CORRUPT:
            streak = self._corrupt_streak.get(v.unit, 0) + 1
            self._corrupt_streak[v.unit] = streak
            if streak > self.config.max_retries:
                self._down_fleet(v.unit, UnitHealth.QUARANTINED,
                                 f"corruption persisted through "
                                 f"{streak - 1} retries", now)
                return
            # bounded retry with exponential backoff: drain the fleet's
            # slots (its device state is garbage) but pin the requests to
            # its own queue — admission retries after the cooldown
            backoff = self.config.backoff_base_s * (2.0 ** (streak - 1))
            self._retry_until[v.unit] = now + backoff
            released, pending = [], []
            for s in self._fleets[v.unit]:
                req = self._active[s]
                if req is None:
                    continue
                released.append(s)
                pending.append(req)
                req.requeues += 1
                self._queues[v.unit].insert(0, req)
            self._release_slots(released)
            if self.tracer.enabled:
                for req in pending:  # after release: events land on the root
                    self.tracer.event(req.uid, TraceEvent.REQUEUE, now,
                                      site=self.trace_site, fleet=v.unit,
                                      requeues=req.requeues, retry=True)
            self._log_fault(v.unit, FaultKind.CORRUPT, now, pending)

    def _probe_downed(self, now: float) -> None:
        """Optimistic re-admission probe: after the probe interval an
        out-of-service fleet is put back in rotation — if the fault
        persists, the very next dispatch's symptoms take it down again
        (flapping is bounded by the interval); if it ended, the fleet
        rejoins for real."""
        if self.config.probe_interval_s is None:
            return
        for name, t0 in list(self._downed_at.items()):
            if now - t0 >= self.config.probe_interval_s:
                del self._downed_at[name]
                self._corrupt_streak.pop(name, None)
                self.chip_policy.clear_health(name)
                self.set_fleet_in_service(name, True)
                if self.tracer.enabled:
                    self.tracer.system_event(TraceEvent.PROBE, now,
                                             site=self.trace_site,
                                             unit=name)

    # ------------------------------------------------------ load shedding
    def _shed_unmeetable(self, now: float) -> None:
        """Deadline-aware shedding under shrunk capacity: a queued request
        whose deadline cannot be met even by an optimistic service
        estimate is rejected structurally *now*, releasing its queue
        position, instead of expiring after burning a slot."""
        if not self.config.shed_unmeetable or not self._degraded():
            return
        for fleet, queue in self._queues.items():
            unit = self._fleet_units.get(fleet)
            default = self.config.synthetic_dispatch_s or 0.0
            med = self.monitor.median_dispatch_s(fleet, default=default)
            if med <= 0.0:
                continue  # no service-time evidence: never shed blind
            if unit is not None:
                med *= self.chip_policy.unit_time_scale(fleet)
            if not math.isfinite(med):
                continue  # fleet out of service; drain handles its queue
            n_slots = max(1, len(self._fleets[fleet]))
            keep: List[Request] = []
            for pos, req in enumerate(queue):
                if req.deadline_s is None:
                    keep.append(req)
                    continue
                remaining = req.max_new_tokens - len(req.output)
                own = math.ceil(max(remaining, 1) / self.dispatch_tokens)
                waves = pos // n_slots
                est_finish = now + med * (own + waves)
                if est_finish > req.deadline_s:
                    req.rejected = True
                    req.reject_reason = (
                        f"[shed_unmeetable] degraded capacity: optimistic "
                        f"finish estimate {est_finish:.3f}s > deadline "
                        f"{req.deadline_s:.3f}s on fleet {fleet!r}")
                    self.rejected.append(req)
                    self.shed_requests.append(req)
                    if self.tracer.enabled:
                        self.tracer.event(req.uid, TraceEvent.SHED, now,
                                          site=self.trace_site,
                                          fleet=fleet)
                        self.tracer.end_request(req.uid, now, "rejected")
                else:
                    keep.append(req)
            queue[:] = keep

    # ------------------------------------------------------------ decoding
    def step(self, max_tokens: Optional[int] = None) -> int:
        now = self._clock()
        if self.injector is not None:
            self.injector.poll(now)  # consume newly-started events (log)
        self._probe_downed(now)
        self._shed_unmeetable(now)
        n_active = super().step(max_tokens)
        self._settle_recoveries(self._clock())
        return n_active

    def _settle_recoveries(self, now: float) -> None:
        """A fault is *recovered* once every request it drained is either
        re-seated on a serving fleet, finished, or structurally rejected —
        that instant stamps the record's recovery latency."""
        still: List[Tuple[Dict[str, object], List[Request]]] = []
        seated = {id(r) for r in self._active if r is not None}
        for rec, pending in self._recovering:
            pending = [r for r in pending
                       if id(r) not in seated and not r.done
                       and not r.rejected]
            if pending:
                still.append((rec, pending))
            else:
                rec["recovered_s"] = now
        self._recovering = still

    def _filter_dispatch(self, active_slots: List[int],
                         toks_np: np.ndarray, emitted_np: np.ndarray,
                         now: float, dispatch_dt_s: float
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """The symptom pipeline, run on every fetched dispatch before any
        token is committed: apply injector perturbations per fleet, detect
        faults/corruption/throttling, never commit non-committable output."""
        base_dt = self.config.synthetic_dispatch_s
        if base_dt is None:
            base_dt = dispatch_dt_s
        # a fetched buffer may be read-only; symptoms mutate in place
        if not toks_np.flags.writeable:
            toks_np = toks_np.copy()
        if not emitted_np.flags.writeable:
            emitted_np = emitted_np.copy()
        verdicts: List[HealthVerdict] = []
        active = set(active_slots)
        for fleet, slot_ids in self._fleets.items():
            slots = [s for s in slot_ids if s in active]
            if not slots:
                continue
            unit = self._fleet_units.get(fleet)
            if unit is None:
                continue
            inj = self.injector
            if inj is not None and inj.killed(fleet, now):
                # dead unit: nothing came back for its lanes — discard,
                # no tokens committed, no energy drawn
                emitted_np[:, slots] = False
                verdicts.append(self.monitor.observe_fault(
                    fleet, "unit produced no output for a dispatch"))
                continue
            if inj is not None:
                for s in slots:
                    col, _ = inj.corrupt_tokens(fleet, now, toks_np[:, s])
                    toks_np[:, s] = col
            bad_mask = (toks_np[:, slots] == FaultInjector.CORRUPT_TOKEN) \
                & emitted_np[:, slots]
            n_bad = int(bad_mask.sum())
            if n_bad:
                # charge the garbage work (the FPU really burned it), then
                # discard it: corrupted tokens are never committed
                for s in slots:
                    req = self._active[s]
                    count = int(emitted_np[:, s].sum())
                    if req is not None and count:
                        e0 = req.energy_j
                        self._charge_unit(req, unit,
                                          self.flops_per_token * count)
                        self.wasted_energy_j += req.energy_j - e0
                emitted_np[:, slots] = False
                verdicts.append(self.monitor.observe_corruption(fleet,
                                                                n_bad))
                continue
            # clean dispatch: reset the retry streak, observe the timing
            self._corrupt_streak.pop(fleet, None)
            dt = base_dt
            if inj is not None:
                dt *= inj.time_scale(fleet, now)
            v = self.monitor.observe_dispatch(fleet, dt)
            if v is not None:
                verdicts.append(v)
        for v in verdicts:
            self._apply_verdict(v, now)
        return toks_np, emitted_np

    # ---------------------------------------------------------- telemetry
    def resilience_report(self) -> Dict[str, object]:
        recoveries = [r for r in self.fault_log
                      if r["recovered_s"] is not None
                      and r["requests_drained"]]
        lat = [float(r["recovered_s"]) - float(r["detected_s"])
               for r in recoveries]
        return dict(
            faults_detected=len(self.fault_log),
            fault_log=[dict(r) for r in self.fault_log],
            health=self.chip_policy.health_report(),
            requests_drained=sum(
                int(r["requests_drained"]) for r in self.fault_log),
            recovery_latency_s=dict(
                n=len(lat),
                mean=(float(np.mean(lat)) if lat else 0.0),
                max=(float(np.max(lat)) if lat else 0.0)),
            wasted_energy_j=self.wasted_energy_j,
            parked=len(self._parked),
            shed=len(self.shed_requests),
            rejected=len(self.rejected),
            corrupt_dispatches=dict(self.monitor.corrupt_dispatches),
            fault_dispatches=dict(self.monitor.fault_dispatches))
