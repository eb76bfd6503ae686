"""Cluster front-end: precision/accuracy/deadline admission routing across
heterogeneous dies, health-aware, degrade-don't-drop (counterpart of
``repro.cluster.router``).

One ``ClusterRouter`` owns one ``BatchedServer`` (or ``ResilientServer``)
replica per die of a ``ClusterSpec``, all sharing the same model, params,
and injected clock.  The dies' ``ChipPolicy``s live on the model's device
(where a missing calibration would be fitted); the router itself holds no
tensor.

Routing generalizes the single-die admission pipeline one level up:

  * **Structural feasibility** is judged against the *whole cluster*: a
    request is rejected (structured ``RequestRejected``, mirroring the
    engine's codes) only when *no die — regardless of health —* fabricates
    its requested precision or meets its accuracy class.  Per-die
    validation then can't fire for routed traffic, because routing only
    offers dies the request is feasible on.
  * **Health-aware candidates**: a die is routable when it hasn't been
    failed at the cluster level and its engine still has a serving fleet
    (each chip's own ``ChipPolicy`` health model — dead/quarantined units
    never count).  Among routable dies the request's precision, accuracy
    class, and deadline class are resolved through each die's
    ``ChipPolicy.admission_unit`` — the same routing the die applies
    internally — and dies that resolve it natively outrank dies that
    would have to degrade.  A die with no unit in service answers
    ``faults.UnitFault`` there and counts as not native; any other error
    (the card, a kernel, its build) propagates.
  * **Least-loaded placement**: among equally-capable dies the one with
    the smallest token backlog per in-service slot
    (``BatchedServer.load_report``) wins; ties break on queue depth then
    die name (deterministic).
  * **Degrade-don't-drop**: ``fail_chip`` (or a die whose last fleet the
    health model takes out of service) evacuates every in-flight, queued,
    and parked request and re-admits them on surviving feasible dies via
    the engines' ``requeue`` continuation machinery — committed tokens are
    replayed through the decode path on the new die, so streams resume
    where they stopped (bitwise wherever the model's reductions do not
    change order with the batch's shape, as on the CPU).  When no
    feasible die survives, requests are *parked at the router* (never
    dropped) and re-placed automatically once ``restore_chip`` / health
    recovery returns capacity.

A 1-die cluster routes every request to its only server; outputs are
bitwise-identical to driving that ``BatchedServer`` directly.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.cluster.spec import ClusterSpec
from repro_torch.core.chip import ChipPolicy, ChipSpec
from repro_torch.faults import UnitFault
from repro_torch.serve.engine import BatchedServer, Request, RequestRejected
from repro_torch.telemetry.tracer import NULL_TRACER
from repro_torch.telemetry.tracer import Event as TraceEvent


class SimClock:
    """Settable simulated-time source shared by every die's engine (and the
    load generator): ``clock.t += tick`` advances the whole cluster."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class ClusterRouter:
    """Admission front-end over one serving replica per die.

    ``server_factory(die_name, chip_spec, policy) -> server`` customizes
    replica construction (e.g. ``ResilientServer`` with a per-die fault
    injector); the default builds a ``BatchedServer`` with the shared
    keyword arguments.  ``slots`` may be an int (same on every die) or a
    ``{die_name: int}`` mapping.
    """

    def __init__(self, model, params, cluster: ClusterSpec, *,
                 slots, max_len: int,
                 clock: Callable[[], float] = time.monotonic,
                 server_factory: Optional[Callable[
                     [str, ChipSpec, ChipPolicy], BatchedServer]] = None,
                 tech_params=None,
                 tracer=None,
                 **server_kw):
        self.cluster = cluster
        self.model = model
        self.params = params
        self._clock = clock
        # one tracer shared by every die's engine: a request migrated
        # across dies keeps one causal span tree (each die stamps its own
        # trace_site on the spans it records)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.policies: Dict[str, ChipPolicy] = {}
        self.servers: Dict[str, BatchedServer] = {}
        self._deadline_routing = bool(server_kw.get("deadline_routing"))
        #: dies failed at the cluster level (fail_chip) — no admissions,
        #: no stepping, until restore_chip
        self._failed: set = set()
        #: requests with no feasible die in service — parked, never dropped
        self._parked: List[Request] = []
        self.rejected: List[Request] = []
        self.migrations = 0  # cross-die continuation re-admissions
        self._util_samples: Dict[str, List[float]] = {}
        for spec in cluster.chips:
            policy = ChipPolicy(spec, tech_params, device=model.device)
            self.policies[spec.name] = policy
            n_slots = slots[spec.name] if isinstance(slots, dict) else slots
            if server_factory is not None:
                srv = server_factory(spec.name, spec, policy)
            else:
                srv = BatchedServer(model, params, slots=n_slots,
                                    max_len=max_len, chip_policy=policy,
                                    clock=clock, **server_kw)
            if tracer is not None:  # custom factories keep their own wiring
                srv.tracer = self.tracer
            srv.trace_site = spec.name
            self.servers[spec.name] = srv
            self._util_samples[spec.name] = []

    # ------------------------------------------------------------ routing
    def _feasible(self, req: Request, spec: ChipSpec) -> bool:
        """Structural feasibility of a die for this request, health aside:
        the precision is fabricated and the accuracy class achievable."""
        if req.precision is not None:
            if req.precision not in {u.design.precision for u in spec.units}:
                return False
        if req.accuracy_slo is not None:
            if min(u.rel_err() for u in spec.units) > req.accuracy_slo:
                return False
        return True

    def _serving(self, name: str) -> bool:
        return name not in self._failed \
            and bool(self.servers[name]._serving_fleets())

    def _native(self, req: Request, name: str) -> bool:
        """Does this die resolve the request's precision/accuracy/deadline
        class to an in-service fleet without degrading?  Reuses the die's
        own admission routing."""
        pol = self.policies[name]
        srv = self.servers[name]
        deadline_class = None
        if self._deadline_routing:
            deadline_class = ("interactive" if req.deadline_s is not None
                             else "bulk")
        try:
            unit = pol.admission_unit(
                precision=req.precision or srv._precision,
                deadline_class=deadline_class,
                accuracy_slo=req.accuracy_slo)
        except UnitFault:  # no unit in service on this die
            return False
        return unit.name in srv._fleets and srv._fleet_in_service(unit.name)

    def _load_key(self, name: str) -> Tuple[float, int, str]:
        r = self.servers[name].load_report()
        return (r["load"], r["queued"], name)

    def route(self, req: Request) -> Optional[str]:
        """The die this request should land on right now, or ``None`` when
        no structurally-feasible die is currently serving (park)."""
        candidates = [c.name for c in self.cluster.chips
                      if self._feasible(req, c) and self._serving(c.name)]
        if not candidates:
            return None
        native = [n for n in candidates if self._native(req, n)]
        pool = native or candidates  # degrade within a feasible die
        return min(pool, key=self._load_key)

    # ---------------------------------------------------------- admission
    def _reject(self, req: Request, code: str, reason: str):
        req.rejected = True
        req.reject_reason = f"[{code}] {reason}"
        self.rejected.append(req)
        if self.tracer.enabled:
            now = self._clock()
            self.tracer.request_begin(req.uid, now)
            self.tracer.event(req.uid, TraceEvent.REJECT, now, code=code)
            self.tracer.end_request(req.uid, now, "rejected")
        raise RequestRejected(req, code, reason)

    def submit(self, req: Request) -> str:
        """Validate cluster-wide, route, and enqueue on the chosen die.
        Returns the die name ('' when parked).  Raises ``RequestRejected``
        when no die — of any health — could ever serve the request."""
        feasible = [c for c in self.cluster.chips if self._feasible(req, c)]
        if not feasible:
            have = sorted({u.design.precision for c in self.cluster.chips
                           for u in c.units})
            if req.precision is not None and req.precision not in have:
                self._reject(req, "unknown_precision",
                             f"precision {req.precision!r} is not "
                             f"fabricated on any die of cluster "
                             f"{self.cluster.name!r} (have {have})")
            # accuracy class unmeetable on every die fabricating the
            # requested precision (all dies when precision is unset)
            best = min(u.rel_err() for c in self.cluster.chips
                       for u in c.units
                       if req.precision is None
                       or req.precision in {x.design.precision
                                            for x in c.units})
            self._reject(req, "accuracy_slo_unmeetable",
                         f"no die of cluster {self.cluster.name!r}"
                         + (f" fabricating {req.precision!r}"
                            if req.precision is not None else "")
                         + f" meets accuracy_slo={req.accuracy_slo:g} "
                         f"(best achievable rel_err={best:g})")
        target = self.route(req)
        if target is None:
            # every feasible die is failed/out of service: park, don't drop
            self.servers[feasible[0].name].validate(req)  # shape/type checks
            self._parked.append(req)
            if self.tracer.enabled:
                now = self._clock()
                self.tracer.request_begin(req.uid, now)
                self.tracer.event(req.uid, TraceEvent.PARK, now,
                                  site="cluster")
            return ""
        self.servers[target].submit(req)
        return target

    # ----------------------------------------------------- failure / drain
    def fail_chip(self, name: str) -> List[Request]:
        """Whole-die failure: take the die out of the routable set,
        evacuate everything it holds, and re-place each request on a
        surviving feasible die (front-of-queue continuations, committed
        tokens replayed bitwise) — or park it at the router when none
        survives.  Returns the evacuated requests."""
        self.cluster.chip(name)  # raises on unknown die
        self._failed.add(name)
        if self.tracer.enabled:
            self.tracer.system_event(TraceEvent.FAULT, self._clock(),
                                     site=name, kind="die_kill")
        moved = self.servers[name].evacuate()
        for req in moved:
            self._migrate(req)
        return moved

    def restore_chip(self, name: str) -> None:
        """Return a failed die to service and re-place parked traffic."""
        self.cluster.chip(name)
        self._failed.discard(name)
        if self.tracer.enabled:
            self.tracer.system_event(TraceEvent.PROBE, self._clock(),
                                     site=name, kind="die_restore")
        self._unpark()

    def _migrate(self, req: Request) -> str:
        """Re-admit an evacuated continuation on the best surviving die."""
        target = self.route(req)
        if target is None:
            self._parked.append(req)
            if self.tracer.enabled:
                self.tracer.event(req.uid, TraceEvent.PARK, self._clock(),
                                  site="cluster")
            return ""
        if self.tracer.enabled:
            self.tracer.event(req.uid, TraceEvent.MIGRATE, self._clock(),
                              site="cluster", to_site=target)
        self.servers[target].requeue(req)
        self.migrations += 1
        return target

    def _unpark(self) -> None:
        if not self._parked:
            return
        parked, self._parked = self._parked, []
        for req in parked:
            self._migrate(req)

    def _rescue(self) -> None:
        """Pull requests parked *inside* a die (its health model drained
        them with no local fleet left) out to the cluster level and
        re-place them on other dies — the cross-die half of
        degrade-don't-drop."""
        for name, srv in self.servers.items():
            if srv._parked and not self._serving(name):
                for req in srv.take_parked():
                    self._migrate(req)

    # ------------------------------------------------------------ serving
    def step(self, max_tokens: Optional[int] = None) -> int:
        """One dispatch over every live die; returns total active slots."""
        self._rescue()
        self._unpark()
        n_active = 0
        for name, srv in self.servers.items():
            if name in self._failed:
                continue
            n_active += srv.step(max_tokens)
            r = srv.load_report()
            self._util_samples[name].append(
                r["active"] / max(r["slots"], 1))
        return n_active

    def idle(self) -> bool:
        return not self._parked and all(
            srv.idle() for name, srv in self.servers.items()
            if name not in self._failed)

    def run(self, max_steps: int = 10_000,
            dispatch_tokens: Optional[int] = None) -> List[Request]:
        """Serve until every die drains (or ``max_steps``); returns the
        requests finished since the last call, across all dies."""
        for _ in range(max_steps):
            if self.idle():
                break
            self.step(dispatch_tokens)
        return self.drain_finished()

    def drain_finished(self) -> List[Request]:
        out: List[Request] = []
        for srv in self.servers.values():
            out.extend(srv.finished)
            srv.finished = []
        return out

    # ------------------------------------------------------------ reports
    def load_report(self) -> Dict[str, Dict[str, float]]:
        return {name: srv.load_report()
                for name, srv in self.servers.items()}

    def energy_report(self) -> Dict[str, object]:
        per_die = {name: srv.energy_report()
                   for name, srv in self.servers.items()}
        total = sum(r["total_j"] for r in per_die.values())
        tokens = sum(r["tokens_decoded"] for r in per_die.values())
        return dict(cluster=self.cluster.name, total_j=total,
                    tokens_decoded=tokens,
                    j_per_token=total / tokens if tokens else 0.0,
                    per_die=per_die)

    def utilization_report(self) -> Dict[str, float]:
        """Mean busy-slot fraction per die over the steps served so far."""
        return {name: (sum(s) / len(s) if s else 0.0)
                for name, s in self._util_samples.items()}

    def cluster_report(self) -> Dict[str, object]:
        return dict(cluster=self.cluster.name,
                    dies=len(self.cluster.chips),
                    failed=sorted(self._failed),
                    parked=len(self._parked),
                    migrations=self.migrations,
                    rejected=len(self.rejected),
                    load=self.load_report(),
                    utilization=self.utilization_report(),
                    energy=self.energy_report())
