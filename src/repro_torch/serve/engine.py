"""Batched serving engine: continuous batching over the LM's decode step,
with chip-aware admission routing across per-unit slot fleets (counterpart
of ``repro.serve.engine``).

The engine drives the LM's prefill/decode steps with a fixed slot count.
Requests are admitted into free slots; finished and expired slots are
recycled.  Structure, as in the JAX engine:

  * **Fused multi-token decode** — ``LM.decode_scan`` decodes up to N
    tokens per dispatch with greedy sampling on the device; the slot state
    (per-slot lengths, next token, remaining budget, active flags) stays in
    device tensors and the host syncs once per dispatch.
  * **Bucketed batched prefill** — prompt lengths are padded up to
    power-of-two buckets (exact for causal attention) and same-bucket
    queued requests are admitted in one batched prefill.  The ssm and
    hybrid families' states integrate every prompt token, pads included,
    so they batch at exact lengths instead.  A sliding-window (ring) cache
    keeps a longer prompt's last ``window`` positions, ring-aligned, and
    caps no length.
  * **Chunked prefill** (``prefill_chunk=N``) — prompts stream through
    their lanes N tokens per step, interleaved with decode dispatches.  For
    the ssm and hybrid families N is rounded up to ``cfg.ssm_scan_chunk``
    (the scan's carry points) and chunks stay exact length.
  * **Stop tokens** — a lane freezes on the device the moment it samples
    one; the stop token is emitted, nothing after it.
  * **Deadlines** on an injected ``clock``: a request that expired before a
    step is released without decoding another token; tokens decoded in the
    dispatch during which the deadline passes are kept.
  * **Chip-aware admission routing** — with a ``core.chip.ChipPolicy``
    attached the slots are partitioned into per-unit fleets
    (``ChipPolicy.slot_fleets``) and every request is routed at admission
    to its fleet by its ``precision``, with ``deadline_routing=True`` by
    its deadline class (deadline-bound -> latency-class unit, bulk ->
    throughput-class unit), and by its ``accuracy_slo`` (the cheapest fleet
    whose unit format meets it; ``accuracy_fleets=`` lists the classes to
    provision fleets for).  Routing changes no numerics: the served model
    runs its own matmuls, as in the JAX engine.
  * **Bulk energy accounting** — energy is charged once per dispatch
    boundary on the fleet's unit (decoded tokens) and per admission on the
    prefill unit (the prompt's forward pass, including the logits that give
    the first token); ``energy_report()`` aggregates chip-level.
  * **Phase scopes** (``telemetry.scope``): ``serve.step`` around a step,
    ``serve.admit`` around its admission, ``serve.prefill`` per admitted
    batch or chunk group (with its real and padded tokens and each new
    request's wait since submission), ``serve.cache_write`` around the
    K/V scatter, ``serve.decode`` from the dispatch through the token
    fetch and ``serve.commit`` around the commit loop; recorded into the
    engine's tracer, or while a ``torch.profiler`` session records.
  * **Drain and re-admission** — ``drain_fleet`` takes a fleet out of
    service and re-admits its requests as *continuations* on surviving
    fleets (``requeue``): the new fleet re-prefills the prompt and replays
    the committed tokens through the decode path, the computation that
    produced them, so the stream resumes where it stopped.  With no fleet
    in service a drained request is parked, never dropped, until capacity
    returns.  ``evacuate``, ``take_parked`` and ``load_report`` are the
    hooks a router above several engines uses.  ``_filter_dispatch`` sits
    between each dispatch's fetch and its commit: the identity here,
    ``serve.resilience.ResilientServer``'s symptom pipeline there.

The device state is updated in place (the JAX engine donates its buffers
to the same effect).  Greedy sampling only.  The engine runs on the
model's device.  ``ReferenceServer`` is the per-token engine kept as the
baseline the batched engine's tokens and energy are held to.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.faults import UnitFault
from repro_torch.models import LM, DecodeCache
from repro_torch.telemetry.tracer import NULL_TRACER, scope
from repro_torch.telemetry.tracer import Event as TraceEvent


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int
    max_new_tokens: int
    deadline_s: Optional[float] = None
    precision: Optional[str] = None  # requested fleet precision (sp/dp)
    #: requested accuracy class: max acceptable numerics error (normwise
    #: relative, the AccuracyModel scale); None = don't care
    accuracy_slo: Optional[float] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    expired: bool = False
    #: structurally rejected (validation, backpressure, load shedding):
    #: never admitted
    rejected: bool = False
    reject_reason: str = ""
    routed_unit: str = ""  # chip unit serving this request's decode phase
    #: times this request was drained off a failing fleet and re-admitted
    #: as a continuation (prefill + decode-path replay) on a surviving one
    requeues: int = 0
    #: clock time ``submit()`` accepted the request (TTFT origin)
    submitted_s: Optional[float] = None
    #: clock time the first output token was committed (a continuation
    #: keeps its first stamp)
    first_token_s: Optional[float] = None
    energy_j: float = 0.0  # total (partial if expired)
    unit_energy_j: Dict[str, float] = dataclasses.field(default_factory=dict)


class RequestRejected(ValueError):
    """Structured admission reject: ``submit()`` raises it and records the
    reject on the request and in ``server.rejected``."""

    def __init__(self, req: "Request", code: str, reason: str):
        super().__init__(f"request {req.uid}: [{code}] {reason}")
        self.req = req
        self.code = code
        self.reason = reason


def bucket_length(n: int, *, lo: int = 8) -> int:
    """Power-of-two prompt-length bucket (>= lo) — the prefill pad target."""
    b = lo
    while b < n:
        b *= 2
    return b


def _flops_per_token(cfg, flops_per_token: Optional[float]) -> float:
    """The FLOPs charged a token: ``None`` means ``2 * active params`` of
    the config (the roofline inference estimate), a falsy value 0.0."""
    if flops_per_token is None and hasattr(cfg, "active_param_count"):
        flops_per_token = 2.0 * cfg.active_param_count()
    return flops_per_token or 0.0


class BatchedServer:
    """Fixed-slot continuous batching server around one LM.

    ``chip_policy`` (a ``core.chip.ChipPolicy``) enables fleet routing and
    per-unit energy accounting, at ``flops_per_token`` FLOPs a token
    (``None``: ``2 * active params`` of the model config; a falsy value
    charges nothing).  Without a policy the slots form
    one fleet, named ''.  ``dispatch_tokens`` is the fused decode depth
    ``run()`` uses per dispatch; ``clock`` is the deadline time source;
    ``deadline_routing`` splits each precision's traffic across
    latency-class (deadline-bound) and throughput-class (bulk) fleets;
    ``accuracy_fleets`` lists the accuracy classes (SLOs) to provision
    fleets for, on top of the don't-care class."""

    def __init__(self, model: LM, params, *, slots: int, max_len: int,
                 pad_id: int = 0, chip_policy=None,
                 flops_per_token: Optional[float] = None,
                 dispatch_tokens: int = 8,
                 clock: Callable[[], float] = time.monotonic,
                 deadline_routing: bool = False,
                 accuracy_fleets: Tuple[float, ...] = (),
                 stop_tokens: Tuple[int, ...] = (), min_bucket: int = 8,
                 prefill_chunk: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None, tracer=None):
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")
            if model.cache_dtype != model.dtype:
                raise ValueError(
                    "chunked prefill reads KV history back from the cache "
                    "between chunks, so the cache dtype must equal the "
                    f"compute dtype (cache {model.cache_dtype} != compute "
                    f"{model.dtype})")
            if model.cfg.family in ("ssm", "hybrid"):
                # the chunked prefill resumes exactly only at the scan's
                # carry points: round the chunk up to them
                sc = max(int(model.cfg.ssm_scan_chunk), 1)
                prefill_chunk = -(-prefill_chunk // sc) * sc
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.pad_id = pad_id
        self.cfg = model.cfg
        self.chip_policy = chip_policy
        self.dispatch_tokens = dispatch_tokens
        self.min_bucket = min_bucket
        self.prefill_chunk = prefill_chunk
        self.prefill_token_budget = prefill_token_budget
        self.stop_tokens = tuple(int(s) for s in stop_tokens)
        self._stop_set = set(self.stop_tokens)
        self._clock = clock
        self._deadline_routing = deadline_routing
        self._accuracy_fleets = tuple(accuracy_fleets)
        self._precision = getattr(self.cfg, "numerics_precision", None)
        self.flops_per_token = _flops_per_token(self.cfg, flops_per_token)
        self._unit_energy_j: Dict[str, float] = {}
        self._prefill_pos: Dict[int, int] = {}  # slot -> tokens prefilled
        self._slot_pf_budget = [0] * slots  # decode budget armed on finish
        self.prefill_tokens = 0
        self.tokens_decoded = 0
        self.dispatches = 0
        self.host_syncs = 0
        self._stall_prefill_tokens = 0
        self._contended_decode_tokens = 0
        dev = model.device
        # ssm states integrate every prompt token, so bucket pads would
        # perturb them: the ssm and hybrid families batch at exact lengths
        self._bucketed = self.cfg.family not in ("ssm", "hybrid")
        cache = model.init_cache(slots, max_len)
        # a KV cache caps the per-slot length; a ring (sliding-window)
        # cache wraps and ssm states do not grow, so neither caps it
        self._len_cap = cache.data["k"].shape[2] \
            if "k" in cache.data and not model.ring else None
        # device-resident slot state
        self.cache = DecodeCache(cache.data, torch.zeros(
            slots, dtype=torch.int64, device=dev))
        self._next_tok = torch.full((slots, 1), pad_id, dtype=torch.int64,
                                    device=dev)
        self._budget = torch.zeros(slots, dtype=torch.int64, device=dev)
        self._active_mask = torch.zeros(slots, dtype=torch.bool, device=dev)
        # host-side slot table, fleet plan and per-fleet queues
        self._active: List[Optional[Request]] = [None] * slots
        self._slot_quota = [0] * slots  # 1 + device budget per slot
        # committed tokens a re-admitted continuation still has to replay
        # through the decode path before commits resume
        self._slot_replay = [0] * slots
        self.finished: List[Request] = []
        self.rejected: List[Request] = []
        #: fleets taken out of service: admission never routes to them
        self._out_of_service: set = set()
        #: drained requests with no fleet in service to re-route to: parked
        #: (never dropped) until capacity returns
        self._parked: List[Request] = []
        if chip_policy is None:
            self._fleets: Dict[str, Tuple[int, ...]] = {
                "": tuple(range(slots))}
            self._fleet_units: Dict[str, object] = {"": None}
        else:
            self._fleets = chip_policy.slot_fleets(
                slots, deadline_routing=deadline_routing,
                accuracy_slos=(None,) + self._accuracy_fleets)
            self._fleet_units = {name: chip_policy.spec.unit(name)
                                 for name in self._fleets}
        self._queues: Dict[str, List[Request]] = {name: []
                                                  for name in self._fleets}
        self._slot_fleet = {s: name for name, ids in self._fleets.items()
                            for s in ids}
        self.tracer = tracer if tracer is not None else NULL_TRACER
        #: die/site label stamped on spans and metric samples (a router
        #: above several engines sets it to the die's name)
        self.trace_site = ""
        self.reset_run_counters()

    # ------------------------------------------------------ chip telemetry
    def _charge_unit(self, req: Request, unit, flops: float,
                     phase: str = "decode") -> None:
        """Account ``flops`` on ``unit`` (bulk form, at dispatch
        boundaries), at the unit's current health pricing.  The single
        energy choke point: every prefill and decode charge flows through
        here."""
        if self.chip_policy is None or not flops or unit is None:
            return
        e_j = self.chip_policy.unit_energy_j(unit, flops)
        req.energy_j += e_j
        req.unit_energy_j[unit.name] = \
            req.unit_energy_j.get(unit.name, 0.0) + e_j
        self._unit_energy_j[unit.name] = \
            self._unit_energy_j.get(unit.name, 0.0) + e_j
        if self.tracer.enabled:
            self.tracer.charge(req.uid, unit.name, e_j, flops,
                               self._clock(), phase=phase)

    def _prefill_unit(self, req: Request):
        if self.chip_policy is None:
            return None
        return self.chip_policy.unit_for_phase(
            "prefill", precision=req.precision or self._precision)

    # ------------------------------------------------------------ counters
    def _totals(self) -> Dict[str, float]:
        return dict(tokens_decoded=self.tokens_decoded,
                    prefill_tokens=self.prefill_tokens,
                    dispatches=self.dispatches, host_syncs=self.host_syncs,
                    energy_j=sum(self._unit_energy_j.values()))

    def reset_run_counters(self) -> None:
        """Zero the decode-stall inputs and snapshot the cumulative counters
        so ``run_report()`` gives this run's deltas (``run()`` calls it)."""
        self._stall_prefill_tokens = 0
        self._contended_decode_tokens = 0
        self._run_base = self._totals()

    def run_report(self) -> Dict[str, float]:
        """Counters scoped to the current run."""
        out = {k: v - self._run_base[k] for k, v in self._totals().items()}
        out["decode_stall_frac"] = self.decode_stall_frac
        return out

    def energy_report(self) -> Dict[str, object]:
        """Chip-level energy over everything served so far (cumulative
        across runs; ``run_report()`` has the per-run delta)."""
        total = sum(self._unit_energy_j.values())
        return dict(
            chip=self.chip_policy.spec.name if self.chip_policy else None,
            total_j=total,
            per_unit_j=dict(self._unit_energy_j),
            tokens_decoded=self.tokens_decoded,
            j_per_token=(total / self.tokens_decoded
                         if self.tokens_decoded else 0.0))

    def fleet_report(self) -> Dict[str, Dict[str, object]]:
        """Per-fleet slot allocation and queue depth."""
        return {name or "(default)": dict(
            unit=name or None, slots=list(ids),
            queued=len(self._queues[name]),
            in_service=self._fleet_in_service(name),
            active=sum(1 for s in ids if self._active[s] is not None))
            for name, ids in self._fleets.items()}

    def load_report(self) -> Dict[str, float]:
        """Instantaneous load for routing across engines: queued, seated
        and parked request counts and the token backlog (the remaining
        prefill + decode tokens of the seated and queued requests),
        normalised by the slots still in service.  Host bookkeeping only:
        no device sync."""
        queued = sum(len(q) for q in self._queues.values())
        active_tokens = 0
        active = 0
        for s, req in enumerate(self._active):
            if req is None:
                continue
            active += 1
            active_tokens += max(self._slot_quota[s] - len(req.output), 0)
            if s in self._prefill_pos:  # prompt tokens still to prefill
                active_tokens += len(req.prompt) - self._prefill_pos[s]
        queued_tokens = sum(len(r.prompt) + r.max_new_tokens
                            for q in self._queues.values() for r in q)
        serving_slots = sum(len(ids) for n, ids in self._fleets.items()
                            if self._fleet_in_service(n))
        backlog = active_tokens + queued_tokens
        return dict(queued=queued, active=active, parked=len(self._parked),
                    slots=self.slots, serving_slots=serving_slots,
                    backlog_tokens=backlog,
                    load=backlog / max(serving_slots, 1))

    def evacuate(self) -> List[Request]:
        """Release every in-flight, queued and parked request untouched
        (partial output and energy kept, device lanes deactivated) and hand
        them back: a whole-die drain.  They are continuations: ``requeue``
        on any server sharing this model and parameters replays their
        committed tokens through the decode path and resumes them."""
        out: List[Request] = []
        released: List[int] = []
        for s, req in enumerate(self._active):
            if req is not None:
                out.append(req)
                released.append(s)
        self._release_slots(released)
        for name in self._queues:
            out.extend(self._queues[name])
            self._queues[name] = []
        out.extend(self._parked)
        self._parked = []
        return out

    def take_parked(self) -> List[Request]:
        """Hand over the parked requests (drained with no fleet in service)
        for placement elsewhere."""
        parked, self._parked = self._parked, []
        return parked

    # ------------------------------------------------------------ routing
    def _fleet_in_service(self, name: str) -> bool:
        """A fleet is routable when the engine has not taken it out of
        service and the chip's health model still lists its unit as
        serving."""
        if name in self._out_of_service:
            return False
        if self.chip_policy is not None \
                and self._fleet_units.get(name) is not None:
            return self.chip_policy.in_service(name)
        return True

    def _serving_fleets(self) -> List[str]:
        return [n for n in self._fleets if self._fleet_in_service(n)]

    def _route(self, req: Request) -> str:
        """Admission routing: which fleet serves this request's decode."""
        if self.chip_policy is None:
            return self._degrade_route(req)
        deadline_class = None
        if self._deadline_routing:
            deadline_class = ("interactive" if req.deadline_s is not None
                              else "bulk")
        try:
            unit = self.chip_policy.admission_unit(
                precision=req.precision or self._precision,
                deadline_class=deadline_class,
                accuracy_slo=req.accuracy_slo)
        except UnitFault:  # every unit out of service: degrade below
            unit = None
        if unit is not None and unit.name in self._fleets \
                and self._fleet_in_service(unit.name):
            return unit.name
        return self._degrade_route(req)

    def _degrade_route(self, req: Request) -> str:
        """Degrade-don't-drop re-resolution against the provisioned,
        in-service fleets — used when the chip routed a unit no fleet was
        provisioned for, or the preferred fleet is out of service.

        Same-precision fleets first when any survive; then the cheapest
        fleet whose unit meets the request's accuracy requirement (its
        ``accuracy_slo``, else the native error of its requested
        precision); else the most accurate survivor.  With no fleet in
        service there is nothing to degrade to: ``UnitFault``."""
        units = [(n, u) for n, u in self._fleet_units.items()
                 if u is not None and self._fleet_in_service(n)]
        if not units:
            alive = self._serving_fleets()
            if alive:  # fleets without chip units (no-policy engines)
                return alive[0]
            raise UnitFault(
                f"request {req.uid}: no serving fleet in service "
                f"(out of service: {sorted(self._out_of_service)})")
        want_p = req.precision or self._precision
        if want_p is not None:
            same_p = [(n, u) for n, u in units
                      if u.design.precision == want_p]
            units = same_p or units
        ceiling = req.accuracy_slo
        if ceiling is None and req.precision is not None:
            # across precisions, a surviving unit at least as accurate as
            # the requested precision's native format is legal (validate
            # admitted only precisions fabricated on the die)
            from repro_torch.numerics import (DEFAULT_ACCURACY_MODEL,
                                              native_format)
            ceiling = DEFAULT_ACCURACY_MODEL.rel_err(
                native_format(req.precision), "fused")
        pol = self.chip_policy

        def cost(nu):  # health-repriced pJ/FLOP: throttled fleets cost more
            return nu[1].e_per_flop_pj * pol.unit_energy_scale(nu[0])

        if ceiling is not None:
            ok = [(n, u) for n, u in units if u.rel_err() <= ceiling]
            if ok:
                return min(ok, key=cost)[0]
            return min(units, key=lambda nu: nu[1].rel_err())[0]
        return min(units, key=cost)[0]

    @property
    def decode_stall_frac(self) -> float:
        """Over the steps that prefilled while decode-ready lanes existed:
        prefill tokens / (prefill + decode tokens) of those steps."""
        tot = self._stall_prefill_tokens + self._contended_decode_tokens
        return self._stall_prefill_tokens / max(tot, 1)

    # ---------------------------------------------------------- validation
    def _reject(self, req: Request, code: str, reason: str):
        req.rejected = True
        req.reject_reason = f"[{code}] {reason}"
        self.rejected.append(req)
        if self.tracer.enabled:
            now = self._clock()
            self.tracer.request_begin(req.uid, now)
            self.tracer.event(req.uid, TraceEvent.REJECT, now, code=code,
                              site=self.trace_site)
            self.tracer.end_attempt(req.uid, now, "rejected")
            self.tracer.end_request(req.uid, now, "rejected")
        raise RequestRejected(req, code, reason)

    def validate(self, req: Request) -> None:
        """Raises ``RequestRejected`` (and records it) on the first
        violation."""
        n = req.max_new_tokens
        if not isinstance(n, (int, np.integer)) or n < 1:
            self._reject(req, "bad_max_tokens",
                         f"max_new_tokens must be a positive int, got {n!r}")
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            self._reject(req, "bad_prompt",
                         f"prompt must be a non-empty 1-D int array, got "
                         f"shape {prompt.shape}")
        if not np.issubdtype(prompt.dtype, np.integer):
            self._reject(req, "bad_prompt",
                         f"prompt dtype must be integer, got {prompt.dtype}")
        if self._len_cap is not None and len(prompt) > self._len_cap:
            self._reject(req, "prompt_too_long",
                         f"prompt length {len(prompt)} exceeds the engine "
                         f"cache capacity {self._len_cap}")
        if req.accuracy_slo is not None and req.accuracy_slo <= 0:
            self._reject(req, "bad_accuracy_slo",
                         f"accuracy_slo must be > 0, got {req.accuracy_slo}")
        if self.chip_policy is not None:
            die = self.chip_policy.spec.units
            if req.precision is not None:
                have = sorted({u.design.precision for u in die})
                if req.precision not in have:
                    self._reject(req, "unknown_precision",
                                 f"precision {req.precision!r} is not "
                                 f"fabricated on chip "
                                 f"{self.chip_policy.spec.name!r} "
                                 f"(have {have})")
            if req.accuracy_slo is not None:
                best = min(u.rel_err() for u in die)
                if best > req.accuracy_slo:
                    self._reject(
                        req, "accuracy_slo_unmeetable",
                        f"no unit on chip {self.chip_policy.spec.name!r} "
                        f"meets accuracy_slo={req.accuracy_slo:g} (best "
                        f"achievable rel_err={best:g})")

    def set_fleet_in_service(self, name: str, in_service: bool) -> None:
        if name not in self._fleets:
            raise KeyError(f"no fleet {name!r}; have {sorted(self._fleets)}")
        if in_service:
            self._out_of_service.discard(name)
        else:
            self._out_of_service.add(name)

    def submit(self, req: Request):
        """Validate, route (``UnitFault`` when no fleet is in service) and
        queue a request on its fleet."""
        self.validate(req)
        if req.submitted_s is None:  # continuations keep their origin
            req.submitted_s = self._clock()
        fleet = self._route(req)
        self._check_admission(req, fleet)
        if self.chip_policy is not None:
            req.routed_unit = fleet
        self._queues[fleet].append(req)
        if self.tracer.enabled:
            self._trace_admit(req, fleet)

    def _check_admission(self, req: Request, fleet: str) -> None:
        """Hook between routing and queueing: raise ``RequestRejected``
        to refuse the request on ``fleet``.  Admits everything here."""

    def _trace_admit(self, req: Request, fleet: str) -> None:
        self.tracer.request_begin(
            req.uid, req.submitted_s,
            prompt_tokens=int(np.asarray(req.prompt).size),
            max_new_tokens=req.max_new_tokens, precision=req.precision,
            accuracy_slo=req.accuracy_slo, deadline_s=req.deadline_s)
        self.tracer.event(req.uid, TraceEvent.ADMIT, self._clock(),
                          site=self.trace_site, fleet=fleet)

    def _bucket(self, n: int) -> int:
        if not self._bucketed:
            return n
        b = bucket_length(n, lo=self.min_bucket)
        return b if self._len_cap is None else min(b, self._len_cap)

    def _finish(self, req: Request):
        req.done = True
        self.finished.append(req)
        if self.tracer.enabled:
            now = self._clock()
            status = "expired" if req.expired else "ok"
            self.tracer.event(
                req.uid, TraceEvent.EXPIRE if req.expired
                else TraceEvent.FINISH, now, site=self.trace_site,
                tokens_out=len(req.output))
            self.tracer.end_attempt(req.uid, now, status)
            self.tracer.end_request(req.uid, now, status)

    def _expire(self, req: Request):
        req.expired = True
        self._finish(req)

    def _deactivate(self, slots: List[int]) -> None:
        if slots:
            idx = torch.as_tensor(slots, device=self._active_mask.device)
            self._active_mask[idx] = False

    # ------------------------------------------------ drain / re-admission
    def _release_slots(self, slots: List[int]) -> None:
        """Free the engine's and the device's slot state without touching
        the requests."""
        tr = self.tracer
        for s in slots:
            req = self._active[s]
            if req is not None and tr.enabled:
                now = self._clock()
                tr.event(req.uid, TraceEvent.DRAIN, now,
                         site=self.trace_site, slot=s)
                tr.end_attempt(req.uid, now, "drained")
            self._active[s] = None
            self._slot_replay[s] = 0
            self._prefill_pos.pop(s, None)
        self._deactivate(slots)

    def requeue(self, req: Request) -> str:
        """Re-admit an in-flight request as a continuation: re-routed
        (health-aware) to a surviving fleet and queued at the front
        (drained traffic outranks new arrivals).  On admission the new
        fleet re-prefills the prompt and replays the committed tokens
        through the decode path, the computation that produced them, so
        the stream resumes as it would have gone on (re-prefilling prompt
        and output instead would cross from the decode path's numerics to
        the prefill path's).  With no fleet in service the request is
        parked, never dropped; the next admission with capacity back
        re-routes it.  Returns the new fleet ('' when parked)."""
        req.requeues += 1
        try:
            fleet = self._route(req)
        except UnitFault:
            self._parked.append(req)
            if self.tracer.enabled:
                self.tracer.event(req.uid, TraceEvent.PARK, self._clock(),
                                  site=self.trace_site)
            return ""
        if self.chip_policy is not None:
            req.routed_unit = fleet
        self._queues[fleet].insert(0, req)
        if self.tracer.enabled:
            self.tracer.event(req.uid, TraceEvent.REQUEUE, self._clock(),
                              site=self.trace_site, fleet=fleet,
                              requeues=req.requeues)
        return fleet

    def drain_fleet(self, name: str, *, requeue: bool = True
                    ) -> List[Request]:
        """Take a fleet out of service and drain it: the requests on its
        slots are released (device lanes deactivated, partial energy kept)
        and, with ``requeue``, re-admitted as continuations on the
        cheapest surviving fleet that still meets their precision and
        accuracy class; its queued requests are re-routed the same way.
        ``requeue=False`` force-drains: the requests finish as expired with
        what they produced.  Returns the requests affected."""
        self.set_fleet_in_service(name, False)
        affected: List[Request] = []
        released: List[int] = []
        for s in self._fleets[name]:
            req = self._active[s]
            if req is None:
                continue
            affected.append(req)
            released.append(s)
        self._release_slots(released)
        queued, self._queues[name] = self._queues[name], []
        affected.extend(queued)
        for req in affected:
            if requeue:
                self.requeue(req)
            else:
                self._expire(req)
        return affected

    def _unpark(self):
        """Re-route the parked requests now that capacity may be back."""
        if not self._parked:
            return
        parked, self._parked = self._parked, []
        for req in parked:
            try:
                fleet = self._route(req)
            except UnitFault:
                self._parked.append(req)
                continue
            if self.chip_policy is not None:
                req.routed_unit = fleet
            self._queues[fleet].insert(0, req)
            if self.tracer.enabled:
                self.tracer.event(req.uid, TraceEvent.UNPARK,
                                  self._clock(), site=self.trace_site,
                                  fleet=fleet)

    def _expire_active(self, now: float):
        """Release slots whose request expired before this step."""
        released = []
        for s, req in enumerate(self._active):
            if req is not None and req.deadline_s is not None \
                    and now > req.deadline_s:
                self._expire(req)
                self._active[s] = None
                self._prefill_pos.pop(s, None)
                released.append(s)
        self._deactivate(released)

    def idle(self) -> bool:
        """Nothing queued, parked or seated."""
        return not self._parked \
            and all(not q for q in self._queues.values()) \
            and all(r is None for r in self._active)

    def _budget_for(self, req: Request) -> int:
        """Device decode budget: the tokens after the first, capped by the
        cache capacity where there is one."""
        cap = req.max_new_tokens - 1
        if self._len_cap is not None:
            cap = min(cap, self._len_cap - len(req.prompt))
        return max(cap, 0)

    def _commit_first(self, req: Request, slot: int, first: int,
                      budget: int, now: float) -> bool:
        """Commit the token the prompt's last logits produced; returns True
        when the request is finished by it (zero budget or a first-token
        stop), which the caller must free on the device.  A continuation
        (a request with committed tokens) commits nothing here: the
        prefill recomputed its first token, and the decode path replays
        the rest before commits resume."""
        self.tokens_decoded += 1
        replay = len(req.output)
        if not replay:
            req.output.append(first)
            if req.first_token_s is None:
                req.first_token_s = now
            if self.tracer.enabled:
                self.tracer.event(req.uid, TraceEvent.DECODE_DISPATCH, now,
                                  tokens=1, slot=slot, first=True)
        if budget == 0 or (not replay and first in self._stop_set):
            self._finish(req)
            return True
        self._slot_replay[slot] = max(replay - 1, 0)
        return False

    # ---------------------------------------------------------- admission
    def _arm(self, slots: List[int], first, budgets: List[int]) -> None:
        """Arm the decode state of lanes whose prompt is complete."""
        dev = self._budget.device
        idx = torch.as_tensor(slots, device=dev)
        b = torch.as_tensor(budgets, dtype=torch.int64, device=dev)
        self._next_tok[idx, 0] = first
        self._budget[idx] = b
        self._active_mask[idx] = b > 0

    def _admit(self, now: float) -> int:
        """Per in-service fleet: seat its queue in its own slots.  Returns
        the number of batches prefilled."""
        self._unpark()
        batches = 0
        for fleet, slot_ids in self._fleets.items():
            if not self._fleet_in_service(fleet):
                continue
            queue = self._queues[fleet]
            while queue:
                free = [s for s in slot_ids if self._active[s] is None]
                if not free:
                    break
                batch: List[Request] = []
                bucket = None
                i = 0
                while i < len(queue) and len(batch) < len(free):
                    req = queue[i]
                    if req.deadline_s is not None and now > req.deadline_s:
                        queue.pop(i)
                        self._expire(req)  # expired in queue: zero work
                        continue
                    b = self._bucket(len(req.prompt))
                    if bucket is None:
                        bucket = b
                    if b == bucket:  # batched same-bucket admission
                        batch.append(queue.pop(i))
                        continue
                    i += 1
                if not batch:
                    break
                self._admit_batch(batch, free[:len(batch)], bucket)
                batches += 1
        return batches

    def _admit_batch(self, reqs: List[Request], slot_ids: List[int],
                     bucket: int):
        dev = self.model.device
        tokens = np.full((len(reqs), bucket), self.pad_id, np.int64)
        true_lens = np.array([len(r.prompt) for r in reqs], np.int64)
        for j, req in enumerate(reqs):
            tokens[j, :len(req.prompt)] = np.asarray(req.prompt)
        budgets = [self._budget_for(r) for r in reqs]
        with scope("serve.prefill", self.tracer, dev, bucket=bucket,
                   rows=len(reqs)) as sc:
            if sc.on:
                self._prefill_attrs(sc, reqs, [0] * len(reqs),
                                    int(true_lens.sum()), bucket)
            last_logits, kv, states = self.model.prefill_batched(
                self.params, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(true_lens).to(dev))
            first = torch.argmax(last_logits, dim=-1)
            ids = torch.as_tensor(slot_ids, device=dev)
            data = self.cache.data
            with scope("serve.cache_write", self.tracer, rows=len(reqs),
                       bucket=bucket):
                if kv is not None:
                    self._write_kv(data, ids, kv, true_lens, bucket)
                if states is not None:
                    data["conv"][:, ids] = states[0]
                    data["h"][:, ids] = states[1]
            self.cache.length[ids] = torch.from_numpy(true_lens).to(dev)
            self._arm(slot_ids, first, budgets)
            first = first.tolist()  # one host sync per admitted batch
        self.host_syncs += 1
        now = self._clock()
        dead = []
        tr = self.tracer
        for req, slot, f, budget in zip(reqs, slot_ids, first, budgets):
            if tr.enabled:
                tr.begin_attempt(req.uid, now, site=self.trace_site,
                                 fleet=self._slot_fleet.get(slot, ""),
                                 slot=slot)
                tr.event(req.uid, TraceEvent.SEAT, now, slot=slot)
                tr.event(req.uid, TraceEvent.PREFILL, now,
                         tokens=len(req.prompt), bucket=bucket, slot=slot)
                tr.count("bucket_hit", now,
                         1.0 if bucket == len(req.prompt) else 0.0,
                         self.trace_site)
            # the prompt's forward pass, including the logits that give the
            # first token: decode charges start with the first decode step
            self._charge_unit(req, self._prefill_unit(req),
                              self.flops_per_token * len(req.prompt),
                              phase="prefill")
            self.prefill_tokens += len(req.prompt)
            if self._commit_first(req, slot, f, budget, now):
                dead.append(slot)
            else:
                self._active[slot] = req
                self._slot_quota[slot] = 1 + budget
        self._deactivate(dead)

    def _write_kv(self, data, ids, kv, true_lens: np.ndarray,
                  bucket: int) -> None:
        """Scatter a batch's prefill K/V into its cache lanes."""
        smax = data["k"].shape[2]
        if bucket <= smax:
            data["k"][:, ids, :bucket] = kv[0]
            data["v"][:, ids, :bucket] = kv[1]
            return
        # only a ring is narrower than its bucket: keep the window tail,
        # ring-aligned so position p sits at slot p % smax; a shorter
        # prompt's clipped slots stay masked until decode overwrites them
        dev = data["k"].device
        j = torch.arange(smax, device=dev)
        base = torch.from_numpy(true_lens).to(dev)[:, None] - smax
        pos = (base + (j[None, :] - base) % smax).clamp(0, bucket - 1)
        idx = pos[None, :, :, None, None]
        data["k"][:, ids] = torch.take_along_dim(kv[0], idx, dim=2)
        data["v"][:, ids] = torch.take_along_dim(kv[1], idx, dim=2)

    def _prefill_attrs(self, sc, reqs: List[Request], offsets: List[int],
                       real: int, width: int) -> None:
        """A prefill scope's token counts (``padded_tokens`` = rows x
        width - real) and ``waited_s``: for each row that starts its
        prompt and has no first token yet, the engine clock's time since
        it was submitted."""
        now = self._clock()
        sc.set(real_tokens=real, padded_tokens=len(reqs) * width - real,
               waited_s=[now - r.submitted_s for r, off in zip(reqs, offsets)
                         if off == 0 and r.first_token_s is None])

    # --------------------------------------- continuous batching scheduler
    def _seat(self, now: float):
        """Move queued requests into their fleet's free lanes immediately
        (FIFO per in-service fleet) without device work; seated lanes
        prefill chunk by chunk."""
        self._unpark()
        for fleet, slot_ids in self._fleets.items():
            if not self._fleet_in_service(fleet):
                continue
            queue = self._queues[fleet]
            free = [s for s in slot_ids if self._active[s] is None]
            while queue and free:
                req = queue.pop(0)
                if req.deadline_s is not None and now > req.deadline_s:
                    self._expire(req)
                    continue
                slot = free.pop(0)
                self._active[slot] = req
                self._prefill_pos[slot] = 0
                self._slot_pf_budget[slot] = self._budget_for(req)
                self._slot_quota[slot] = 1 + self._slot_pf_budget[slot]
                if self.tracer.enabled:
                    self.tracer.begin_attempt(
                        req.uid, now, site=self.trace_site,
                        fleet=self._slot_fleet.get(slot, ""), slot=slot)
                    self.tracer.event(req.uid, TraceEvent.SEAT, now,
                                      slot=slot)

    def _advance_prefills(self, now: float) -> int:
        """Advance every mid-prefill lane by one chunk, grouped by padded
        chunk width (the final partial chunk pads up to a pow2 bucket; ssm
        and hybrid chunks stay exact length, since the conv carry
        integrates raw inputs).  A lane whose chunk completes its prompt is
        armed for decode and its first token committed (one host sync, only
        on such steps).  Returns the number of chunk groups."""
        C = self.prefill_chunk
        lanes = sorted(self._prefill_pos)

        def clen_of(s):
            return min(C, len(self._active[s].prompt) - self._prefill_pos[s])

        if self.prefill_token_budget is not None and lanes:
            kept, total = [], 0
            for s in lanes:  # whole chunks in lane order, always >= 1
                if kept and total + clen_of(s) > self.prefill_token_budget:
                    break
                kept.append(s)
                total += clen_of(s)
            lanes = kept
        groups: Dict[int, List[int]] = {}
        for s in lanes:
            cb = min(bucket_length(clen_of(s), lo=self.min_bucket), C) \
                if self._bucketed else clen_of(s)
            groups.setdefault(cb, []).append(s)
        dev = self.model.device
        for cb, slots in sorted(groups.items()):
            tokens = np.full((len(slots), cb), self.pad_id, np.int64)
            offs, clens, finals = [], [], []
            for j, s in enumerate(slots):
                p = np.asarray(self._active[s].prompt)
                off, clen = self._prefill_pos[s], clen_of(s)
                tokens[j, :clen] = p[off:off + clen]
                offs.append(off)
                clens.append(clen)
                if off + clen == len(p):
                    finals.append(j)
            with scope("serve.prefill", self.tracer, dev, bucket=cb,
                       rows=len(slots)) as sc:
                if sc.on:
                    self._prefill_attrs(sc, [self._active[s] for s in slots],
                                        offs, sum(clens), cb)
                last_logits, self.cache = self.model.prefill_chunk(
                    self.params, self.cache,
                    torch.from_numpy(tokens).to(dev), offs, clens, slots)
                first = None
                if finals:
                    fin_slots = [slots[j] for j in finals]
                    first = torch.argmax(last_logits[finals], dim=-1)
                    self._arm(fin_slots, first,
                              [self._slot_pf_budget[s] for s in fin_slots])
                    first = dict(zip(finals, first.tolist()))  # host sync
            if finals:
                self.host_syncs += 1
            dead = []
            for j, s in enumerate(slots):
                req = self._active[s]
                self.prefill_tokens += clens[j]
                self._charge_unit(req, self._prefill_unit(req),
                                  self.flops_per_token * clens[j],
                                  phase="prefill")
                if self.tracer.enabled:
                    self.tracer.event(req.uid, TraceEvent.PREFILL_CHUNK, now,
                                      tokens=clens[j], offset=offs[j],
                                      slot=s)
                    self.tracer.count("bucket_hit", now,
                                      1.0 if cb == clens[j] else 0.0,
                                      self.trace_site)
                if j not in finals:
                    self._prefill_pos[s] = offs[j] + clens[j]
                    continue
                del self._prefill_pos[s]
                if self._commit_first(req, s, first[j],
                                      self._slot_pf_budget[s], now):
                    self._active[s] = None
                    dead.append(s)
            self._deactivate(dead)
        return len(groups)

    def _filter_dispatch(self, active_slots: List[int], toks_np: np.ndarray,
                         emitted_np: np.ndarray, now: float,
                         dispatch_dt_s: float
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """The hook between a dispatch's fetch and its commit.  The base
        engine is fault-free: the identity.  ``ResilientServer`` applies
        the injected fault symptoms here, feeds its health monitor and may
        drain slots, which the commit loop then skips."""
        return toks_np, emitted_np

    def _sample_metrics(self, now: float, n_seated: int,
                        decode_lanes: int) -> None:
        """One step's gauge samples into the tracer's timelines (recording
        tracers only: ``step`` guards the call)."""
        tr = self.tracer
        site = self.trace_site
        slots = max(self.slots, 1)
        tr.count("occupancy", now, n_seated / slots, site)
        tr.count("decode_occupancy", now, decode_lanes / slots, site)
        tr.count("prefill_occupancy", now,
                 len(self._prefill_pos) / slots, site)
        queued = sum(len(q) for q in self._queues.values())
        tr.count("queued", now, float(queued), site)
        tr.count("backlog_tokens", now,
                 float(sum(len(r.prompt) + r.max_new_tokens
                           for q in self._queues.values() for r in q)),
                 site)
        tr.count("decode_stall_frac", now, self.decode_stall_frac, site)
        for name, ids in self._fleets.items():
            seated = sum(1 for s in ids if self._active[s] is not None)
            tr.count(f"fleet_util.{name or 'default'}", now,
                     seated / max(len(ids), 1), site)

    # ------------------------------------------------------------ decoding
    def step(self, max_tokens: Optional[int] = None) -> int:
        """One scheduler step: admission (monolithic, or a chunked-prefill
        advance), then one fused decode dispatch over the decode-ready
        slots (up to ``max_tokens`` tokens each, default 1).  Returns the
        number of seated slots."""
        with scope("serve.step", self.tracer) as sc:
            now = self._clock()
            self._expire_active(now)
            decode_ready = sum(
                1 for s, r in enumerate(self._active)
                if r is not None and s not in self._prefill_pos)
            pf0 = self.prefill_tokens
            with scope("serve.admit", self.tracer) as adm:
                if self.prefill_chunk is not None:
                    self._seat(now)
                    batches = self._advance_prefills(now)
                else:
                    batches = self._admit(now)
                adm.set(batches=batches)
            pf_delta = self.prefill_tokens - pf0
            contended = decode_ready > 0 and pf_delta > 0
            if contended:
                self._stall_prefill_tokens += pf_delta
            n_seated = sum(1 for r in self._active if r is not None)
            active_slots = [s for s, r in enumerate(self._active)
                            if r is not None and s not in self._prefill_pos]
            sc.set(seated=n_seated, decode_lanes=len(active_slots))
            if self.tracer.enabled:
                self._sample_metrics(now, n_seated, len(active_slots))
            if active_slots:
                n = 1 if max_tokens is None else max(1, int(max_tokens))
                self._dispatch(active_slots, n, contended)
            return n_seated

    def _dispatch(self, active_slots: List[int], n: int,
                  contended: bool) -> None:
        """One fused decode dispatch of ``n`` steps over ``active_slots``:
        the device scan, the fetch, the dispatch filter and the commit."""
        t_dispatch = time.perf_counter()
        with scope("serve.decode", self.tracer, self.model.device,
                   lanes=len(active_slots), steps=n):
            (self.cache, self._next_tok, self._active_mask, self._budget,
             toks, emitted) = self.model.decode_scan(
                self.params, self.cache, self._next_tok, self._active_mask,
                self._budget, n, pad_id=self.pad_id,
                stop_tokens=self.stop_tokens)
            # the host sync: one fetch per N-token dispatch
            fetched = torch.stack([toks, emitted.to(toks.dtype)]) \
                .cpu().numpy()
        toks_np, emitted_np = fetched[0], fetched[1].astype(bool)
        self.dispatches += 1
        self.host_syncs += 1
        now = self._clock()
        toks_np, emitted_np = self._filter_dispatch(
            active_slots, toks_np, emitted_np, now,
            time.perf_counter() - t_dispatch)
        with scope("serve.commit", self.tracer) as cm:
            decode_emitted = self._commit(active_slots, toks_np, emitted_np,
                                          n, now)
            cm.set(tokens=decode_emitted)
        if contended:
            self._contended_decode_tokens += decode_emitted

    def _commit(self, active_slots: List[int], toks_np: np.ndarray,
                emitted_np: np.ndarray, n: int, now: float) -> int:
        """Commit a dispatch's fetched tokens to their requests, finish and
        release lanes; returns the tokens emitted."""
        released = []
        decode_emitted = 0
        for slot in active_slots:
            req = self._active[slot]
            if req is None:  # drained by the dispatch filter
                continue
            count = int(emitted_np[:, slot].sum())
            decode_emitted += count
            if self.tracer.enabled and count:
                self.tracer.event(req.uid, TraceEvent.DECODE_DISPATCH, now,
                                  tokens=count, slot=slot)
            for t in toks_np[:count, slot]:  # a lane emits a prefix
                if self._slot_replay[slot]:
                    # a continuation's replay: the decode path recomputed
                    # a token already committed
                    self._slot_replay[slot] -= 1
                else:
                    req.output.append(int(t))
            self.tokens_decoded += count
            self._charge_unit(req, self._fleet_units.get(req.routed_unit),
                              self.flops_per_token * count)
            if count < n or len(req.output) >= self._slot_quota[slot] \
                    or (count and int(toks_np[count - 1, slot])
                        in self._stop_set):
                # budget exhausted on the device, or the lane sampled a stop
                # token; quota < max_new_tokens means the cache capacity
                # truncated the request
                self._finish(req)
            if not req.done and req.deadline_s is not None \
                    and now > req.deadline_s:
                # expired during this dispatch: its tokens stay, the slot
                # is released for queued traffic
                self._expire(req)
                released.append(slot)
            if req.done:
                self._active[slot] = None
        self._deactivate(released)
        return decode_emitted

    def run(self, max_steps: int = 10_000,
            dispatch_tokens: Optional[int] = None) -> List[Request]:
        """Serve until the queue and slots drain (or ``max_steps`` steps);
        returns the requests finished (including expired) since the last
        ``run`` call."""
        self.reset_run_counters()
        n = self.dispatch_tokens if dispatch_tokens is None \
            else dispatch_tokens
        for _ in range(max_steps):
            if self.idle():
                break
            self.step(n)
        out, self.finished = self.finished, []
        return out


class ReferenceServer:
    """The per-token engine: one host sync and one ``ChipPolicy`` charge
    per decoded token, one eager prefill per admitted prompt, the slot's
    whole cache lane rewritten at each admission.  Kept as the baseline
    the batched engine's tokens and energy are held to.
    ``flops_per_token`` as ``BatchedServer``'s."""

    def __init__(self, model: LM, params, *, slots: int, max_len: int,
                 pad_id: int = 0, chip_policy=None,
                 flops_per_token: Optional[float] = None):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.pad_id = pad_id
        self.cfg = model.cfg
        self.chip_policy = chip_policy
        self._precision = getattr(self.cfg, "numerics_precision", None)
        self.flops_per_token = _flops_per_token(self.cfg, flops_per_token)
        self.tokens_decoded = 0
        self._unit_energy_j: Dict[str, float] = {}
        self._queue: List[Request] = []
        self._active: List[Optional[Request]] = [None] * slots
        self.finished: List[Request] = []
        self.cache = model.init_cache(slots, max_len)
        self._slot_len = np.zeros(slots, np.int64)
        self._next_tok = np.full((slots, 1), pad_id, np.int64)

    def _charge(self, req: Request, phase: str, flops: float) -> None:
        """Account ``flops`` on the unit the chip routes ``phase`` to."""
        if self.chip_policy is None or not flops:
            return
        unit = self.chip_policy.unit_for_phase(phase,
                                               precision=self._precision)
        e_j = self.chip_policy.request_energy_j(phase, flops,
                                                precision=self._precision)
        req.energy_j += e_j
        req.unit_energy_j[unit.name] = \
            req.unit_energy_j.get(unit.name, 0.0) + e_j
        self._unit_energy_j[unit.name] = \
            self._unit_energy_j.get(unit.name, 0.0) + e_j

    def energy_report(self) -> Dict[str, object]:
        total = sum(self._unit_energy_j.values())
        return dict(
            chip=self.chip_policy.spec.name if self.chip_policy else None,
            total_j=total,
            per_unit_j=dict(self._unit_energy_j),
            tokens_decoded=self.tokens_decoded,
            j_per_token=(total / self.tokens_decoded
                         if self.tokens_decoded else 0.0))

    def submit(self, req: Request):
        self._queue.append(req)

    def _admit(self):
        dev = self.model.device
        for slot in range(self.slots):
            if self._active[slot] is None and self._queue:
                req = self._queue.pop(0)
                self._active[slot] = req
                if self.chip_policy is not None:
                    req.routed_unit = self.chip_policy.unit_for_phase(
                        "decode", precision=self._precision).name
                prompt = np.asarray(req.prompt, np.int64)
                last, cache1 = self.model.prefill(
                    self.params, torch.as_tensor(prompt[None], device=dev),
                    max_len=self.max_len)
                self._charge(req, "prefill",
                             self.flops_per_token * len(prompt))
                self._write_slot_cache(slot, cache1)
                self._slot_len[slot] = len(prompt)
                tok = int(torch.argmax(last, dim=-1)[0])
                req.output.append(tok)
                self.tokens_decoded += 1
                self._next_tok[slot, 0] = tok
                if len(req.output) >= req.max_new_tokens:
                    req.done = True
                    self.finished.append(req)
                    self._active[slot] = None

    def _write_slot_cache(self, slot: int, cache1) -> None:
        """Lane ``slot`` of the batched cache := the one-sequence cache
        (its positions beyond the prompt's cache zeroed)."""
        for name, dst in self.cache.data.items():
            src = cache1.data[name][:, 0]
            if name in ("k", "v") and src.shape[1] != dst.shape[2]:
                dst[:, slot].zero_()
                dst[:, slot, :src.shape[1]] = src
            else:
                dst[:, slot] = src

    def step(self) -> int:
        """One decode step over all active slots.  Returns #active."""
        self._admit()
        active = [s for s, r in enumerate(self._active) if r is not None]
        if not active:
            return 0
        dev = self.model.device
        cache = self.model.cache_at_length(self.cache, self._slot_len)
        logits, _ = self.model.decode_step(
            self.params, cache, torch.as_tensor(self._next_tok, device=dev))
        toks = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        now = time.monotonic()
        for slot in active:
            req = self._active[slot]
            self._slot_len[slot] += 1
            tok = int(toks[slot])
            req.output.append(tok)
            self.tokens_decoded += 1
            self._charge(req, "decode", self.flops_per_token)
            self._next_tok[slot, 0] = tok
            if req.deadline_s is not None and now > req.deadline_s:
                req.expired = True
                req.done = True
            if len(req.output) >= req.max_new_tokens:
                req.done = True
            if req.done:
                self.finished.append(req)
                self._active[slot] = None
        return len(active)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Serve until drained; returns the requests finished since the
        last ``run`` call."""
        for _ in range(max_steps):
            if not self._queue and all(r is None for r in self._active):
                break
            self.step()
        out, self.finished = self.finished, []
        return out


def greedy_decode(model: LM, params, prompt: np.ndarray, n_new: int,
                  max_len: Optional[int] = None,
                  stop_tokens: Tuple[int, ...] = ()) -> List[int]:
    """Single-sequence reference decoder on the model's device (tests
    compare the server against it).  ``stop_tokens``: decoding stops after
    emitting one (the stop token is included)."""
    stops = set(int(s) for s in stop_tokens)
    max_len = max_len or (len(prompt) + n_new)
    dev = model.device
    tokens = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=dev)
    last, cache = model.prefill(params, tokens, max_len=max_len)
    out = [int(torch.argmax(last, dim=-1)[0])]
    for _ in range(n_new - 1):
        if out[-1] in stops:
            break
        tok = torch.tensor([[out[-1]]], dtype=torch.int64, device=dev)
        logits, cache = model.decode_step(params, cache, tok)
        out.append(int(torch.argmax(logits[:, -1], dim=-1)[0]))
    return out
