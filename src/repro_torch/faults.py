"""Shared fault vocabulary of the port (counterpart of ``repro.faults``).

The paper's FPUs run at aggressive electrical points (near-threshold V_DD,
adaptive body bias) where units throttle, degrade or fail, so partial
failure is the steady state of a chip fleet.  This module defines the
fault types every layer agrees on:

  * ``SimulatedFailure``: the train-side whole-process crash;
  * ``UnitFault``: a unit-scoped serving fault surfaced to a caller that
    cannot recover;
  * ``FaultKind`` / ``FaultEvent``: the serve-side unit-scoped faults,
    ``KILL`` (the unit dies), ``THROTTLE`` (its frequency drops by
    ``magnitude``, repricing its energy) and ``CORRUPT`` (its outputs
    carry a NaN/Inf burst for the event's duration);
  * ``FaultInjector``: seeded and schedule-driven on the serving clock.
    The engine polls it at dispatch boundaries and it perturbs the
    *symptoms* (failed dispatches, inflated dispatch times, corrupted
    token fetches) that the ``HealthMonitor`` then has to detect; the
    injector never talks to the health model directly.  Its draws are
    numpy's, seeded as the JAX package's are, so a schedule and its
    corrupted token columns replay identically in either package.

``step_failure_schedule`` is the train-side schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class SimulatedFailure(RuntimeError):
    """Whole-process crash (train-side): triggers checkpoint-restart."""


class UnitFault(RuntimeError):
    """Unit-scoped serving fault surfaced to a caller that cannot recover
    (e.g. every unit on the die is dead)."""


# ---------------------------------------------------------------------------
# Fault kinds / events
# ---------------------------------------------------------------------------
class FaultKind:
    """Unit-scoped fault taxonomy (string constants, not an enum, so events
    serialize straight into JSON)."""

    KILL = "kill"          # unit dies: dispatches on it produce nothing
    THROTTLE = "throttle"  # freq derate by `magnitude` (0<m<1): repriced
    CORRUPT = "corrupt"    # numerics corruption: NaN/Inf burst in outputs

    ALL = (KILL, THROTTLE, CORRUPT)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``unit`` enters ``kind`` at ``at_s`` (serving
    clock) for ``duration_s`` (None/inf = permanent).  ``magnitude`` is the
    kind-specific severity: the frequency scale for THROTTLE (0.5 = half
    speed), the corrupted-lane fraction for CORRUPT (1.0 = every token)."""

    at_s: float
    unit: str
    kind: str
    duration_s: Optional[float] = None
    magnitude: float = 1.0

    def __post_init__(self):
        if self.kind not in FaultKind.ALL:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {FaultKind.ALL}")
        if self.kind == FaultKind.THROTTLE and not 0.0 < self.magnitude <= 1.0:
            raise ValueError("THROTTLE magnitude is the frequency scale and "
                             f"must be in (0, 1], got {self.magnitude}")

    @property
    def ends_s(self) -> float:
        return math.inf if self.duration_s is None \
            else self.at_s + self.duration_s

    def active_at(self, now: float) -> bool:
        return self.at_s <= now < self.ends_s

    def as_dict(self) -> Dict[str, object]:
        return dict(at_s=self.at_s, unit=self.unit, kind=self.kind,
                    duration_s=self.duration_s, magnitude=self.magnitude)


# ---------------------------------------------------------------------------
# The injector
# ---------------------------------------------------------------------------
class FaultInjector:
    """Seeded, schedule-driven fault injection for the serving engine.

    Construction either takes an explicit ``events`` schedule (the chaos
    harness's deterministic scenarios) or draws one from ``random_faults``.
    The engine polls symptoms per dispatch:

      * ``killed(unit, now)`` — unit produces nothing this dispatch;
      * ``time_scale(unit, now)`` — dispatch wall-time inflation (1/freq
        scale while a THROTTLE event is active);
      * ``corrupt_tokens(unit, now, toks)`` — NaN/Inf-burst model applied
        to a fetched token array: corrupted lanes are overwritten with an
        invalid token id (the host-visible face of NaN logits), seeded per
        (event, dispatch) so runs replay bit-identically.

    ``poll(now)`` returns the events newly *started* since the last poll
    (for logging / recovery-latency bookkeeping); symptom queries are pure
    functions of ``now`` so the engine never has to order them carefully.
    """

    #: token id stamped on corrupted lanes — never a valid vocab id, the
    #: host-side face of NaN/Inf logits coming off a broken datapath
    CORRUPT_TOKEN = -(2 ** 30)

    def __init__(self, events: Sequence[FaultEvent] = (), *, seed: int = 0):
        self.events: List[FaultEvent] = sorted(events, key=lambda e: e.at_s)
        self.seed = seed
        self._announced: set = set()
        self._dispatch_counter = 0

    # -- schedule ---------------------------------------------------------
    def arm(self, *events: FaultEvent) -> "FaultInjector":
        self.events = sorted([*self.events, *events], key=lambda e: e.at_s)
        return self

    def poll(self, now: float) -> List[FaultEvent]:
        """Events that have started by ``now`` and were not yet reported."""
        fresh = []
        for i, ev in enumerate(self.events):
            if ev.at_s <= now and i not in self._announced:
                self._announced.add(i)
                fresh.append(ev)
        return fresh

    def active(self, unit: str, now: float,
               kind: Optional[str] = None) -> List[FaultEvent]:
        return [e for e in self.events
                if e.unit == unit and e.active_at(now)
                and (kind is None or e.kind == kind)]

    # -- symptoms ---------------------------------------------------------
    def killed(self, unit: str, now: float) -> bool:
        return bool(self.active(unit, now, FaultKind.KILL))

    def time_scale(self, unit: str, now: float) -> float:
        """Dispatch wall-time inflation: 1/freq_scale of the deepest active
        throttle (kills don't inflate time — they produce nothing at all)."""
        scale = 1.0
        for e in self.active(unit, now, FaultKind.THROTTLE):
            scale = max(scale, 1.0 / e.magnitude)
        return scale

    def corrupt_tokens(self, unit: str, now: float,
                       toks: np.ndarray) -> Tuple[np.ndarray, int]:
        """Apply any active CORRUPT event to a fetched ``(T,)`` token
        column; returns (possibly corrupted copy, #corrupted).  Seeded per
        (injector seed, event index, dispatch counter): replays are
        bit-identical."""
        events = self.active(unit, now, FaultKind.CORRUPT)
        if not events:
            return toks, 0
        self._dispatch_counter += 1
        out = np.array(toks, copy=True)
        n_bad = 0
        for ev in events:
            idx = self.events.index(ev)
            rng = np.random.default_rng(
                (self.seed, idx, self._dispatch_counter))
            mask = rng.random(out.shape) < ev.magnitude
            n_bad += int(mask.sum())
            out[mask] = self.CORRUPT_TOKEN
        return out, n_bad


def random_faults(units: Sequence[str], *, horizon_s: float, n_events: int,
                  seed: int = 0,
                  kinds: Iterable[str] = FaultKind.ALL,
                  mean_duration_s: float = 5.0) -> List[FaultEvent]:
    """Draw a seeded random chaos schedule over ``units`` (the flap/soak
    scenarios): event times uniform over the horizon, exponential
    durations, throttle derates in [0.3, 0.9]."""
    rng = np.random.default_rng(seed)
    kinds = tuple(kinds)
    out = []
    for _ in range(n_events):
        kind = kinds[int(rng.integers(len(kinds)))]
        magnitude = 1.0
        if kind == FaultKind.THROTTLE:
            magnitude = float(rng.uniform(0.3, 0.9))
        elif kind == FaultKind.CORRUPT:
            magnitude = float(rng.uniform(0.5, 1.0))
        out.append(FaultEvent(
            at_s=float(rng.uniform(0.0, horizon_s)),
            unit=str(units[int(rng.integers(len(units)))]),
            kind=kind,
            duration_s=float(rng.exponential(mean_duration_s)),
            magnitude=magnitude))
    return sorted(out, key=lambda e: e.at_s)


# ---------------------------------------------------------------------------
# Train-side schedule
# ---------------------------------------------------------------------------
def step_failure_schedule(fail_at_steps):
    """Step-keyed whole-process failure hook for the train restart
    protocol: raises ``SimulatedFailure`` the first time each listed step
    is reached."""
    fired = set()

    def hook(step: int):
        if step in fail_at_steps and step not in fired:
            fired.add(step)
            raise SimulatedFailure(f"node failure injected at step {step}")

    return hook
