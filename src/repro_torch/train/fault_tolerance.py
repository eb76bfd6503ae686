"""Fault tolerance: restartable training with simulated failures, and
straggler-aware step accounting (counterpart of
``repro.train.fault_tolerance``).

``run_with_restarts`` is the single-controller restart protocol: train,
crash (``SimulatedFailure`` at chosen steps), relaunch, restore the latest
checkpoint, continue.  The data pipeline is keyed by step and the
optimizer state is checkpointed, so a restarted run is bitwise the
uninterrupted one wherever each step is itself deterministic (on the card:
with ``torch.use_deterministic_algorithms(True)``, since the embedding's
gradient is a scatter-add).

``StragglerMonitor`` sets a per-step deadline from a trailing median of
step times and counts the steps past it; a straggling step is a
low-utilization step, the regime where the FPMax body-bias telemetry saves
leakage.  The fault vocabulary lives in ``repro_torch.faults``; this module
re-exports the train-side names.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.faults import (SimulatedFailure,  # noqa: F401 (re-export)
                                step_failure_schedule as failure_schedule)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_loop import TrainState, train_loop


def run_with_restarts(model, make_state: Callable[[], TrainState],
                      train_step, data_iter, *, n_steps: int,
                      manager: CheckpointManager, checkpoint_every: int,
                      failure_hook=None, max_restarts: int = 10,
                      log_every: int = 1):
    """Train to n_steps surviving injected failures. Returns
    (final_state, history, n_restarts)."""
    restarts = 0
    history: List[Dict] = []
    while True:
        state = make_state()
        latest = manager.latest_step()
        if latest is not None:
            state, _ = manager.restore(state, step=latest)
        try:
            state, hist = train_loop(
                model, state, train_step, data_iter, n_steps=n_steps,
                log_every=log_every, checkpoint_manager=manager,
                checkpoint_every=checkpoint_every,
                failure_hook=failure_hook)
            history.extend(hist)
            manager.wait()
            return state, history, restarts
        except SimulatedFailure:
            restarts += 1
            manager.wait()  # flush pending async saves before relaunch
            if restarts > max_restarts:
                raise


@dataclasses.dataclass
class StragglerMonitor:
    """Trailing-median deadline detector for slow steps/hosts."""

    window: int = 32
    tolerance: float = 2.0
    times: List[float] = dataclasses.field(default_factory=list)
    straggler_steps: int = 0
    _last: Optional[float] = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self) -> Dict[str, float]:
        dt = time.perf_counter() - self._last
        med = float(np.median(self.times[-self.window:])) if self.times \
            else dt
        is_straggler = bool(self.times) and dt > self.tolerance * med
        if is_straggler:
            self.straggler_steps += 1
        self.times.append(dt)
        # a straggling step does useful work for ~median time and idles
        # the rest
        util = min(med / dt, 1.0) if dt > 0 else 1.0
        return {"step_time_s": dt, "median_s": med,
                "straggler": float(is_straggler), "utilization": util}
