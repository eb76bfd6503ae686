"""The device trace of a traced run: ``torch.profiler`` over the whole
window (started before it opens, stopped and reduced after it closes,
so that neither stalls it), reduced to the device's busy time (the union
of the intervals in which an operation ran on the device), time by kernel
name, and the longest idle gaps labelled by what the host was doing.

With no CUDA device (a CPU test) the trace holds no device operation and
the readers of device metrics find nothing to read.
"""
from __future__ import annotations

import time
from typing import List, Optional

from perfbench.harness import sync

TOP = 10


class DeviceTrace:
    """Profiles from ``start()`` until ``stop()``; ``summary`` then holds
    the reduction (None when never started)."""

    def __init__(self, device, on: bool):
        self.device = device
        self.on = on
        self.prof = None
        self.summary: Optional[dict] = None

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        sync(self.device)
        t = time.perf_counter()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.start_s = self.t0 - t

    def stop(self, **extra) -> None:
        """End the trace; ``extra`` (the work done in it) is kept beside
        the reduction."""
        if self.prof is None:
            return
        sync(self.device)
        window = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        t0 = time.perf_counter()
        self.summary = reduce(self.prof.profiler.kineto_results.events(),
                              window)
        self.summary["reduce_s"] = time.perf_counter() - t0
        self.summary["start_s"] = self.start_s
        self.summary.update(extra)
        self.prof = None


def _is_device(ev) -> bool:
    """An operation on the device: a kernel, copy or set, not a span
    (a ``record_function`` scope is also drawn on the device's line)."""
    return str(ev.device_type()).endswith("CUDA") and ev.duration_ns() > 0 \
        and not ev.is_user_annotation()


def reduce(events, window_s: float) -> dict:
    """Busy seconds, seconds by device op, the longest idle gaps."""
    dev, host = [], []
    for ev in events:
        if _is_device(ev):
            dev.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                        ev.name()))
        elif not str(ev.device_type()).endswith("CUDA"):
            host.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                         ev.name()))
    dev.sort()
    busy_ns, gaps = 0, []
    cur = None
    for s, e, _ in dev:
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy_ns += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy_ns += cur[1] - cur[0]
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": window_s,
        "busy_s": busy_ns * 1e-9,
        "kernels": by_name,
        "device_ops": [[n[:160], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[host_activity(host, (a + b) // 2), (b - a) * 1e-9]
                      for a, b in gaps[:TOP]],
    }


def host_activity(host: List[tuple], t: int) -> str:
    """What the host ran at ``t``: the outermost benchmark span covering
    it, and the innermost host op covering it or else the last one that
    ended before it."""
    cover = [(e - s, name) for s, e, name in host if s <= t <= e]
    spans = [c for c in cover if c[1].startswith("bench.")]
    outer = max(spans)[1] if spans else "no span"
    ops = [c for c in cover if not c[1].startswith("bench.")]
    if ops:
        inner = min(ops)[1]
    else:
        before = [(e, name) for s, e, name in host
                  if e < t and not name.startswith("bench.")]
        inner = f"after {max(before)[1]}" if before else "no op"
    return f"{outer} / {inner}"[:160]
