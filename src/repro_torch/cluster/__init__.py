"""Cluster-scale serving and co-design: many tuned dies behind one
front-end (counterpart of ``repro.cluster``).

  * ``ClusterSpec`` / ``homogeneous`` — the budget-validated die inventory;
  * ``ClusterRouter`` / ``SimClock`` — health-aware, least-loaded
    precision/accuracy/deadline admission routing with degrade-don't-drop
    cross-die migration;
  * ``TraceConfig`` / ``RequestClass`` / ``generate`` / ``replay`` /
    ``latency_stats`` — the seeded bursty/diurnal open-loop load generator;
  * ``ChipClass`` / ``tune_cluster`` — chip-mix + fleet-size co-design
    under total area/TDP budgets.

Telemetry: pass ``tracer=telemetry.Tracer()`` to ``ClusterRouter``
(shared by every die, so span trees survive cross-die migration) and to
``replay`` (arrival system events); ``trace_cluster`` below wires both and
returns the tracer.
"""
from repro_torch.cluster.loadgen import (Arrival, RequestClass, StepCost,
                                         TraceConfig, generate,
                                         latency_stats, replay)
from repro_torch.cluster.router import ClusterRouter, SimClock
from repro_torch.cluster.spec import ClusterSpec, homogeneous
from repro_torch.cluster.tune import (ChipClass, ClusterTuneResult,
                                      tune_cluster)
from repro_torch.telemetry import Tracer


def trace_cluster(router: ClusterRouter) -> Tracer:
    """Attach a fresh recording ``Tracer`` to an already-built router (and
    every die replica it owns); returns the tracer.  Pass it as
    ``replay(..., tracer=...)`` to record arrivals too."""
    tracer = Tracer()
    router.tracer = tracer
    for name, srv in router.servers.items():
        srv.tracer = tracer
        srv.trace_site = name
    return tracer


__all__ = [
    "Arrival", "ChipClass", "ClusterRouter", "ClusterSpec",
    "ClusterTuneResult", "RequestClass", "SimClock", "StepCost",
    "TraceConfig", "Tracer", "generate", "homogeneous", "latency_stats",
    "replay", "trace_cluster", "tune_cluster",
]
