"""Cluster description: N heterogeneous dies behind one front-end
(counterpart of ``repro.cluster.spec``).

A ``ClusterSpec`` is to a fleet of chips what ``ChipSpec`` is to a die's
unit mix: a named, budget-validated, immutable inventory.  Dies may carry
different tuned unit/format mixes (the Manticore composition of the
transprecision argument — specialize each die, schedule them as one
system); the router (``cluster.router``) and the co-design search
(``cluster.tune``) both consume this type.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from repro_torch.core.chip import ChipSpec


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """An area/TDP-budgeted mix of chips behind one admission front-end."""

    name: str
    chips: Tuple[ChipSpec, ...]
    area_budget_mm2: float = math.inf
    tdp_budget_mw: float = math.inf

    def __post_init__(self):
        if not self.chips:
            raise ValueError("a cluster needs at least one chip")
        names = [c.name for c in self.chips]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate chip names: {names}")
        if self.area_mm2 > self.area_budget_mm2 * (1 + 1e-12):
            raise ValueError(
                f"cluster {self.name!r} infeasible: area "
                f"{self.area_mm2:.4f}mm2 > budget "
                f"{self.area_budget_mm2:.4f}mm2")
        if self.peak_power_mw > self.tdp_budget_mw * (1 + 1e-12):
            raise ValueError(
                f"cluster {self.name!r} infeasible: peak power "
                f"{self.peak_power_mw:.1f}mW > TDP "
                f"{self.tdp_budget_mw:.1f}mW")

    def chip(self, name: str) -> ChipSpec:
        for c in self.chips:
            if c.name == name:
                return c
        raise KeyError(f"cluster {self.name!r} has no chip {name!r}; "
                       f"have {[c.name for c in self.chips]}")

    @property
    def area_mm2(self) -> float:
        return sum(c.area_mm2 for c in self.chips)

    @property
    def peak_power_mw(self) -> float:
        return sum(c.peak_power_mw for c in self.chips)

    @property
    def avg_power_mw(self) -> float:
        return sum(c.avg_power_mw for c in self.chips)

    @property
    def gflops_effective(self) -> float:
        return sum(c.gflops_effective for c in self.chips)

    @property
    def gflops_per_w(self) -> float:
        return self.gflops_effective / (self.avg_power_mw * 1e-3)

    def as_dict(self) -> Dict[str, object]:
        return dict(name=self.name,
                    chips=[c.as_dict() for c in self.chips],
                    area_mm2=self.area_mm2,
                    area_budget_mm2=self.area_budget_mm2,
                    peak_power_mw=self.peak_power_mw,
                    tdp_budget_mw=self.tdp_budget_mw,
                    avg_power_mw=self.avg_power_mw,
                    gflops_effective=self.gflops_effective,
                    gflops_per_w=self.gflops_per_w)


def homogeneous(spec: ChipSpec, n: int, *,
                name: str = None) -> ClusterSpec:  # type: ignore[assignment]
    """A cluster of ``n`` identical replicas of one die (die names get a
    ``/die<i>`` suffix so the cluster namespace stays unique)."""
    if n < 1:
        raise ValueError(f"need at least one die, got n={n}")
    chips = tuple(dataclasses.replace(spec, name=f"{spec.name}/die{i}")
                  for i in range(n))
    return ClusterSpec(name or f"{spec.name}x{n}", chips)
