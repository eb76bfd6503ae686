"""The roofline report: three time terms per (arch x shape x mesh).

  compute    = flops / peak_flops
  memory     = bytes / hbm_bw
  collective = collective_bytes / link_bw

Counterpart of ``repro.roofline.analysis.RooflineReport``, the dataclass and
its properties only.  Its default rates are those of one NVIDIA H100 SXM
from NVIDIA's data sheet (dense bf16 tensor-core peak, HBM3 rate, NVLink
rate each way), not the JAX package's TPU constants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core operations/s, HBM3
#: bytes/s, and NVLink bytes/s each way (900 GB/s in all)
H100_PEAK_FLOPS_BF16 = 989e12
H100_HBM_BW = 3.35e12
H100_NVLINK_BW = 450e9


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, int]
    model_flops: float  # 6*N*D (or 6*N_active*D)
    peak_flops: float = H100_PEAK_FLOPS_BF16
    hbm_bw: float = H100_HBM_BW
    link_bw: float = H100_NVLINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_bound_s(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        global_flops = self.flops_per_device * self.chips
        return self.model_flops / global_flops if global_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the bound step time:
        MODEL_FLOPS / (chips * peak * step_time_bound)."""
        denom = self.chips * self.peak_flops * self.step_time_bound_s
        return self.model_flops / denom if denom else 0.0

    def as_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_breakdown": self.collective_breakdown,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
        }
