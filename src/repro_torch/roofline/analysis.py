"""The roofline report: three time terms per (arch x shape x mesh).

  compute    = flops / peak_flops
  memory     = bytes / hbm_bw
  collective = collective_bytes / link_bw

Counterpart of ``repro.roofline.analysis``: the ``RooflineReport`` dataclass
and its properties, the measured utilizations read from dry-run JSON
artifacts, and the model-FLOP estimate the chip tuner weights phases by.  The report's default rates are those of one NVIDIA H100 SXM
from NVIDIA's data sheet (dense bf16 tensor-core peak, HBM3 rate, NVLink
rate each way), not the JAX package's TPU constants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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


# ---------------------------------------------------------------------------
# Measured utilizations (feeds core.autotune.profile_from_config)
# ---------------------------------------------------------------------------
#: parsed utilization tables memoized per results_dir, invalidated when the
#: artifact files' (path, mtime, size) signature changes
_UTILIZATION_CACHE: Dict[str, tuple] = {}


def measured_utilizations(results_dir: str = "results"
                          ) -> Dict[tuple, float]:
    """(arch, shape) -> measured roofline fraction from dry-run artifacts.

    Scans ``results_dir/dryrun_*.json`` (written by the JAX package's
    ``launch.dryrun``) and returns, per (arch, shape) cell, the best
    ``roofline_fraction`` achieved across meshes — the fraction of the
    compute roofline the cell actually sustains, i.e. the FPU activity the
    chip autotuner should tune for instead of hand-set constants.
    Missing/failed cells are skipped; an absent directory yields an empty
    table.  Parsed tables are memoized per directory and refreshed when the
    artifacts change on disk.
    """
    import glob
    import json
    import os

    paths = sorted(glob.glob(os.path.join(results_dir, "dryrun_*.json")))

    def _stat(p):
        try:
            st = os.stat(p)
            return (p, st.st_mtime_ns, st.st_size)
        except OSError:
            return (p, None, None)

    sig = tuple(_stat(p) for p in paths)
    cached = _UTILIZATION_CACHE.get(results_dir)
    if cached is not None and cached[0] == sig:
        return dict(cached[1])

    out: Dict[tuple, float] = {}
    for path in paths:
        try:
            with open(path) as f:
                rows = json.load(f)
        except (OSError, ValueError):
            continue
        for key, row in rows.items():
            if not isinstance(row, dict) or row.get("status") != "ok":
                continue
            if "|" not in key:
                continue
            arch, shape = key.split("|", 1)
            frac = row.get("roofline_fraction")
            if frac is None:
                continue
            cell = (arch, shape)
            out[cell] = max(out.get(cell, 0.0), float(frac))
    _UTILIZATION_CACHE[results_dir] = (sig, out)
    return dict(out)


def measured_utilization(arch: str, shape: str,
                         results_dir: str = "results") -> Optional[float]:
    """Best measured roofline fraction for one cell, or None if unmeasured."""
    return measured_utilizations(results_dir).get((arch, shape))


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D for training; 2*N*D for inference (per step/token set)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
