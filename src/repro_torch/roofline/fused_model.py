"""Fused-kernel traffic model (counterpart of
``repro.roofline.fused_model``).

The port's step runs eagerly, so the blockwise attention probabilities and
the selective scan's state expansion travel through device memory op by op.
A fused kernel keeps them on chip.  This module recomputes the memory term
under that model, by the JAX package's rule:

  * the traffic counted inside the ``flash_attention_kernel`` and
    ``selective_scan_kernel`` scopes (``torch.profiler.record_function`` in
    ``models/flash_vjp.py`` and ``models/ssm.py``) is taken out;
  * the kernel's interface traffic is put in, estimated as 0.25 x the
    operand and result bytes of the scopes' matmul-class ops (the tensors
    a fused kernel streams from and to memory);
  * everything else keeps its counted traffic.

The rate is the H100's HBM3 rate (``analysis.H100_HBM_BW``); the JAX
default of 819e9 bytes/s is a TPU's and is not the port's.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.roofline.analysis import H100_HBM_BW

_SCOPES = ("flash_attention_kernel", "selective_scan_kernel")


def scoped_traffic(cost) -> Dict[str, Dict[str, float]]:
    """Per kernel scope, the traffic counted inside it (``scoped``) and the
    estimated kernel-interface traffic (``interface``), from an
    ``op_cost.OpCost``."""
    return {"scoped": {s: float(cost.scope_traffic.get(s, 0.0))
                       for s in _SCOPES},
            "interface": {s: 0.25 * float(cost.scope_dot_bytes.get(s, 0.0))
                          for s in _SCOPES}}


def fused_memory_term(total_traffic: float, cost,
                      hbm_bw: float = H100_HBM_BW) -> Tuple[float, Dict]:
    """(memory seconds with the scopes' traffic swapped for their
    interface traffic, {removed_bytes, added_bytes, adjusted_traffic})."""
    info = scoped_traffic(cost)
    removed = sum(info["scoped"].values())
    added = sum(info["interface"].values())
    adj = max(total_traffic - removed + added, 0.0)
    return adj / hbm_bw, {"removed_bytes": removed, "added_bytes": added,
                          "adjusted_traffic": adj}
