"""``repro_torch.roofline`` — the roofline report, the measured
utilizations of dry-run artifacts, the op-level cost counter that stands in
for the JAX package's HLO parser (``op_cost``) and the fused-kernel traffic
model (``fused_model``)."""
