"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

  * ``fused.fused_qmm`` (K1) and ``fma_emu.fma_emu_matmul`` (K3):
    emulated-precision matmul, ``csrc/qmm.cu``;
  * ``quantize_kernel.quantize_nd`` (K2): round-to-format,
    ``csrc/quantize.cu``;
  * ``fused.ssm_scan_quantized`` (K5) and ``ssm_scan.ssm_scan`` (K6): the
    selective scan with and without format-rounded operands,
    ``csrc/ssm_scan.cu``.

Each wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors, counting launches in ``<wrapper>.launches``.
"""
