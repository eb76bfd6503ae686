"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

  * ``fused.fused_qmm`` (K1) and ``fma_emu.fma_emu_matmul`` (K3):
    emulated-precision matmul, ``csrc/qmm.cu``;
  * ``quantize_kernel.quantize_nd`` (K2): round-to-format,
    ``csrc/quantize.cu``;
  * ``fused.fused_flash_attention`` (K4): blockwise flash attention with
    per-block quantize/dequant, ``csrc/flash_attn.cu``;
  * ``fused.ssm_scan_quantized`` (K5) and ``ssm_scan.ssm_scan`` (K6): the
    selective scan with and without format-rounded operands,
    ``csrc/ssm_scan.cu``;
  * ``attention_tc.flash_attention_tc``: the model's full-sequence
    attention on the tensor cores, ``csrc/attention_tc.cu`` (no TPU
    kernel: it stands in for ``models.attention.flash_blocks`` on the
    card, and raises on CPU tensors).

Each wrapper of K1-K6 runs its plain version for CPU tensors and launches
its kernel for CUDA tensors; every wrapper counts its launches in
``<wrapper>.launches``.  No kernel
has a backward: on CUDA tensors a wrapper raises
``_build.NoBackwardError`` when grad mode is on and an input requires
grad, where autograd would otherwise take the output for a constant.
"""
