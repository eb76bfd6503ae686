"""``repro_torch`` — the PyTorch/CUDA port of ``repro``, laid out module for
module like the JAX package so each piece has an obvious counterpart.

Plain tensor code is PyTorch; every Pallas kernel of ``repro`` on the ported
path is a hand-written CUDA kernel for Hopper (``csrc/``, built with ``nvcc``
at first use).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA and without an explicit device they raise.
"""
