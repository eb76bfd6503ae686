"""``KernelSpec``: generated microbenchmark kernels + their analytic model
(counterpart of ``repro.benchgen.spec``).

A spec names a point in (op x format x shape x accumulation style) space.
From it the module derives two things that must agree:

  * ``build(spec)``     — a runnable benchmark closure over the port's
                          kernels: K1 ``fused_qmm``, K4
                          ``fused_flash_attention``, K5
                          ``ssm_scan_quantized`` and K2 through
                          ``quantize_tensor``, or their plain versions;
  * ``op_counts(spec)`` — the analytic work/traffic model of that closure's
                          schedule: dot flops, round-to-format element
                          count, elementwise flops, transcendental (exp)
                          element count, and device-memory interface bytes.

The counts model the *measured implementation's* schedule, not an idealized
one — e.g. the flash schedule re-quantizes the q-block once per kv-block, so
``quant_elems`` carries the nq*nk factor.  ``repro_torch.benchgen.bench``
turns the counts into a roofline prediction and holds the measured time
against it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.formats import FloatFormat
from repro_torch.kernels.ref import STYLES
from repro_torch.numerics.registry import get_format

#: op -> (shape arity, shape axis names)
OPS: Dict[str, Tuple[int, str]] = {
    "qmm": (3, "(m, k, n)"),
    "flash": (4, "(batch, heads, seq, head_dim)"),
    "ssm_scan": (4, "(batch, seq, d_inner, d_state)"),
    "quantize": (2, "(rows, cols)"),
}

#: tile sizes assumed by the analytic model; build() passes the same ones to
#: the kernels so counts and schedule can never drift apart.
BK = 128      # qmm k-block (the kernels' fixed TILE)
BLOCK = 128   # flash q/kv block


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One generated-kernel point: op x format x shape x accumulation style.

    ``fmt`` is a registry name (``repro_torch.numerics.registry``) so specs
    stay JSON-serializable; ``accum_style`` follows the FPMax unit taxonomy
    (``fused`` / ``cascade`` / ``cascade_fwd``) and only affects ``qmm``;
    ``scaled`` enables the exact power-of-two block-scaling (fp8 dynamic
    range) mode on ``qmm``/``flash``.
    """

    op: str
    fmt: str
    shape: Tuple[int, ...]
    accum_style: str = "fused"
    scaled: bool = False

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"op must be one of {tuple(OPS)}, got {self.op!r}")
        arity, axes = OPS[self.op]
        if len(self.shape) != arity:
            raise ValueError(f"{self.op} shape is {axes}, got {self.shape}")
        if self.accum_style not in STYLES:
            raise ValueError(f"accum_style must be one of {STYLES}, "
                             f"got {self.accum_style!r}")
        get_format(self.fmt)  # fail early on unknown names
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @property
    def name(self) -> str:
        tag = "x".join(str(s) for s in self.shape)
        bits = [self.op, self.fmt, tag]
        if self.op == "qmm":
            bits.append(self.accum_style)
        if self.scaled:
            bits.append("scaled")
        return ".".join(bits)

    @property
    def float_format(self) -> FloatFormat:
        return get_format(self.fmt)

    def as_dict(self) -> Dict[str, object]:
        return dict(op=self.op, fmt=self.fmt, shape=list(self.shape),
                    accum_style=self.accum_style, scaled=self.scaled,
                    name=self.name)


def op_counts(spec: KernelSpec) -> Dict[str, float]:
    """Analytic work/traffic of the generated kernel's schedule.

    Returns ``dot_flops`` (contractions), ``quant_elems`` (elements pushed
    through the round-to-format pipe), ``vpu_flops`` (elementwise mul/add),
    ``exp_elems`` (transcendentals), ``hbm_bytes`` (interface traffic: f32
    inputs + outputs — intermediates stay on chip by construction) and
    ``useful_flops`` (the payload flops an application would count).
    """
    c = dict(dot_flops=0.0, quant_elems=0.0, vpu_flops=0.0, exp_elems=0.0,
             hbm_bytes=0.0, useful_flops=0.0)
    if spec.op == "qmm":
        m, k, n = spec.shape
        gk = math.ceil(k / BK)
        c["dot_flops"] = 2.0 * m * k * n
        # each operand element is quantized exactly once across the k-blocks
        c["quant_elems"] = float(m * k + k * n)
        # cascade styles also round the (m, n) partial per k-block
        if spec.accum_style == "cascade_fwd":
            c["quant_elems"] += float(m * n * gk)
        elif spec.accum_style == "cascade":
            c["quant_elems"] += 2.0 * m * n * gk
        c["vpu_flops"] = float(m * n * gk)  # accumulator adds
        c["hbm_bytes"] = 4.0 * (m * k + k * n + m * n)
        c["useful_flops"] = 2.0 * m * k * n
    elif spec.op == "flash":
        b, h, s, d = spec.shape
        nq = nk = math.ceil(s / BLOCK)
        # qk^T and pv over every (q-block, kv-block) pair; causal pairs are
        # masked, not skipped, in both the kernel and the ref schedule
        c["dot_flops"] = 4.0 * b * h * s * s * d
        # q/k/v re-quantized per block pair + p quantized per pair
        c["quant_elems"] = b * h * nq * nk * (3.0 * BLOCK * d
                                              + BLOCK * BLOCK)
        c["exp_elems"] = float(b * h * s * s)
        # online-softmax bookkeeping: max/corr/l updates + acc rescale
        c["vpu_flops"] = b * h * s * (4.0 * s + 4.0 * d * nk)
        c["hbm_bytes"] = 4.0 * b * h * s * d * 4.0  # q, k, v in; o out
        c["useful_flops"] = 4.0 * b * h * s * s * d
    elif spec.op == "ssm_scan":
        b, s, d, n = spec.shape
        c["quant_elems"] = b * s * (2.0 * d * n + n)
        # h = a*h + b (2 flops/elem) and y = sum(h*c) (2 flops/elem)
        c["vpu_flops"] = 4.0 * b * s * d * n
        c["hbm_bytes"] = 4.0 * (2.0 * b * s * d * n + b * s * n
                                + b * s * d + b * d * n)
        c["useful_flops"] = c["vpu_flops"]
    elif spec.op == "quantize":
        m, n = spec.shape
        c["quant_elems"] = float(m * n)
        c["hbm_bytes"] = 8.0 * m * n
        c["useful_flops"] = float(m * n)
    if spec.scaled:
        # per-tile max reduce + exponent extraction + two dequant muls:
        # roughly doubles the per-element rounding pipe
        c["quant_elems"] *= 2.0
    return c


def make_inputs(spec: KernelSpec, seed: int = 0, device=None):
    """Deterministic f32 operands for the spec's op, drawn with numpy as the
    JAX package draws them, on ``device`` (default CUDA)."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)

    def put(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    def arr(*shape):
        return put(rng.standard_normal(shape))

    if spec.op == "qmm":
        m, k, n = spec.shape
        return arr(m, k), arr(k, n)
    if spec.op == "flash":
        b, h, s, d = spec.shape
        # the kernels take (B, S, H, D) layout
        return arr(b, s, h, d), arr(b, s, h, d), arr(b, s, h, d)
    if spec.op == "ssm_scan":
        b, s, d, n = spec.shape
        # decay in (0, 1) keeps the recurrence bounded like the model layers
        a = put(rng.uniform(0.05, 0.95, (b, s, d, n)))
        return a, arr(b, s, d, n), arr(b, s, n)
    m, n = spec.shape  # quantize
    return (arr(m, n),)


def build(spec: KernelSpec, impl: str = "auto", device=None) -> Callable:
    """The runnable benchmark closure for ``spec``.

    impl: ``'fused'`` (the port's kernels; their plain versions for CPU
    tensors) | ``'ref'`` (the plain versions) | ``'auto'`` (``'fused'`` on
    CUDA, ``'ref'`` on the CPU, for ``device``, default CUDA).  The returned
    callable takes the ``make_inputs`` operands and returns a single tensor
    (the ssm output reduced to y)."""
    from repro_torch.kernels import fused as _fused
    from repro_torch.numerics.emulate import quantize_tensor

    if impl == "auto":
        impl = "fused" if resolve_device(device).type == "cuda" else "ref"
    if impl not in ("fused", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    fmt = spec.float_format

    if spec.op == "qmm":
        if impl == "ref":
            return lambda a, b: _fused.fused_qmm_ref(
                a, b, fmt=fmt, style=spec.accum_style, scaled=spec.scaled)
        return lambda a, b: _fused.fused_qmm(
            a, b, fmt=fmt, style=spec.accum_style, scaled=spec.scaled)
    if spec.op == "flash":
        fn = _fused.fused_flash_ref if impl == "ref" \
            else _fused.fused_flash_attention
        return lambda q, k, v: fn(q, k, v, fmt=fmt, scaled=spec.scaled,
                                  causal=True, block_q=BLOCK, block_k=BLOCK)
    if spec.op == "ssm_scan":
        fn = _fused.ssm_scan_quantized_ref if impl == "ref" \
            else _fused.ssm_scan_quantized
        return lambda a, b, c: fn(a, b, c, fmt=fmt)[0]
    # quantize
    q_impl = "pallas" if impl == "fused" else "ref"
    return lambda x: quantize_tensor(x, fmt=fmt, impl=q_impl,
                                     device=x.device)
