"""K6: the fused selective scan (the Mamba recurrence) on the card
(``csrc/ssm_scan.cu``).

Counterpart of ``repro.kernels.ssm_scan``:

    h_t = a_t * h_{t-1} + b_t ;  y_t = <h_t, c_t>

for a, b (B, S, D, N) and c (B, S, N), returning y (B, S, D) and h_last
(B, D, N), all f32.  The TPU kernel walked the grid (B, D/bd, S/chunk) with
the chunk axis sequential in VMEM; the CUDA kernel gives each (b, d) row N/4
lanes (N = 8 and 16), each keeping four states in registers and looping
over S with a ring of a and b several steps deep in shared memory, so the
(S, D, N) expansion is read once and never written.  ``plan_scan`` picks
the rows of a thread block.  ``chunk`` and ``bd`` only validate shapes, as
in the JAX package.

``ssm_scan_ref`` is the plain version: the same rounded ops in the same
order (``a * h`` and ``+ b`` as two ops, the readout summed over n left to
right), so the kernel equals it bitwise.  K5 (``fused.ssm_scan_quantized``)
runs the same device code with rounded operands.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.formats import FloatFormat, quantize
from repro_torch.kernels import _build

#: (exp_bits, man_bits) that the device code reads as "no rounding"
_NO_ROUNDING = (8, 23)


def check_shapes(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> None:
    """a and b (B, S, D, N), c (B, S, N), on one device; raises otherwise."""
    if a.dim() != 4 or tuple(b.shape) != tuple(a.shape) \
            or tuple(c.shape) != (a.shape[0], a.shape[1], a.shape[3]):
        raise ValueError(f"bad scan shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    if not (a.device == b.device == c.device):
        raise ValueError(f"operands on {a.device}, {b.device}, {c.device}")


def scan_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             out_fmt: FloatFormat | None = None):
    """The recurrence and readout on f32 operands, one token at a time:
    ``a * h`` and ``+ b`` as two rounded ops and the readout summed over n
    left to right, the op order of the CUDA kernel.  ``out_fmt`` rounds y
    (elementwise, so once at the end).  Returns (y, h_last)."""
    a, b, c = (t.to(torch.float32) for t in (a, b, c))
    nb, s_len, d_len, n_len = a.shape
    h = torch.zeros((nb, d_len, n_len), dtype=torch.float32, device=a.device)
    ys = []
    for s in range(s_len):
        h = a[:, s] * h + b[:, s]
        prod = h * c[:, s, None, :]
        y = prod[..., 0]
        for n in range(1, n_len):
            y = y + prod[..., n]
        ys.append(y)
    y = torch.stack(ys, dim=1) if ys else \
        torch.zeros((nb, 0, d_len), dtype=torch.float32, device=a.device)
    if out_fmt is not None:
        y = quantize(y, out_fmt)
    return y, h


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Plain version of ``ssm_scan``: the sequential recurrence + readout.
    Returns (y (B, S, D), h_last (B, D, N)), f32."""
    check_shapes(a, b, c)
    return scan_ref(a, b, c)


#: the N the lanes kernel takes (N/4 lanes a row, one float4 of states a
#: lane); any other N runs the scalar kernel, one thread a row
LANE_N = (8, 16)
#: threads a block: the most, and the fewest (one warp) the planner narrows
#: to while the grid holds fewer blocks than the card has SMs
SCAN_THREADS = 128
SCAN_MIN_THREADS = 32
_GRID_Y_MAX = 65535


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How K5/K6 run one call on the card: the kernel (``lanes`` or
    ``any``), the lanes of one (b, d) row, the rows of a thread block, and
    the grid: (d-blocks, batches) for the lanes kernel, (blocks, 1) for the
    scalar one."""

    kernel: str
    lanes: int
    rows: int
    grid: tuple[int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def plan_scan(shape, sm_count: int) -> ScanPlan:
    """The schedule of one scan call with a, b of ``shape`` (B, S, D, N) on
    a card with ``sm_count`` SMs.  N = 8 and 16 take N/4 lanes a row and
    blocks of SCAN_THREADS threads, halved (down to one warp) while the
    grid has fewer blocks than SMs; a block holds rows of one batch only.
    Raises on shapes beyond the grid."""
    B, S, D, N = shape
    if min(B, D, N, sm_count) < 1 or S < 0:
        raise ValueError(f"plan_scan: bad shape {tuple(shape)} or "
                         f"sm_count={sm_count}")
    if N not in LANE_N:
        return ScanPlan("any", 1, SCAN_THREADS,
                        (-(-B * D // SCAN_THREADS), 1))
    if B > _GRID_Y_MAX:
        raise ValueError(f"plan_scan: batch {B} beyond the grid")
    lanes = N // 4
    rows = SCAN_THREADS // lanes
    while rows * lanes > SCAN_MIN_THREADS and B * -(-D // rows) < sm_count:
        rows //= 2
    return ScanPlan("lanes", lanes, rows, (-(-D // rows), B))


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point of K5 and K6, built and loaded at first use."""
    fn = _build.load("ssm_scan").repro_ssm_scan
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _f32_aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           fmt: FloatFormat | None, out_fmt: FloatFormat | None):
    """One launch of the device code on CUDA operands, on the schedule
    ``plan_scan`` picks; f32 (y, h_last) out.  The caller counts the
    launch."""
    check_shapes(a, b, c)
    for f in (fmt, out_fmt):
        if f is not None and (f.exp_bits > 8 or f.man_bits > 23):
            raise ValueError(f"f32 scan path supports sub-f32 formats, "
                             f"got {f}")
    a, b, c = _f32_aligned(a), _f32_aligned(b), _f32_aligned(c)
    nb, s_len, d_len, n_len = a.shape
    if n_len > 256:
        raise ValueError(f"the scan kernel takes N <= 256, got {n_len}")
    plan = plan_scan(a.shape, _build.sm_count(a.device))
    y = torch.empty((nb, s_len, d_len), dtype=torch.float32, device=a.device)
    h = torch.zeros((nb, d_len, n_len), dtype=torch.float32, device=a.device)
    exp_bits, man_bits = (fmt.exp_bits, fmt.man_bits) if fmt \
        else _NO_ROUNDING
    out_exp, out_man = (out_fmt.exp_bits, out_fmt.man_bits) if out_fmt \
        else (0, 0)
    rc = _entry()(a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                  h.data_ptr(), nb, s_len, d_len, n_len, exp_bits, man_bits,
                  out_exp, out_man, plan.rows,
                  torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "ssm_scan kernel")
    return y, h


def ssm_scan(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 64, bd: int = 256):
    """a, b: (B, S, D, N) decay/injection; c: (B, S, N) readout.

    Returns (y (B, S, D) f32, h_last (B, D, N) f32).  S % chunk == 0 and
    D % bd == 0 are required, as in the JAX package (bd is clamped to D
    after the check).  CPU tensors take ``ssm_scan_ref``; a CUDA tensor
    launches the kernel and counts the launch in ``ssm_scan.launches``."""
    check_shapes(a, b, c)
    B, S, D, N = a.shape
    if S % chunk or D % min(bd, D):
        raise ValueError(f"S={S} % chunk={chunk} or D={D} % bd={bd} != 0")
    if a.device.type == "cpu":
        return ssm_scan_ref(a, b, c)
    if a.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cpu or cuda, got {a.device}")
    out = launch(a, b, c, None, None)
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0
