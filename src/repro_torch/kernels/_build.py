"""Build the CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` source becomes one shared library with a plain C
interface, ``build/kernels/lib<name>-<hash>.so`` under the checkout, loaded
with ``ctypes``.  The hash covers the sources and the flags, so an edited
kernel is never served from a stale library.  All missing libraries are
compiled at once, one ``nvcc`` process per source, in parallel.  Nothing is
compiled at import time: this module imports on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("quantize", "qmm", "ssm_scan", "flash_attn", "attention_tc")
# no --use_fast_math and no -ftz=true: the rounding functions need IEEE
# division and subnormals
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


class NoBackwardError(RuntimeError):
    """A CUDA kernel was called where autograd would need its gradient.
    The kernels have no backward (nor do the JAX package's Pallas kernels
    they port), and a ``ctypes`` launch leaves no ``grad_fn``, so autograd
    would silently treat the output as a constant."""


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise ``TypeError`` when a DTensor reaches the kernel ``name``'s
    wrapper: a kernel reads one device's memory, so a sharded operand must
    first be made whole by the caller (``numerics.emulate.policy_matmul``
    does so under a mesh), never silently inside a wrapper."""
    if "torch.distributed.tensor" not in sys.modules:
        return  # no DTensor can exist
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{name}: got a DTensor; the kernel runs on one device's local "
            "tensors. Redistribute the operands to Replicate and pass "
            "their local tensors (policy_matmul does this under a mesh)")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``NoBackwardError`` when grad mode is on and an input of the
    kernel ``name`` requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NoBackwardError(
            f"{name}: the CUDA kernel has no backward; an input requires "
            "grad (training under an emulating numerics policy is not "
            "differentiable on the card). Run it without grad, or on the "
            "CPU, whose plain version autograd differentiates")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every library that is missing, all ``nvcc`` processes at
    once.  Returns ``{name: seconds}`` for the libraries it compiled; the
    compiler output (registers, spills) is kept beside each library as
    ``.log``."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    times, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The number of SMs of a CUDA device, for the kernels' planners."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(rc: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
