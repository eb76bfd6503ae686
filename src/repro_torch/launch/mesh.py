"""Meshes over the running process group, and ranks to run them on
(counterpart of ``repro.launch.mesh``).

  single pod : (data=16, model=16)            = 256 devices
  multi-pod  : (pod=2, data=16, model=16)     = 512 devices

A ``DeviceMesh`` spans the ranks of an initialised process group (gloo on
the CPU, NCCL on the card), one device per rank, so each function here
raises, naming the sizes, unless the world size is the mesh's.  The card's
rates for a roofline are those of ``roofline.analysis`` (``H100_*``).

``spawn(fn, n)`` is the counterpart of forcing n host devices: it starts n
processes joined in one process group through a file store in a temporary
directory (no network), runs ``fn(rank, *args)`` on each and returns their
results.  A rank that raises fails the call with its traceback; a rank
that dies or hangs fails it at the timeout, and every process is stopped.
"""
from __future__ import annotations

import math
import os
import pickle
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

SINGLE_POD_SHAPE = (16, 16)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")
# seconds a spawned rank waits for the group to start and for each collective
INIT_TIMEOUT = 60.0


def _make_mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh {dict(zip(axes, shape))} of {n} devices "
                           "needs an initialised process group")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"the mesh {dict(zip(axes, shape))} has {n} "
                         f"devices, the process group {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES
    return _make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0):
    """A small mesh over the process group's ranks (tests, launchers)."""
    if pod:
        return _make_mesh((pod, data, model), MULTI_POD_AXES)
    return _make_mesh((data, model), SINGLE_POD_AXES)


def _rank_main(rank, n, backend, store, call, results):
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        torch.set_num_threads(1)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method="file://" + store,
                                rank=rank, world_size=n,
                                timeout=timedelta(seconds=INIT_TIMEOUT))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, n: int, *args, backend: str = "gloo",
          timeout: float = 300.0) -> list:
    """``[fn(0, *args), ..., fn(n-1, *args)]``, each run on its own process
    in a process group of ``n`` ranks on ``backend``.  ``fn`` must be a
    module-level function; its result is pickled by value, so it should
    hold plain tensors or numbers, not DTensors.  ``INIT_TIMEOUT`` bounds
    the group's start and each collective, ``timeout`` the whole call.
    ``fn`` and ``args`` reach the ranks through a file: a large argument
    through the start pipe would start the ranks one after another."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store, call = os.path.join(tmp, "store"), os.path.join(tmp, "call")
        with open(call, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, backend, store, call, results)) for r in range(n)]
        for p in procs:
            p.start()
        done = {}
        deadline = time.monotonic() + timeout
        try:
            while len(done) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(n)) - set(done))
                    raise TimeoutError(f"ranks {missing} of {n} did not "
                                       f"finish within {timeout} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in done and p.exitcode not in (None, 0):
                            raise RuntimeError(
                                f"rank {r} of {n} died with exit code "
                                f"{p.exitcode}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{out}")
                done[rank] = pickle.loads(out)
        finally:
            for p in procs:
                p.join(timeout=5 if len(done) == n else 0.1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
            results.close()
            results.join_thread()
    return [done[r] for r in range(n)]
