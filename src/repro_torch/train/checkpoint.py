"""Checkpointing: atomic, keep-K, with an asynchronous save thread
(counterpart of ``repro.train.checkpoint``).

Layout, the JAX package's: ``<dir>/step_<N>/manifest.json`` and one
``leaf_<i>.npy`` per leaf, the leaves in JAX's order (sorted dict keys,
then tuple and NamedTuple fields; the optimizer's empty ``err`` gives
none), with the manifest's ``step``, ``n_leaves``, ``treedef``, ``paths``,
``shapes``, ``dtypes`` and ``extra``.  numpy has no bfloat16 or float8, so
those leaves are stored as same-width unsigned views under their dtype's
name and restored through torch views (no ``ml_dtypes`` needed).  A
checkpoint written by either package restores in the other.

A sharded state (DTensor leaves) is saved as its full tensors, the same
bytes as an unsharded save; in a process group only rank 0 writes, and
every rank takes part in gathering the leaves.  ``shardings`` restores
onto a mesh, which may be of another shape than the one saved from (an
elastic restart).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel import sharding as sh
from repro_torch.train import tree as tree_util

# dtype name -> (the numpy dtype stored, the signed numpy twin torch reads,
# the torch view of that twin, the torch dtype)
_VIEWS = {"bfloat16": (np.uint16, np.int16, torch.int16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, np.uint8, torch.uint8,
                            torch.float8_e4m3fn),
          "float8_e5m2": (np.uint8, np.uint8, torch.uint8,
                          torch.float8_e5m2)}


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_savable(leaf) -> np.ndarray:
    """A host numpy array of the leaf (viewed as unsigned where numpy has no
    such dtype)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    name = _dtype_name(t)
    if name in _VIEWS:
        stored, _, t_view, _ = _VIEWS[name]
        return t.view(t_view).numpy().view(stored)
    return t.numpy()


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _VIEWS:
        _, twin, _, t_dtype = _VIEWS[dtype_name]
        return torch.from_numpy(arr.view(twin)).view(t_dtype)
    return torch.from_numpy(arr)


def _describe(tree) -> str:
    """The tree's structure with '*' for each leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_describe(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        return "[" + ", ".join(_describe(v) for v in tree) + "]"
    return "*"


def save_pytree(tree, directory: str, step: int,
                extra: Optional[dict] = None) -> str:
    """Atomic checkpoint write: stage into ``.tmp_step_<N>``, rename."""
    flat = tree_util.leaves(tree)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "n_leaves": len(flat),
        "treedef": _describe(tree),
        "paths": tree_util.paths(tree),
        "shapes": [list(leaf.shape) for leaf in flat],
        "dtypes": [_dtype_name(leaf) for leaf in flat],
        "extra": extra or {},
    }
    for i, leaf in enumerate(flat):
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), _to_savable(leaf))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _writer() -> bool:
    """This process writes checkpoints: rank 0 of a process group, or a
    process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def load_pytree(directory: str, step: int, like=None, shardings=None):
    """Load a checkpoint into the structure of ``like``, each leaf cast to
    the dtype and device of ``like``'s leaf.  ``shardings``: a tree like
    ``like`` of ``parallel.sharding.NamedSharding``; each leaf then becomes
    a DTensor on its mesh with its placements, every rank keeping its own
    slice of the file's full tensor.  Returns (tree, manifest)."""
    if like is None:
        raise ValueError("load_pytree needs a `like` pytree for structure")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like_flat = tree_util.leaves(like)
    if manifest["n_leaves"] != len(like_flat):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"the tree {len(like_flat)}")
    leaves = [_from_saved(np.load(os.path.join(d, f"leaf_{i}.npy")),
                          manifest["dtypes"][i])
              for i in range(manifest["n_leaves"])]
    leaves = [a.to(device=l.device, dtype=l.dtype)
              for a, l in zip(leaves, like_flat)]
    if shardings is not None:
        from torch.distributed.tensor import distribute_tensor
        leaves = [distribute_tensor(a.to(s.mesh.device_type), s.mesh,
                                    s.placements, src_data_rank=None)
                  for a, s in zip(leaves, tree_util.leaves(shardings))]
    return tree_util.unflatten(like, leaves), manifest


class CheckpointManager:
    """keep-K, async background save, latest-step discovery."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async = async_save
        self._q: "queue.Queue" = queue.Queue()
        self._worker = None
        if async_save:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # -- discovery ----------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save/restore -------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[dict] = None,
             block: bool = False):
        """Copy every leaf to the host now (so training may overwrite its
        tensors; a DTensor's full tensor, gathered by every rank), then
        write, in the background thread unless ``block``.  In a process
        group only rank 0 writes, and a blocking save ends at a barrier, so
        every rank may restore right after it."""
        host_tree = tree_util.map(
            lambda x: sh.full(x.detach()).to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.array(x), tree)
        if _writer() and self._async and not block:
            self._q.put((step, host_tree, extra))
        elif _writer():
            save_pytree(host_tree, self.directory, step, extra)
            self._gc()
        if block and dist.is_initialized():
            dist.barrier()

    def restore(self, like, step: Optional[int] = None, shardings=None):
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        return load_pytree(self.directory, step, like=like,
                           shardings=shardings)

    def wait(self):
        self._q.join()

    def _drain(self):
        while True:
            step, tree, extra = self._q.get()
            try:
                save_pytree(tree, self.directory, step, extra)
                self._gc()
            finally:
                self._q.task_done()

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
