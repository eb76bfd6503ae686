"""The port's production cells (``launch/specs.py``) against the JAX
package's ``make_cell``, on the CPU.

For every arch and each of its cells (``configs.base.cells``) at full
size on (data=4, model=2): the kind, each argument leaf's shape and dtype
(meta tensors here, ``ShapeDtypeStruct``s there) and each argument's
sharding spec, leaf for leaf in JAX's order.  The JAX side runs in one
subprocess with 8 forced host devices and dumps them as JSON; the port's
cells are built in this process on a context of the mesh's sizes alone.
One stated difference: the decode cache's length is int64 in the port,
int32 in the JAX package.

The train and prefill cells of reduced float32 tinyllama (seq_len 32,
batch 8) also run, on 8 gloo ranks from their shardings (the batch too),
against the unsharded step and prefill: the loss within 1e-4 relative,
the params, logits and KV cache within 1e-4.
"""
import concurrent.futures
import json

import numpy as np
import pytest

from helpers import run_multidevice
import test_torch_dist_ranks as ranks
from repro_torch.configs.base import ARCH_IDS, cells
from repro_torch.launch.mesh import spawn
from repro_torch.launch.specs import make_cell
from repro_torch.parallel import sharding as sh
from repro_torch.train import tree

CELLS = [(a, c) for a in ARCH_IDS for c in cells(a)]

_JAX = """
import concurrent.futures
import json
import jax
from jax.sharding import NamedSharding
from repro.configs.base import ARCH_IDS, cells
from repro.launch.mesh import make_host_mesh
from repro.launch.specs import make_cell
from repro.parallel import sharding as sh

ctx = sh.make_context(make_host_mesh(data=4, model=2))
out = {}
for arch in ARCH_IDS:
    for name in cells(arch):
        cell = make_cell(arch, name, ctx)
        args = jax.tree.leaves(cell.arg_shapes)
        specs = jax.tree.leaves(cell.in_shardings,
                                is_leaf=lambda x: isinstance(x, NamedSharding))
        out[arch + "/" + name] = dict(
            kind=cell.kind, unit=cell.unit,
            args=[[list(a.shape), str(a.dtype)] for a in args],
            specs=[[list(e) if isinstance(e, tuple) else e
                    for e in s.spec] for s in specs])
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    """The JAX cells' JSON, and the reduced cells run on 8 ranks
    meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(run_multidevice, _JAX, 8)
        reduced = spawn(ranks.cells_run, 8, timeout=240)[0]
        out = jax_side.result()
    return json.loads(out.split("JSON", 1)[1]), reduced


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reduced_runs(runs):
    return runs[1]


def _port(arch, name):
    cell = make_cell(arch, name, sh.make_context({"data": 4, "model": 2}))
    args = [[list(a.shape), str(a.dtype).removeprefix("torch.")]
            for a in tree.leaves(cell.arg_shapes)]
    specs = [[list(e) if isinstance(e, tuple) else e for e in s.spec]
             for s in tree.leaves(cell.in_shardings)]
    return dict(kind=cell.kind, unit=cell.unit, args=args, specs=specs)


@pytest.mark.parametrize("arch,name", CELLS)
def test_cell_matches_jax(ref, arch, name):
    got, want = _port(arch, name), ref[arch + "/" + name]
    if got["kind"] == "decode":  # the cache length: int64 here
        idx = [i for i, (s, d) in enumerate(got["args"])
               if s == [] and d == "int64"]
        assert len(idx) == 1 and want["args"][idx[0]] == [[], "int32"]
        got["args"][idx[0]][1] = "int32"
    assert got == want


def test_reduced_train_cell_runs_sharded(reduced_runs):
    plain, sharded = reduced_runs["train"]["loss"]
    assert abs(sharded - plain) / abs(plain) < 1e-4
    for a, b in reduced_runs["train"]["params"]:
        assert np.abs(a - b).max() < 1e-4


def test_reduced_prefill_cell_runs_sharded(reduced_runs):
    run = reduced_runs["prefill"]
    for key in ("logits", "k"):
        want, got = run[key]
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-4
    assert run["length"] == (ranks.SEQ_LEN, ranks.SEQ_LEN)
