"""The port's distributed MoE (``models/moe_sharded.py``) on (data=4,
model=2) gloo ranks against the JAX package's, on the CPU.

Three cases of ``moe_apply_distributed`` (d 32, moe_d_ff 16, two shared
experts, top-2, capacity factor 8, so nothing drops), the JAX package's
tests/test_distributed.py layer and its two other branches:

  * EP: 4 experts, which the data axis divides (the all-to-all path);
  * TP: 6 experts, which it does not (the ZeRO-3 weight gathers);
  * the small-batch fallback: a batch of 2 that the 4 data shards do not
    divide (the single-program ``moe_apply`` on every rank).

The JAX side runs in one subprocess with 8 forced host devices: it draws
each case's ``moe_init`` weights and inputs, writes them for the port's
ranks (which start meanwhile) and runs its ``moe_apply_distributed``
jitted.  Tolerances: the output within 1e-5 of JAX's, the aux loss and the
dropped share within 1e-6; against the port's own ``moe_apply`` the output
within the JAX test's 1e-4, and the gradients of ``sum(out * r)`` with
respect to every weight and the input within 1e-5 * max|g| (the
collectives' backward: the all-to-all's inverse, the sums over 'model',
the gathers' reduce-scatter).  The aux loss is the mean of the shards'
losses, not the whole batch's, so it is held only against JAX's
distributed one.
"""
import concurrent.futures
import pickle

import numpy as np
import pytest
import torch

from helpers import run_multidevice
import test_torch_dist_ranks as ranks
from repro_torch.launch.mesh import spawn
from repro_torch.models.moe import moe_apply, moe_init

CASES = {"ep": (4, 8, 0), "tp": (6, 8, 1), "fallback": (4, 2, 2)}

_JAX = """
import os, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_host_mesh
from repro.models.moe import moe_init
from repro.models.moe_sharded import moe_apply_distributed
from repro.parallel import sharding as sh

cases = []
for E, B, seed in CASES:
    p = moe_init(jax.random.key(seed), 32, n_experts=E, moe_d_ff=16,
                 n_shared=2, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    cases.append(dict(p=jax.tree.map(np.array, p), top_k=2, cf=8.0,
                      x=rng.standard_normal((B, 16, 32)).astype(np.float32),
                      r=rng.standard_normal((B, 16, 32)).astype(np.float32)))
with open(INPUTS + ".tmp", "wb") as f:  # the port's ranks wait for it
    pickle.dump(cases, f)
os.rename(INPUTS + ".tmp", INPUTS)

mesh = make_host_mesh(data=4, model=2)
ctx = sh.make_context(mesh)
out = []
with sh.use_mesh(ctx):
    def f(p, x):
        y, aux = moe_apply_distributed(p, x, top_k=2, capacity_factor=8.0,
                                       ctx=ctx)
        return y, aux["aux_loss"], aux["dropped_frac"]
    for c in cases:
        y, aux, dropped = jax.jit(f)(c["p"], jnp.asarray(c["x"]))
        out.append(dict(out=np.asarray(y), aux=float(aux),
                        dropped=float(dropped)))
with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    inputs, out = str(d / "in.pkl"), str(d / "out.pkl")
    code = (f"CASES = {list(CASES.values())!r}\nINPUTS = {inputs!r}\n"
            f"OUT = {out!r}\n" + _JAX)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(run_multidevice, code, 8)
        port = spawn(ranks.moe_cases, 8, inputs, timeout=180)[0]
        jax_side.result()
    with open(out, "rb") as f:
        ref = pickle.load(f)
    return {name: (port[i], ref[i]) for i, name in enumerate(CASES)}


@pytest.mark.parametrize("case", list(CASES))
def test_distributed_moe_matches_jax(runs, case):
    port, ref = runs[case]
    got = port["dist"]
    assert np.abs(got["out"] - ref["out"]).max() < 1e-5
    assert abs(got["aux"] - ref["aux"]) < 1e-6
    assert abs(got["dropped"] - ref["dropped"]) < 1e-6


@pytest.mark.parametrize("case", list(CASES))
def test_distributed_moe_matches_moe_apply(runs, case):
    got, want = runs[case][0]["dist"], runs[case][0]["local"]
    assert np.abs(got["out"] - want["out"]).max() < 1e-4
    assert got["dropped"] == want["dropped"] == 0.0
    for g, w in zip(got["grads"], want["grads"]):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def test_shard_fn_sees_the_expert_buffer_once():
    gen = torch.Generator()
    gen.manual_seed(0)
    p = moe_init(gen, 32, n_experts=4, moe_d_ff=16, n_shared=2,
                 dtype=torch.float32)
    x = torch.randn((2, 8, 32), generator=gen)
    calls = []

    def hook(t, kind):
        calls.append((kind, tuple(t.shape)))
        return t

    want, _ = moe_apply(p, x, top_k=2, capacity_factor=1.25)
    got, _ = moe_apply(p, x, top_k=2, capacity_factor=1.25, shard_fn=hook)
    assert calls == [("expert_buffer", (4, 10, 32))]  # cap int(1.25*16*2/4)
    assert torch.equal(got, want)
