"""The port's GPipe schedule (``parallel/pipeline.py``) on 4 gloo ranks
against the JAX package's ``pipeline_forward`` on 4 forced host devices
and against the sequential loop, on the CPU.

4 stages of tanh(h @ W_s), 8 microbatches of 2 rows, d 16 (the JAX
package's tests/test_distributed.py case).  Every rank returns the
outputs, which the last stage sums to all of them.  Tolerance: 1e-5, the
JAX test's, against both.
"""
import concurrent.futures
import pickle

import numpy as np
import pytest

from helpers import run_multidevice
import test_torch_dist_ranks as ranks
from repro_torch.launch.mesh import spawn

N_STAGES, N_MICRO, MB, D = 4, 8, 2, 16

_JAX = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.parallel.pipeline import pipeline_forward
with open(IN, "rb") as f:
    ws, x = pickle.load(f)
mesh = jax.make_mesh((4,), ("pod",))
fn = pipeline_forward(lambda w, h: jnp.tanh(h @ w), 4, mesh, axis="pod")
with open(OUT, "wb") as f:
    pickle.dump(np.asarray(jax.jit(fn)(jnp.asarray(ws), jnp.asarray(x))), f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((N_STAGES, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((ws, x), f)
    code = f"IN = {str(d / 'in.pkl')!r}\nOUT = {str(d / 'out.pkl')!r}\n" \
        + _JAX
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(run_multidevice, code, 4)
        port = spawn(ranks.pipeline, 4, ws, x, timeout=120)
        jax_side.result()
    with open(d / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    seq = x
    for s in range(N_STAGES):
        seq = np.tanh(seq @ ws[s])
    return port, ref, seq


def test_pipeline_matches_jax(runs):
    port, ref, _ = runs
    for out in port:
        assert out.shape == (N_MICRO, MB, D)
        assert np.abs(out - ref).max() < 1e-5


def test_pipeline_matches_sequential(runs):
    port, _, seq = runs
    for out in port:
        assert np.abs(out - seq).max() < 1e-5
