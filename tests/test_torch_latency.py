"""The port's Fig. 2(c) latency simulator and dependency tracing against
the JAX package.

The reference values come from a subprocess that restores
``jax.experimental.enable_x64`` (dropped in jax 0.9.0) before importing the
JAX package's DSE modules, so the alias never enters this process (see
tests/test_torch_dse.py).  Tolerances:

  * bitwise: every simulator penalty (raw traces with dependences from the
    first op on, ``penalties_for_waits``, ``fig2c_penalties``,
    ``fig2c_reductions_batch``), the mixture ``calibrated_spec_mix`` picks,
    ``SpecMix.sample``, ``chain_penalty``.  Stall counts are integers and
    the mean is rounded as XLA rounds the reference's ``sum / n``:
    float32(sum) * float32(1/n);
  * ``profile_fn``: exact on the reference's test function
    ``sum(tanh(x @ w1) @ w2)``; on a one-layer ``reduced()`` tinyllama
    forward every chain entry (matrix products and reductions: contraction
    lengths and FLOPs) is equal, in order.  Elementwise ops and softmax
    decompose differently in jaxprs and aten, so the independent entries
    are not compared.  The JAX side runs with ``remat=False``: the
    reference's ``profile_jaxpr`` does not enter a ``checkpoint`` body (its
    ``jaxpr`` parameter is an open jaxpr, which has no ``.jaxpr``), so with
    remat on it sees the unembed alone.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import latency_sim as ls
from repro_torch.core import trace as tr
from repro_torch.core.fpu_arch import FABRICATED
from repro_torch.models import LM

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CPU = torch.device("cpu")
PAIRS = [(a, m) for a in range(0, 8) for m in range(0, 9, 2)]
MIX = dict(p_acc=0.3, p_mul=0.12, q_acc=0.15, q_mul=0.45, n_ops=20_000,
           seed=5)
MIXES = [dict(p_acc=pa, p_mul=pm, q_acc=qa, q_mul=qm, n_ops=20_000, seed=s)
         for s, (pa, pm, qa, qm) in enumerate(
             [(0.15, 0.2, 0.15, 0.6), (0.4, 0.05, 0.0, 0.3),
              (0.25, 0.12, 0.3, 0.45), (0.35, 0.16, 0.15, 0.3),
              (0.05, 0.02, 0.9, 0.5), (0.85, 0.1, 0.0, 0.3)])]

_REF = r"""
import dataclasses, pickle, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64  # the name jax 0.9.0 dropped
import jax.numpy as jnp
import numpy as np
from repro.configs.base import get_config
from repro.core import latency_sim as ls, trace as jtr
from repro.core.fpu_arch import FABRICATED
from repro.models import LM

PAIRS, MIX, MIXES = %r, %r, %r
out = {}
rng = np.random.default_rng(11)
types = rng.integers(0, 3, (6, 4000)).astype(np.int32)
dists = rng.integers(1, 33, (6, 4000)).astype(np.int32)
acc = np.array([0, 1, 2, 3, 4, 5, 6, 9], np.int32)
mul = np.array([4, 4, 5, 2, 1, 3, 0, 9], np.int32)
out["raw"] = (types, dists, acc, mul, np.asarray(ls._simulate_traces_configs(
    jnp.asarray(types), jnp.asarray(dists), jnp.asarray(acc),
    jnp.asarray(mul))))
mix = ls.SpecMix(**MIX)
mixes = [ls.SpecMix(**m) for m in MIXES]
out["samples"] = [m.sample() for m in [mix] + mixes]
out["pfw"] = ls.penalties_for_waits(PAIRS, mix)
out["avg"] = [ls.average_latency_penalty(d, mix) for d in FABRICATED.values()]
out["chain"] = [ls.chain_penalty(d, n) for d in FABRICATED.values()
                for n in (0, 1, 2, 17, 4096)]
out["red_batch"] = ls.fig2c_reductions_batch(mixes)
cal = ls.calibrated_spec_mix()
out["cal_mix"] = dataclasses.asdict(cal)
out["fig2c"] = ls.fig2c_penalties(cal)

def rows(prof):
    return [(p.kind, p.chain_len, p.flops) for p in prof]

prof = jtr.profile_fn(lambda x, w1, w2: jnp.sum(jnp.tanh(x @ w1) @ w2),
                      jnp.ones((4, 32)), jnp.ones((32, 16)), jnp.ones((16, 8)))
out["small"] = rows(prof)
out["small_pen"] = [jtr.trace_penalty(d, prof) for d in FABRICATED.values()]
out["small_sum"] = jtr.summarize(prof)
cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), n_layers=1,
                          dtype="float32", remat=False)
lm = LM(cfg)
lp = lm.init(jax.random.PRNGKey(0))
toks = jnp.zeros((2, 8), jnp.int32)
out["lm"] = rows(jtr.profile_fn(lambda p, t: lm.apply(p, t)[0], lp, toks))
jtr._REDUCE_PRIMS.clear()
jtr._ELEMWISE_FP.clear()
out["lm_dots"] = rows(jtr.profile_fn(lambda p, t: lm.apply(p, t)[0], lp,
                                     toks))
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
""" % (PAIRS, MIX, MIXES)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's values, computed in a subprocess (see above)."""
    path = tmp_path_factory.mktemp("latency_ref") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _REF, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture
def fresh_cache():
    ls.clear_penalty_cache()
    yield
    ls.clear_penalty_cache()


def _rows(prof):
    return [(p.kind, p.chain_len, p.flops) for p in prof]


# --------------------------------------------------------------- simulator
def test_simulator_bitwise_on_raw_traces(ref):
    """Arbitrary traces: dependences from op 0 on (reaching before the
    trace), every distance 1..32, waits 0..9."""
    types, dists, acc, mul, want = ref["raw"]
    got = ls._simulate(list(zip(types, dists)), acc, mul, CPU)
    assert got.dtype == np.float64
    assert np.array_equal(got, np.asarray(want, np.float64))


def test_sample_bitwise(ref):
    mixes = [ls.SpecMix(**MIX)] + [ls.SpecMix(**m) for m in MIXES]
    for m, (types, dists) in zip(mixes, ref["samples"]):
        t, d = m.sample()
        assert np.array_equal(t, types) and np.array_equal(d, dists)


def test_penalties_for_waits_bitwise(ref, fresh_cache):
    mix = ls.SpecMix(**MIX)
    got = ls.penalties_for_waits(PAIRS, mix, device=CPU)
    assert np.array_equal(got, ref["pfw"])
    # a second call is answered from the cache, pair order kept
    assert len(ls._PENALTY_CACHE) == len(set(PAIRS))
    again = ls.penalties_for_waits(PAIRS[::-1], mix, device=CPU)
    assert np.array_equal(again, ref["pfw"][::-1])
    assert [ls.average_latency_penalty(d, mix, device=CPU)
            for d in FABRICATED.values()] == ref["avg"]
    assert ls.penalty_from_waits(*PAIRS[7], mix, device=CPU) == ref["pfw"][7]


def test_fig2c_reductions_batch_bitwise(ref):
    got = ls.fig2c_reductions_batch([ls.SpecMix(**m) for m in MIXES],
                                    device=CPU)
    assert np.array_equal(got, ref["red_batch"])


def test_calibrated_spec_mix_and_fig2c_bitwise(ref, fresh_cache):
    """The 270-candidate search picks the reference's mixture; on it the
    Fig. 2(c) penalties are bitwise the reference's, and the reductions
    reproduce the paper's 37% / 57% within 0.05."""
    mix = ls.calibrated_spec_mix(device=CPU)
    assert dataclasses.asdict(mix) == ref["cal_mix"]
    got = ls.fig2c_penalties(mix, device=CPU)
    assert got == ref["fig2c"]
    assert abs(got["reduction_vs_fwd"] - 0.37) < 0.05
    assert abs(got["reduction_vs_nofwd"] - 0.57) < 0.05


def test_chain_penalty_matches(ref):
    assert [ls.chain_penalty(d, n) for d in FABRICATED.values()
            for n in (0, 1, 2, 17, 4096)] == ref["chain"]


# ------------------------------------------------------------------- trace
def test_profile_fn_exact_on_reference_function(ref):
    x, w1, w2 = torch.ones(4, 32), torch.ones(32, 16), torch.ones(16, 8)
    prof = tr.profile_fn(lambda x, a, b: torch.sum(torch.tanh(x @ a) @ b),
                         x, w1, w2)
    assert _rows(prof) == ref["small"]
    assert [tr.trace_penalty(d, prof)
            for d in FABRICATED.values()] == ref["small_pen"]
    assert tr.summarize(prof) == ref["small_sum"]


@pytest.fixture(scope="module")
def one_layer_lm():
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              n_layers=1, dtype="float32", remat=False)
    lm = LM(cfg, device="cpu")
    return lm, lm.init(seed=0), torch.zeros((2, 8), dtype=torch.int64)


def test_profile_fn_tinyllama_matrix_chains_match(ref, one_layer_lm,
                                                  monkeypatch):
    lm, params, toks = one_layer_lm
    full = tr.profile_fn(lambda p, t: lm.apply(p, t)[0], params, toks)
    monkeypatch.setattr(tr, "_REDUCE_OPS", set())
    monkeypatch.setattr(tr, "_ELEMWISE_FP", set())
    dots = tr.profile_fn(lambda p, t: lm.apply(p, t)[0], params, toks)
    assert sorted(_rows(dots)) == sorted(ref["lm_dots"])
    assert len(dots) == 10  # q, k, v, o, gate, up, down, q.k, p.v, unembed
    # the reductions too (rmsnorm's mean, softmax's max and sum), in order
    assert [r for r in _rows(full) if r[0] == "chain"] == \
        [r for r in ref["lm"] if r[0] == "chain"]
