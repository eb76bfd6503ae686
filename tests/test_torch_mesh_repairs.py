"""Two repairs of the port's sharded model, on CPU gloo ranks.

Uneven head shards: reduced float32 tinyllama with 2 kv heads on
(data=2, model=4), where the 'model' axis does not divide the kv heads
(the fault hit 6 of the 10 configs' production cells; the distribution
tests' reduced configs have 1, 4 or no kv heads on an axis of 2).
``LM.apply``'s logits and one train step from the JAX package's initial
state are held to the unsharded port and to the JAX package's own
sharded step on a (2, 4) mesh of Auto axes, by the distribution tests'
contract: the loss within 1e-4 relative, every logit and parameter within
1e-4.

Decode under a mesh: 8 ``decode_step``s after a prefill, with the params
and the cache laid out on (data=4, model=2) as ``launch.specs`` lays them
out (the kv heads sharded, or the head dim when the kv heads are few, the
lanes over 'data', the ssm conv and state channels, a B = 1 cache's
sequence over 'data'), for the dense family both ways, the ring cache
(mixtral), ssm, hybrid and the B = 1 sequence-sharded cache: every step's
logits and the final caches within 1e-5 of max |value| of the unsharded
decode's (the readings are 4e-7 to 1.1e-6: float32 sums of the sharded
contractions taken in another order), the lengths equal, and the cache
still laid out as it came in.
"""
import concurrent.futures
import pickle

import numpy as np
import pytest

from helpers import run_multidevice
import test_torch_dist_ranks as ranks
from repro_torch.launch.mesh import spawn

_JAX = """
import dataclasses, os, pickle
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs.base import get_config
from repro.data.pipeline import for_arch, make_batch
from repro.models import LM
from repro.parallel import sharding as sh
from repro.train.optimizer import AdamWConfig
from repro.train.train_loop import make_train_state, make_train_step

def np_tree(t):
    return jax.tree.map(lambda a: np.array(a), t)

cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                          dtype="float32", **UNEVEN)
model = LM(cfg)
opt = AdamWConfig(**OPT)
state = jax.jit(lambda k: make_train_state(model, k, opt))(jax.random.key(0))
with open(STATES + ".tmp", "wb") as f:  # the port's ranks wait for it
    pickle.dump((np_tree(state.params),
                 (np_tree(state.opt.mu), np_tree(state.opt.nu),
                  np.array(state.opt.count), np_tree(state.opt.err)),
                 np.array(state.step)), f)
os.rename(STATES + ".tmp", STATES)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
ctx = sh.make_context(mesh)
batch = make_batch(for_arch(cfg, seq_len=SEQ_LEN, global_batch=BATCH), 0)
with sh.use_mesh(ctx):
    specs = sh.param_specs(state, cfg.n_experts, ctx)
    sharded = jax.device_put(state, sh.named_shardings(specs, ctx))
    new, m = jax.jit(make_train_step(model, opt))(sharded, batch)
with open(PATH, "wb") as f:
    pickle.dump(dict(metrics={k: float(v) for k, v in m.items()},
                     params=[np.asarray(a)
                             for a in jax.tree.leaves(new.params)]), f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("repairs")
    states, ref = str(d / "states.pkl"), str(d / "jax.pkl")
    code = (f"UNEVEN = {ranks.UNEVEN!r}\nOPT = {ranks.OPT!r}\nSEQ_LEN = "
            f"{ranks.SEQ_LEN}\nBATCH = {ranks.BATCH}\nPATH = {ref!r}\n"
            f"STATES = {states!r}\n" + _JAX)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(run_multidevice, code, 8)
        uneven = spawn(ranks.uneven_heads, 8, states, timeout=240)[0]
        jax_side.result()
    with open(ref, "rb") as f:
        return pickle.load(f), uneven


@pytest.fixture(scope="module")
def decode():
    return spawn(ranks.mesh_decode, 8, timeout=240)[0]


def test_uneven_heads_logits(runs):
    want, got = runs[1]["logits"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("against", ["port", "jax"])
def test_uneven_heads_train_step(runs, against):
    ref, uneven = runs
    want = uneven["port"] if against == "port" else ref
    got = uneven["sharded"]
    loss, want_loss = got["metrics"]["loss"], want["metrics"]["loss"]
    assert abs(loss - want_loss) / abs(want_loss) < 1e-4
    assert len(got["params"]) == len(want["params"])
    for a, b in zip(got["params"], want["params"]):
        assert np.abs(a - b).max() < 1e-4


@pytest.mark.parametrize("case", list(ranks.DECODE_CASES))
def test_decode_on_a_mesh(decode, case):
    run = decode[case]
    want, got = run["logits"]
    assert got.shape == want.shape == (ranks.DECODE_STEPS,
                                       ranks.DECODE_CASES[case][2], 1,
                                       got.shape[-1])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for name, (w, g) in run["cache"].items():
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0), name
    assert run["length"][0] == run["length"][1] == (ranks.PROMPT
                                                    + ranks.DECODE_STEPS)


def test_decode_keeps_the_cache_layout(decode):
    """The cache comes back laid out as it went in: kv heads, or the head
    dim, on 'model', lanes on 'data', a B = 1 cache's sequence on 'data'."""
    assert decode["dense"]["placements"]["k"] == ["S(1)", "S(3)"]
    assert decode["dense_head_dim"]["placements"]["k"] == ["S(1)", "S(4)"]
    assert decode["sequence"]["placements"]["k"] == ["S(2)", "S(3)"]
    assert decode["ssm"]["placements"] == {"conv": ["S(1)", "S(3)"],
                                           "h": ["S(1)", "S(2)"]}
