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


_JAX_CHUNKS = """
import dataclasses, os, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs.base import get_config
from repro.models import LM
from repro.models.model import DecodeCache

cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                          **OVER)
model = LM(cfg)
params = model.init(jax.random.PRNGKey(0))
with open(PARAMS + ".tmp", "wb") as f:  # the port's ranks wait for it
    pickle.dump(jax.tree.map(np.asarray, params), f)
os.rename(PARAMS + ".tmp", PARAMS)
with open(STEPS, "rb") as f:
    steps = pickle.load(f)
try:
    from repro.launch.specs import _cache_specs
    from repro.parallel import sharding as sh
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ctx = sh.make_context(mesh)
    base = model.init_cache(B, MAX_LEN)
    cache = DecodeCache(base.data, jnp.zeros(B, jnp.int32))
    logits = []
    with sh.use_mesh(ctx):
        dp = jax.device_put(params, sh.named_shardings(
            sh.param_specs(params, cfg.n_experts, ctx), ctx))
        dc = jax.device_put(cache, _cache_specs(model, cache, B, ctx))
        for toks, offs, lens, slots in steps:
            last, dc = model.prefill_chunk(
                dp, dc, *(jnp.asarray(a, jnp.int32)
                          for a in (toks, offs, lens, slots)))
            logits.append(np.asarray(last)[slots < B])
    out = dict(logits=logits,
               cache={k: np.asarray(v) for k, v in dc.data.items()},
               length=np.asarray(dc.length).tolist())
except Exception as e:  # the test skips, naming JAX's error
    out = dict(error=f"{type(e).__name__}: {e}")
with open(PATH, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def decode(tmp_path_factory):
    """The ranks' decode and chunk cases, and the JAX package's chunks on
    a (4, 2) mesh of Auto axes computed beside them."""
    d = tmp_path_factory.mktemp("chunks")
    params, steps, ref = (str(d / n) for n in ("params.pkl", "steps.pkl",
                                               "jax.pkl"))
    arch, over, B = ranks.DECODE_CASES[ranks.JAX_CHUNK_CASE]
    vocab = ranks.f32_reduced(arch).vocab_size
    with open(steps, "wb") as f:
        pickle.dump(ranks.chunk_steps(B, vocab, seed=3)[1], f)
    code = (f"ARCH = {arch!r}\nOVER = {over!r}\nB = {B}\nMAX_LEN = "
            f"{ranks.MAX_LEN}\nPARAMS = {params!r}\nSTEPS = {steps!r}\n"
            f"PATH = {ref!r}\n" + _JAX_CHUNKS)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(run_multidevice, code, 8)
        out = spawn(ranks.mesh_decode, 8, params, timeout=300)[0]
        jax_side.result()
    with open(ref, "rb") as f:
        out["jax_reference"] = pickle.load(f)
    return out


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


def _within(got, want, what):
    """The mesh contract: within 1e-5 of max |value| (1 at least)."""
    assert got.shape == want.shape, what
    bound = 1e-5 * max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= bound, what


@pytest.mark.parametrize("entry", ["prefill_chunk", "prefill_chunked"])
@pytest.mark.parametrize("case", list(ranks.DECODE_CASES))
def test_chunked_prefill_on_a_mesh(decode, case, entry):
    """Two chunks and a chunk with a pad lane (``prefill_chunk``), and the
    prompt in chunks (``prefill_chunked``), on (4, 2) against the
    unsharded port: the real lanes' logits and the caches within 1e-5 of
    max |value|, the lengths equal, and the cache laid out as it went in
    (``prefill_chunked``: as ``launch.specs`` lays it out)."""
    run = decode[case]["chunks"]
    if entry == "prefill_chunked":
        run = run["chunked"]
        _within(*reversed(run["logits"]), "last logits")
    else:
        assert len(run["logits"]) == len(ranks.CHUNKS) + 1
        for i, (want, got) in enumerate(run["logits"]):
            _within(got, want, f"chunk {i}")
    for name, (want, got) in run["cache"].items():
        _within(got, want, name)
    assert run["length"][0] == run["length"][1]
    laid_out, back = run["placements"]
    assert back == laid_out


def test_pad_lane_on_a_mesh_writes_nothing(decode):
    """The pad lane's chunk advances lanes 0 and 1 only (lane 0 of a B = 1
    cache): lanes 2 and 3 keep the prompt's length on the mesh."""
    total = ranks.CHUNK_PROMPT + ranks.PAD_CHUNK
    want = [total, total, ranks.CHUNK_PROMPT, ranks.CHUNK_PROMPT]
    for case, (_, _, B) in ranks.DECODE_CASES.items():
        assert decode[case]["chunks"]["length"][1] == want[:B], case


def test_prefill_chunk_on_a_mesh_matches_jax(decode):
    """The ``JAX_CHUNK_CASE`` chunks on (4, 2) from the JAX package's
    parameters against its own ``prefill_chunk`` on a (4, 2) mesh of Auto
    axes: the real lanes' logits and the cache within 1e-4, the lengths
    equal."""
    ref = decode["jax_reference"]
    if "error" in ref:
        pytest.skip(f"the JAX package's sharded prefill_chunk: "
                    f"{ref['error']}")
    got = decode["jax_chunks"]
    assert len(got["logits"]) == len(ref["logits"])
    for g, w in zip(got["logits"], ref["logits"]):
        assert g.shape == w.shape
        assert np.abs(g - w).max() < 1e-4
    for name, w in ref["cache"].items():
        assert np.abs(got["cache"][name] - w).max() < 1e-4, name
    assert got["length"] == ref["length"]
