"""The port's sharded training and sharded forward on (data=4, model=2)
gloo ranks, against the JAX package on the CPU.

Both packages start from the JAX ``make_train_state`` of the reduced
float32 tinyllama and deepseek-moe (the port's through
``train_state_from_jax``) and take one step of AdamW(lr 1e-3, warmup 1) on
``make_batch(seq_len=32, global_batch=8)``, the JAX package's
tests/test_distributed.py setting.  The JAX side runs in one subprocess
with 8 forced host devices: its unsharded jitted steps, and deepseek-moe's
sharded step with the state laid out by ``param_specs``.  That sharded
step is the one the JAX package's own test takes; the test fails under
jax 0.9.0 only because ``jax.make_mesh`` now defaults to Explicit axes,
which ``with_sharding_constraint`` refuses, so here the mesh has Auto
axes.  The subprocess first writes the JAX initial states
(numpy trees) for the port's side, 8 spawned gloo ranks
(tests/test_torch_dist_ranks.py), which start meanwhile and run while the JAX
steps compile.

The contract is the JAX test's own: the loss within 1e-4 relative and
every parameter within 1e-4.  The sharded tinyllama step meets it against
both unsharded steps.  deepseek-moe's ``_ffn`` takes
``moe_apply_distributed``, whose load-balance loss is the mean over the
data shards of each shard's loss, not the loss of the whole batch
(``src/repro/models/moe_sharded.py``): 0.01 * that difference moves the
loss by 1.04e-4 relative, in the JAX package's own sharded step as in the
port's, and AdamW's first step, which moves a weight by about lr whatever
its gradient's size, turns the small gradient change into weights ~2 lr
apart.  So deepseek-moe's sharded step is held to the contract against
JAX's sharded step (every metric and parameter), and against the
unsharded steps by the terms the shards do not change: the cross-entropy
and the z-loss, within 1e-4 relative; and its weights are held to the
port's unsharded step within Adam's bound of 2.5 lr.

A sharded ``LM.apply`` of each other family (falcon-mamba, zamba2,
mixtral, internvl2, musicgen, reduced float32, the port's own weights)
gives the unsharded logits within 1e-4.
"""
import concurrent.futures
import pickle

import numpy as np
import pytest

from helpers import run_multidevice
import test_torch_dist_ranks as ranks
from repro_torch.launch.mesh import spawn

ARCHS = ("tinyllama-1.1b", "deepseek-moe-16b")
# AdamW's first step moves a weight by at most ~lr (m/sqrt(v) = sign(g)),
# so two steps from one state differ by at most 2 lr, with room for decay
ADAM_BOUND_LR = 2.5

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

def record(state, m):
    return dict(metrics={k: float(v) for k, v in m.items()},
                params=[np.asarray(a) for a in jax.tree.leaves(state.params)])

def np_tree(t):
    return jax.tree.map(lambda a: np.array(a), t)

models, states = {}, {}
for arch in ARCHS:
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    models[arch] = LM(cfg)
    js = jax.jit(lambda k: make_train_state(models[arch], k,
                                            AdamWConfig(**OPT)))(
        jax.random.key(0))
    states[arch] = (js, (np_tree(js.params),
                         (np_tree(js.opt.mu), np_tree(js.opt.nu),
                          np.array(js.opt.count), np_tree(js.opt.err)),
                         np.array(js.step)))
with open(STATES + ".tmp", "wb") as f:  # the port's ranks wait for it
    pickle.dump({a: s[1] for a, s in states.items()}, f)
os.rename(STATES + ".tmp", STATES)

out = {}
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
ctx = sh.make_context(mesh)
for arch in ARCHS:
    model, state = models[arch], states[arch][0]
    cfg = model.cfg
    batch = make_batch(for_arch(cfg, seq_len=SEQ_LEN, global_batch=BATCH), 0)
    step = make_train_step(model, AdamWConfig(**OPT))
    out[arch] = {"unsharded": record(*jax.jit(step)(state, batch))}
    if cfg.n_experts:
        with sh.use_mesh(ctx):
            specs = sh.param_specs(state, cfg.n_experts, ctx)
            sharded = jax.device_put(state, sh.named_shardings(specs, ctx))
            out[arch]["sharded"] = record(*jax.jit(step)(sharded, batch))
with open(PATH, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    states, ref = str(d / "states.pkl"), str(d / "jax.pkl")
    code = (f"ARCHS = {ARCHS!r}\nOPT = {ranks.OPT!r}\nSEQ_LEN = "
            f"{ranks.SEQ_LEN}\nBATCH = {ranks.BATCH}\nPATH = {ref!r}\n"
            f"STATES = {states!r}\n" + _JAX)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(run_multidevice, code, 8)
        steps, apply = spawn(ranks.train_and_apply, 8, states,
                              timeout=240)[0]
        jax_side.result()
    with open(ref, "rb") as f:
        return pickle.load(f), steps, apply


def _rel(a, b):
    return abs(a - b) / abs(b)


def _max_err(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def _holds(got, want, keys):
    for k in keys:
        assert _rel(got["metrics"][k], want["metrics"][k]) < 1e-4, k


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax(runs, arch):
    jax_out, steps, _ = runs
    got, ref = steps[arch]["sharded"], jax_out[arch]
    _holds(got, ref["unsharded"], ("ce", "z_loss"))
    if arch == "tinyllama-1.1b":
        _holds(got, ref["unsharded"], ("loss", "grad_norm"))
        assert _max_err(got["params"], ref["unsharded"]["params"]) < 1e-4
    else:
        _holds(got, ref["sharded"], ("loss", "ce", "z_loss", "aux_loss",
                                     "grad_norm"))
        assert _max_err(got["params"], ref["sharded"]["params"]) < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_port_unsharded(runs, arch):
    _, steps, _ = runs
    got, want = steps[arch]["sharded"], steps[arch]["port"]
    _holds(got, want, ("ce", "z_loss"))
    assert got["metrics"]["tokens"] == want["metrics"]["tokens"]
    if arch == "tinyllama-1.1b":
        _holds(got, want, ("loss", "grad_norm"))
        assert _max_err(got["params"], want["params"]) < 1e-4
    else:
        assert _max_err(got["params"], want["params"]) < \
            ADAM_BOUND_LR * ranks.OPT["lr"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_state_keeps_its_layout(runs, arch):
    """The updated params stay laid out by ``param_specs`` and the step
    counts one."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import tree
    cfg = get_config(arch).reduced()
    ctx = sh.make_context({"data": 4, "model": 2})
    specs = sh.param_specs(LM(cfg, device="meta").init(0), cfg.n_experts,
                           ctx)
    want = [str(sh.placements(s, ctx.axes)) for s in tree.leaves(specs)]
    got = runs[1][arch]["sharded"]
    assert got["placements"] == want and got["step"] == 1


@pytest.mark.parametrize("arch", ranks.FAMILY_ARCHS)
def test_family_apply_sharded(runs, arch):
    plain, sharded = runs[2][arch]
    assert sharded.shape == plain.shape
    assert np.abs(plain - sharded).max() < 1e-4
