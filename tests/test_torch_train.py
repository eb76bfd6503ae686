"""The port's training path against the JAX package on the CPU.

Both packages start from the same state: the JAX ``make_train_state``'s,
loaded into the port by ``train_state_from_jax``, and draw the same batches
(the port's ``make_batch`` is bitwise JAX's, tests/test_torch_data.py).
The JAX side runs its step jitted, as its train loop does.  Tolerances:

  * the optimizer (``lr_schedule``, ``apply_updates``, ``compress_grads``)
    against the JAX functions run op by op: within one float32 ulp (they
    measure bitwise on the CPU).  Under ``jax.jit`` XLA rewrites divisions by
    constants into reciprocal products, which the port does not follow;
  * float32 train steps: the loss within rtol 1e-5, ``grad_norm`` within
    rtol 1e-5, every gradient leaf within 1e-4 * max|g|, and the params
    after each step within 0.25 * lr of JAX's.  Adam's first steps move a
    weight by about lr whatever its gradient's size, so a gradient near
    zero whose last bits differ moves its weight differently; 0.25 lr
    bounds the CPU's reading (0.05 lr);
  * bfloat16 train steps (the configs' own dtype): the loss within rtol
    1e-3, ``grad_norm`` within rtol 1e-2 and every gradient leaf within
    2**-5 * max|g| (four bf16 ulps of the largest entry), since the two
    packages round the bf16 activations in different places (the CPU
    reads 1e-4, 1.3e-3 and 1.7e-2 * max|g|);
  * the other families' reduced configs, one float32 step: the loss and
    ``grad_norm`` within rtol 1e-5.

Under ``EmulatedPolicy('bf16', 'fused')`` the bit-level rounding stops the
gradient in both packages: it passes only where an operand of an emulated
matmul is exactly zero (``formats.quantize`` keeps zeros as they are).
With exact zeros planted in a float32 model both packages give the same
gradient (rtol 1e-5); in the bf16 model the zeros come from cancellations
of a forward that is not bitwise between the packages, so only the
structure is held (every leaf but the embedding exactly zero, the norm
below 1e-3 of the unemulated one and within a factor of 4 of JAX's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.data import pipeline as jdata
from repro.models import LM as JLM
from repro.models.numerics import EmulatedPolicy as JPolicy
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch.configs.base import get_config
from repro_torch.data import pipeline as tdata
from repro_torch.models import LM
from repro_torch.models.convert import train_state_from_jax
from repro_torch.models.numerics import EmulatedPolicy
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl
from repro_torch.train import tree

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _t(x):
    return torch.tensor(np.array(x))


# ------------------------------------------------------------- optimizer --
@pytest.mark.parametrize("kw", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    dict(lr=3e-3, warmup_steps=10, total_steps=40),
    dict(lr=1e-3, warmup_steps=2, total_steps=30)])
def test_lr_schedule_matches_jax(kw):
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    for s in (0, 1, 2, 3, 5, 10, 11, 20, 39, 40, 55, 100):
        want = jopt.lr_schedule(jcfg, jnp.int32(s))
        got = topt.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert _ulps(want, got) <= 1, s
    if kw["lr"] == 1.0:  # tests/test_train_infra.py's shape
        lrs = [float(topt.lr_schedule(tcfg, torch.tensor(s)))
               for s in (0, 5, 10, 55, 100)]
        assert lrs[0] == 0.0 and abs(lrs[1] - 0.5) < 1e-6
        assert abs(lrs[2] - 1.0) < 1e-6 and lrs[2] > lrs[3] > lrs[4]
        assert abs(lrs[4] - 0.1) < 1e-6


@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_matches_jax(compress):
    """A mixed-ndim tree (a 1-D leaf is not decayed) over 8 steps, each
    started from JAX's state, with the clip active on some steps."""
    r = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": {"c": (9,), "d": (3, 4, 2)}}

    def draw(scale=1.0):
        return jax.tree.map(
            lambda s: (r.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))

    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=3.0,
              compress_grads=compress)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, draw())
    js = jopt.init_state(jp, jcfg)
    ts0 = topt.init_state(jax.tree.map(_t, jp), tcfg)
    assert all(torch.equal(a, _t(b)) for a, b in zip(
        tree.leaves(ts0), jax.tree.leaves(js)))
    for i in range(8):
        g = draw(0.3 if i % 2 else 1.5)
        tp = jax.tree.map(_t, jp)
        ts = topt.AdamState(*(jax.tree.map(_t, x) for x in js))
        jp, js, jm = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                        js, jcfg)
        tp2, ts2, tm = topt.apply_updates(tp, jax.tree.map(_t, g), ts, tcfg)
        for a, b in zip(jax.tree.leaves((jp, js)), tree.leaves((tp2, ts2))):
            assert a.dtype == np.dtype(str(b.dtype).split(".")[1])
            assert _ulps(a, b) <= 1, i
        for k in ("grad_norm", "lr"):
            assert _ulps(jm[k], tm[k]) <= 1, (i, k)
        # the functional update leaves its inputs alone
        assert all(torch.equal(a, _t(b)) for a, b in
                   zip(tree.leaves(tp), jax.tree.leaves(tp)))


def test_compress_grads_rounds_ties_to_even():
    """max|g| = 127 makes the scale exactly 1: the halves are ties."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 126.5, -127.0],
                 np.float32)
    e = np.zeros_like(g)
    want = jopt.compress_grads({"g": jnp.asarray(g)}, {"g": jnp.asarray(e)})
    got = topt.compress_grads({"g": torch.tensor(g)}, {"g": torch.tensor(e)})
    for a, b in zip(jax.tree.leaves(want), tree.leaves(got)):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert got[0]["g"].tolist() == [127, 0, 2, 2, -2, -0, 4, 126, -127]
    r = np.random.default_rng(5)
    for _ in range(50):
        g = (r.standard_normal(37) * r.choice([1e-3, 1.0, 30.0])
             ).astype(np.float32)
        e = (r.standard_normal(37) * 1e-3).astype(np.float32)
        a = jopt._compress_leaf(jnp.asarray(g), jnp.asarray(e))
        b = topt._compress_leaf(torch.tensor(g), torch.tensor(e))
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), y.numpy())


# ------------------------------------------------------------ train steps --
def _pair(arch, dtype, **over):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype=dtype,
                               **over)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                               **over)
    return JLM(jcfg), LM(tcfg, device="cpu")


def _state(jm):
    jcfg, tcfg = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    js = jtl.make_train_state(jm, jax.random.key(0), jcfg)
    return jcfg, tcfg, js


def _to_port(js, tm):
    return train_state_from_jax(jax.tree.map(np.asarray, js), tm.cfg,
                                device="cpu")


def _batches(jm, tm, step, seq_len=32, batch=4):
    jd = jdata.for_arch(jm.cfg, seq_len=seq_len, global_batch=batch)
    td = tdata.for_arch(tm.cfg, seq_len=seq_len, global_batch=batch)
    return jdata.make_batch(jd, step), tdata.make_batch(td, step,
                                                        device="cpu")


def _grads(jm, tm, js, ts, jb, tb, policy=None):
    jpol = tpol = None
    if policy:
        jpol, tpol = JPolicy(*policy), EmulatedPolicy(*policy)
    gj = jax.jit(jax.grad(lambda p, b: jm.loss_fn(p, b, policy=jpol)[0]))(
        js.params, jb)
    live = [p.detach().requires_grad_(True) for p in tree.leaves(ts.params)]
    loss, _ = tm.loss_fn(tree.unflatten(ts.params, live), tb, policy=tpol)
    gt = torch.autograd.grad(loss, live)
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(gj)], \
        [g.float().numpy() for g in gt]


def _norm(grads):
    return float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in grads)))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tinyllama_steps_match_jax(dtype):
    """Three steps: each from JAX's state (gradients per leaf, the loss,
    the norm and the updated params) and a free-running port state (the
    loss)."""
    f32 = dtype == "float32"
    jm, tm = _pair("tinyllama-1.1b", dtype)
    jcfg, tcfg, js = _state(jm)
    jstep = jax.jit(jtl.make_train_step(jm, jcfg))
    tstep = ttl.make_train_step(tm, tcfg)
    free = _to_port(js, tm)
    for i in range(3):
        jb, tb = _batches(jm, tm, i)
        ts = _to_port(js, tm)
        if i in (0, 2):
            for a, g in zip(*_grads(jm, tm, js, ts, jb, tb)):
                bound = (1e-4 if f32 else 2.0 ** -5) * np.abs(a).max()
                assert np.abs(a - g).max() <= bound, i
        js, jmx = jstep(js, jb)
        ts, tmx = tstep(ts, tb)
        free, fmx = tstep(free, tb)
        assert sorted(tmx) == sorted(jmx)
        assert _rel(jmx["loss"], tmx["loss"]) <= (1e-5 if f32 else 1e-3)
        assert _rel(jmx["loss"], fmx["loss"]) <= (1e-5 if f32 else 1e-3)
        assert _rel(jmx["grad_norm"], tmx["grad_norm"]) \
            <= (1e-5 if f32 else 1e-2)
        assert _ulps(jmx["lr"], tmx["lr"]) <= 1
        assert int(ts.step) == int(js.step) == i + 1
        if f32:
            lr = float(jmx["lr"])
            for a, b in zip(jax.tree.leaves(js.params),
                            tree.leaves(ts.params)):
                assert np.abs(np.asarray(a) - b.numpy()).max() <= 0.25 * lr


def test_microbatches_match_jax():
    """``microbatches=2``: the loss and norm of JAX's accumulate path, whose
    metrics hold no per-microbatch keys; the same loss as one batch."""
    jm, tm = _pair("tinyllama-1.1b", "float32")
    jcfg, tcfg, js = _state(jm)
    jb, tb = _batches(jm, tm, 0)
    _, jmx = jax.jit(jtl.make_train_step(jm, jcfg, microbatches=2))(js, jb)
    ts = _to_port(js, tm)
    ts2, tmx = ttl.make_train_step(tm, tcfg, microbatches=2)(ts, tb)
    assert sorted(tmx) == sorted(jmx) == ["grad_norm", "loss", "lr"]
    assert _rel(jmx["loss"], tmx["loss"]) <= 1e-5
    assert _rel(jmx["grad_norm"], tmx["grad_norm"]) <= 1e-5
    _, one = ttl.make_train_step(tm, tcfg)(_to_port(js, tm), tb)
    assert _rel(one["loss"], tmx["loss"]) <= 1e-5


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b",
                                  "deepseek-moe-16b", "internvl2-1b",
                                  "musicgen-large"])
def test_family_step_matches_jax(arch):
    """One float32 step of each other family: the vlm's prefix embeddings
    are not scored, the audio model reads frames, the MoE adds its
    load-balance loss."""
    jm, tm = _pair(arch, "float32")
    jcfg, tcfg, js = _state(jm)
    jb, tb = _batches(jm, tm, 0, seq_len=24, batch=2)
    _, jmx = jax.jit(jtl.make_train_step(jm, jcfg))(js, jb)
    _, tmx = ttl.make_train_step(tm, tcfg)(_to_port(js, tm), tb)
    assert sorted(tmx) == sorted(jmx)
    for k in ("loss", "ce", "grad_norm"):
        assert _rel(jmx[k], tmx[k]) <= 1e-5, k
    assert float(tmx["tokens"]) == float(jmx["tokens"])
    if arch == "deepseek-moe-16b":
        assert float(tmx["aux_loss"]) > 0
        assert _rel(jmx["aux_loss"], tmx["aux_loss"]) <= 1e-5


# ------------------------------------------------------- emulating policy --
def test_emulated_gradient_passes_only_at_exact_zeros():
    """float32 model, two embedding columns planted at zero: the only
    gradient left is through those zeros, and it is JAX's."""
    jm, tm = _pair("tinyllama-1.1b", "float32")
    _, _, js = _state(jm)
    emb = np.array(js.params["embed"])
    emb[:, :2] = 0.0
    js = js._replace(params=dict(js.params, embed=jnp.asarray(emb)))
    ts = _to_port(js, tm)
    jb, tb = _batches(jm, tm, 0)
    gj, gt = _grads(jm, tm, js, ts, jb, tb, policy=("bf16", "fused"))
    for path, a, g in zip(tree.paths(ts.params), gj, gt):
        assert np.array_equal(a != 0, g != 0), path
        if path != "embed":
            assert not a.any(), path
        assert np.abs(a - g).max() <= 1e-4 * np.abs(a).max(), path
    na, ng = _norm(gj), _norm(gt)
    assert na > 0 and abs(na - ng) <= 1e-5 * na


def test_emulated_bf16_gradient_is_nearly_zero_in_both():
    jm, tm = _pair("tinyllama-1.1b", "bfloat16")
    _, _, js = _state(jm)
    ts = _to_port(js, tm)
    jb, tb = _batches(jm, tm, 0)
    plain_j, plain_t = map(_norm, _grads(jm, tm, js, ts, jb, tb))
    gj, gt = _grads(jm, tm, js, ts, jb, tb, policy=("bf16", "fused"))
    emu_j, emu_t = _norm(gj), _norm(gt)
    assert 0 < emu_j < 1e-3 * plain_j and 0 < emu_t < 1e-3 * plain_t
    assert 0.25 < emu_t / emu_j < 4.0
    for path, a, g in zip(tree.paths(ts.params), gj, gt):
        if path != "embed":
            assert not a.any() and not g.any(), path
