"""The port's checkpoints, restarts and straggler monitor, and checkpoints
across the two packages.

Tolerances: every restore is bitwise.  A ``TrainState`` of the reduced
tinyllama (bf16 params, f32 moments, int32 counters) written by the JAX
package restores in the port with the same leaves bit for bit, and the
reverse; both write the same manifest ``paths``, ``shapes`` and
``dtypes``.  ``run_with_restarts`` through ``failure_schedule({5, 9})``
ends bitwise equal to the uninterrupted run, as the JAX package's
tests/test_train_infra.py holds its own.  An elastic restart: a tree
saved from a (data=4, model=2) mesh of 8 gloo ranks restores on a
(data=2, model=2) mesh of 4 with other placements, bitwise, and the
sharded save writes the bytes of an unsharded one (the JAX package's
tests/test_distributed.py case).
"""
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import torch

from repro.configs.base import get_config as jget_config
from repro.models import LM as JLM
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
import test_torch_dist_ranks as ranks
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import for_arch, make_batch
from repro_torch.launch.mesh import spawn
from repro_torch.models import LM
from repro_torch.models.convert import train_state_from_jax
from repro_torch.train import tree
from repro_torch.train.checkpoint import (CheckpointManager, load_pytree,
                                          save_pytree)
from repro_torch.train.fault_tolerance import (StragglerMonitor,
                                               failure_schedule,
                                               run_with_restarts)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import (make_train_state,
                                          make_train_step, train_loop)


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_roundtrip_and_gc(tmp_path):
    t = {"a": torch.arange(10, dtype=torch.float32),
         "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16),
               "f8": torch.linspace(-2, 2, 7).to(torch.float8_e4m3fn)},
         "n": torch.tensor(4, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for step in (1, 2, 3):
        mgr.save(step, tree.map(lambda x: (x.float() * step).to(x.dtype),
                                t), block=True)
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    restored, manifest = mgr.restore(t, step=3)
    assert manifest["step"] == 3
    assert manifest["paths"] == ["a", "b/c", "b/f8", "n"]
    assert manifest["dtypes"] == ["float32", "bfloat16", "float8_e4m3fn",
                                  "int32"]
    for a, b in zip(tree.leaves(restored), tree.leaves(t)):
        assert _equal(a, (b.float() * 3).to(b.dtype))
    assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))
    assert mgr.restore(t, step=None)[1]["step"] == 3
    assert CheckpointManager(str(tmp_path / "none")).restore(t) == (None,
                                                                   None)


def test_async_save_copies_before_queueing(tmp_path):
    """The host copy is taken in ``save``: an in-place update right after
    it does not reach the file."""
    w = torch.ones(100)
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(5, {"w": w})
    w.mul_(7)
    mgr.wait()
    assert mgr.latest_step() == 5
    got, _ = mgr.restore({"w": w})
    assert torch.equal(got["w"], torch.ones(100))


def test_bf16_restores_without_ml_dtypes(tmp_path):
    """The card's machine has no ``ml_dtypes``: save and restore bf16 with
    it made unimportable."""
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.train.checkpoint import save_pytree, load_pytree\n"
        "t = {'w': torch.randn(5, 3).to(torch.bfloat16)}\n"
        f"save_pytree(t, {str(tmp_path)!r}, 1)\n"
        f"got, _ = load_pytree({str(tmp_path)!r}, 1, like=t)\n"
        "assert got['w'].dtype == torch.bfloat16\n"
        "assert torch.equal(got['w'].view(torch.int16), "
        "t['w'].view(torch.int16))\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _jax_state():
    cfg = jget_config("tinyllama-1.1b").reduced()
    opt = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30,
                           compress_grads=False)
    js = jtl.make_train_state(JLM(cfg), jax.random.key(3), opt)
    # moments and counters away from zero, so the check sees real bits
    r = np.random.default_rng(0)
    js = js._replace(
        opt=js.opt._replace(
            mu=jax.tree.map(lambda m: r.standard_normal(m.shape)
                            .astype(np.float32), js.opt.mu),
            nu=jax.tree.map(lambda m: r.random(m.shape)
                            .astype(np.float32), js.opt.nu),
            count=np.int32(17)),
        step=np.int32(17))
    return cfg, jax.tree.map(np.asarray, js)


def test_jax_checkpoint_restores_in_port_and_back(tmp_path):
    jcfg, js = _jax_state()
    cfg = get_config("tinyllama-1.1b").reduced()
    like = train_state_from_jax(js, cfg, device="cpu")
    jckpt.save_pytree(js, str(tmp_path / "jax"), 17)
    got, manifest = load_pytree(str(tmp_path / "jax"), 17,
                                like=tree.map(torch.zeros_like, like))
    assert int(got.step) == 17 and int(got.opt.count) == 17
    for a, b in zip(tree.leaves(got), tree.leaves(like)):
        assert _equal(a, b)
    # the reverse: the port writes, the JAX package reads
    save_pytree(like, str(tmp_path / "port"), 17)
    back, _ = jckpt.load_pytree(str(tmp_path / "port"), 17,
                                like=jax.tree.map(np.zeros_like, js))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    manifests = [json.load(open(tmp_path / d / "step_17" / "manifest.json"))
                 for d in ("jax", "port")]
    for k in ("step", "n_leaves", "paths", "shapes", "dtypes", "extra"):
        assert manifests[0][k] == manifests[1][k], k


def test_restart_is_bitwise_identical(tmp_path):
    cfg = get_config("tinyllama-1.1b").reduced()
    model = LM(cfg, device="cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    dcfg = for_arch(cfg, seq_len=16, global_batch=4)

    def data(step):
        return make_batch(dcfg, step, device="cpu")

    step_fn = make_train_step(model, opt)

    def make_state():
        return make_train_state(model, 7, opt)

    ref_state, _ = train_loop(model, make_state(), step_fn, data, n_steps=12)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    final, hist, restarts = run_with_restarts(
        model, make_state, step_fn, data, n_steps=12, manager=mgr,
        checkpoint_every=2, failure_hook=failure_schedule({5, 9}))
    assert restarts == 2
    assert [h["step"] for h in hist] == list(range(9, 13))
    assert int(final.step) == 12
    for a, b in zip(tree.leaves(ref_state), tree.leaves(final)):
        assert _equal(a, b)


def test_straggler_monitor():
    mon = StragglerMonitor(window=8, tolerance=3.0)
    for _ in range(6):
        mon.start()
        time.sleep(0.005)
        mon.stop()
    mon.start()
    time.sleep(0.25)
    m = mon.stop()
    assert m["straggler"] == 1.0 and m["utilization"] < 0.5
    assert mon.straggler_steps >= 1
    assert sorted(m) == ["median_s", "step_time_s", "straggler",
                         "utilization"]


def test_elastic_restore_onto_another_mesh(tmp_path):
    sharded, plain = tmp_path / "sharded", tmp_path / "plain"
    want = np.arange(64, dtype=np.float32).reshape(8, 8)
    saved = spawn(ranks.checkpoint_save, 8, str(sharded), timeout=120)
    for r, local in enumerate(saved):  # (data=4, model=2) by P(data, model)
        i, j = divmod(r, 2)
        assert np.array_equal(local, want[2 * i:2 * i + 2, 4 * j:4 * j + 4])
    CheckpointManager(str(plain), keep=2, async_save=False).save(
        1, {"w": torch.from_numpy(want)}, block=True)
    names = sorted(os.listdir(plain / "step_1"))
    assert names == sorted(os.listdir(sharded / "step_1"))
    for name in names:
        assert (plain / "step_1" / name).read_bytes() == \
            (sharded / "step_1" / name).read_bytes(), name
    restored = spawn(ranks.checkpoint_restore, 4, str(sharded), timeout=120)
    for r, got in enumerate(restored):  # (data=2, model=2) by P(model, data)
        i, j = divmod(r, 2)
        assert got["placements"] == got["want"] == ["S(1)", "S(0)"]
        assert np.array_equal(got["full"], want)
        assert np.array_equal(got["local"],
                              want[4 * j:4 * j + 4, 4 * i:4 * i + 4])
