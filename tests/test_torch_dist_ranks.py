"""Per-rank bodies of the port's distributed tests, run on spawned gloo
ranks by ``repro_torch.launch.mesh.spawn`` (module-level so that the ranks
can import them); it holds no test itself.  This module imports no JAX:
the reference's inputs reach the ranks as numpy arrays, and each rank
returns numpy arrays."""
import dataclasses
import os
import pickle
import time

import numpy as np
import torch

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.data.pipeline import for_arch, make_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM
from repro_torch.parallel import sharding as sh
from repro_torch.train import tree
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import make_train_state, make_train_step

#: the JAX package's tests/test_distributed.py step
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SEQ_LEN, BATCH = 32, 8
FAMILY_ARCHS = ("falcon-mamba-7b", "zamba2-1.2b", "mixtral-8x7b",
                "internvl2-1b", "musicgen-large")


def _np(x):
    return sh.full(x).detach().float().numpy().copy()


def f32_reduced(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _batch(cfg):
    return make_batch(for_arch(cfg, seq_len=SEQ_LEN, global_batch=BATCH), 0,
                      device="cpu")


def _wait_for_pickle(path, timeout=120.0):
    """The pickle at ``path`` once another process has written it."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written in {timeout} s")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def _sharded_state(state, cfg, ctx):
    """The state laid out by ``param_specs`` and the gradients' shardings."""
    specs = sh.param_specs(state, cfg.n_experts, ctx)
    return (sh.distribute_tree(state, specs, ctx),
            sh.named_shardings(specs.params, ctx))


# --------------------------------------------------------------- sharding --
def local_shards(rank, arrays, specs):
    """Each array distributed by its spec on (pod=2, data=2, model=2):
    this rank's local shard."""
    from torch.distributed.tensor import distribute_tensor
    mesh = make_host_mesh(pod=2, data=2, model=2)
    return {name: distribute_tensor(
        torch.from_numpy(arr), mesh, sh.placements(sh.P(*specs[name]), mesh),
        src_data_rank=None).to_local().numpy().copy()
        for name, arr in arrays.items()}


def policy_matmul_on_mesh(rank, x, w):
    """A bf16 ``fused`` policy matmul of DTensor operands on (data=2,
    model=2), and the K1 wrapper handed a DTensor."""
    from repro_torch.kernels import fused
    from repro_torch.models.numerics import EmulatedPolicy
    from repro_torch.numerics import get_format
    from repro_torch.numerics.emulate import policy_matmul
    mesh = make_host_mesh(data=2, model=2)
    ctx = sh.make_context(mesh)
    with sh.use_mesh(ctx):
        xd = sh.shard(torch.from_numpy(x), "batch", None, "tensor")
        wd = sh.redistribute(torch.from_numpy(w), mesh, sh.placements(
            sh.spec_for(("fsdp", "tensor"), w.shape), mesh))
        out = policy_matmul(xd, wd, EmulatedPolicy("bf16", "fused"))
        try:
            fused.fused_qmm(xd, wd, fmt=get_format("bf16"))
            refused = ""
        except TypeError as e:
            refused = str(e)
    return {"out": out.to_local().numpy().copy(),
            "placements": [str(p) for p in out.placements],
            "in_placements": [[str(p) for p in t.placements]
                              for t in (xd, wd)],
            "refused": refused}


# ------------------------------------------------------------ train steps --
def train_steps(rank, state_file):
    """For each arch of the pickled JAX initial states: one sharded train
    step on (data=4, model=2), and on rank 0 the unsharded port step."""
    from repro_torch.models.convert import train_state_from_jax
    states = _wait_for_pickle(state_file)
    ctx = sh.make_context(make_host_mesh(data=4, model=2))
    out = {}
    for arch, st_np in states.items():
        cfg = f32_reduced(arch)
        model = LM(cfg, device="cpu")
        opt = AdamWConfig(**OPT)
        batch = _batch(cfg)
        state = train_state_from_jax(st_np, cfg, device="cpu")
        res = {}
        if rank == 0:
            ref, rm = make_train_step(model, opt)(state, batch)
            res["port"] = dict(metrics={k: float(v) for k, v in rm.items()},
                               params=[_np(p) for p in
                                       tree.leaves(ref.params)])
        with sh.use_mesh(ctx):
            sstate, grad_sh = _sharded_state(state, cfg, ctx)
            new, m = make_train_step(model, opt,
                                     grad_shardings=grad_sh)(sstate, batch)
        res["sharded"] = dict(
            metrics={k: float(v) for k, v in m.items()},
            step=int(sh.full(new.step)),
            placements=[str(tuple(p.placements))
                        for p in tree.leaves(new.params)],
            params=[_np(p) for p in tree.leaves(new.params)])
        out[arch] = res
    return out if rank == 0 else None


def family_apply(rank):
    """``LM.apply`` logits of each family's reduced float32 model,
    unsharded and with the params laid out on (data=4, model=2)."""
    ctx = sh.make_context(make_host_mesh(data=4, model=2))
    rng = np.random.default_rng(0)
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = f32_reduced(arch)
        model = LM(cfg, device="cpu")
        params = model.init(0)
        B, S = 4, 16
        kw = {}
        if cfg.frontend == "audio":
            kw["frame_embeds"] = torch.from_numpy(
                rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
            tokens = None
        else:
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                   (B, S)))
        if cfg.frontend == "vision":
            kw["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32))
        plain = model.apply(params, tokens, **kw)[0]
        with sh.use_mesh(ctx):
            dp = sh.distribute_tree(
                params, sh.param_specs(params, cfg.n_experts, ctx), ctx)
            logits = model.apply(dp, tokens, **kw)[0]
        out[arch] = (plain.numpy().copy(), _np(logits))
    return out if rank == 0 else None


def train_and_apply(rank, state_file):
    return train_steps(rank, state_file), family_apply(rank)


# -------------------------------------------------------------------- MoE --
def moe_cases(rank, cases_file):
    """``moe_apply_distributed`` on (data=4, model=2) for each pickled case:
    out, aux, dropped, and the gradients of ``sum(out * r)`` with respect
    to the params and x; the same of ``moe_apply`` unsharded."""
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.moe_sharded import moe_apply_distributed
    cases = _wait_for_pickle(cases_file)
    ctx = sh.make_context(make_host_mesh(data=4, model=2))
    out = []
    for case in cases:
        p = tree.map(lambda a: torch.from_numpy(np.array(a)), case["p"])
        x = torch.from_numpy(case["x"])
        r = torch.from_numpy(case["r"])
        kw = dict(top_k=case["top_k"], capacity_factor=case["cf"])
        res = {}
        for name in ("dist", "local"):
            leaves = [t.clone().requires_grad_(True)
                      for t in tree.leaves(p)]
            xg = x.clone().requires_grad_(True)
            pg = tree.unflatten(p, leaves)
            with sh.use_mesh(ctx if name == "dist" else None), \
                    sh.mesh_region():
                if name == "dist":
                    y, aux = moe_apply_distributed(pg, xg, ctx=ctx, **kw)
                else:
                    y, aux = moe_apply(pg, xg, **kw)
                grads = torch.autograd.grad((y * r).sum(), leaves + [xg])
            res[name] = dict(out=_np(y),
                             aux=float(_np(aux["aux_loss"])),
                             dropped=float(_np(aux["dropped_frac"])),
                             grads=[_np(g) for g in grads])
        out.append(res)
    return out if rank == 0 else None


# --------------------------------------------------------------- pipeline --
def pipeline(rank, ws, x):
    """``pipeline_forward`` of tanh(h @ W_s) over 4 stages on a ('pod',)
    mesh; every rank's output."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.pipeline import pipeline_forward
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    fn = pipeline_forward(lambda w, h: torch.tanh(h @ w), 4, mesh,
                          axis="pod")
    return fn(torch.from_numpy(ws), torch.from_numpy(x)).numpy().copy()


# ------------------------------------------------------------- checkpoint --
def checkpoint_save(rank, directory):
    """{"w": arange(64) as (8, 8)} on (data=4, model=2) by P('data',
    'model'), saved at step 1."""
    from repro_torch.train.checkpoint import CheckpointManager
    ctx = sh.make_context(make_host_mesh(data=4, model=2))
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    t = sh.distribute_tree({"w": w}, {"w": sh.P("data", "model")}, ctx)
    CheckpointManager(directory, keep=2, async_save=False).save(
        1, t, block=True)
    return t["w"].to_local().numpy().copy()


def checkpoint_restore(rank, directory):
    """The checkpoint restored on (data=2, model=2) by P('model', 'data')."""
    from repro_torch.train.checkpoint import CheckpointManager
    mesh = make_host_mesh(data=2, model=2)
    want = sh.NamedSharding(mesh, sh.P("model", "data"))
    restored, _ = CheckpointManager(directory, async_save=False).restore(
        {"w": torch.zeros((8, 8))}, shardings={"w": want})
    w = restored["w"]
    return {"full": _np(w), "local": w.to_local().numpy().copy(),
            "placements": [str(p) for p in w.placements],
            "want": [str(p) for p in want.placements]}


# ------------------------------------------------------------------ cells --
def cells_run(rank):
    """The train and prefill cells of reduced float32 tinyllama (seq_len
    32, batch 8) built by ``make_cell`` on (data=4, model=2), run from
    their shardings, beside the unsharded step and prefill."""
    from repro_torch.launch.specs import make_cell
    ctx = sh.make_context(make_host_mesh(data=4, model=2))
    cfg = f32_reduced("tinyllama-1.1b")
    model = LM(cfg, device="cpu")
    opt = AdamWConfig(**OPT)
    batch = _batch(cfg)

    def place(tree_, shardings):
        return tree.map(lambda t, s: sh.redistribute(t, s.mesh,
                                                     s.placements),
                        tree_, shardings)

    out = {}
    train = make_cell("tinyllama-1.1b", "train_4k", ctx, cfg=cfg,
                      shape=ShapeSpec("train", SEQ_LEN, BATCH, "train"),
                      opt_cfg=opt, device="cpu")
    state = make_train_state(model, 0, opt)
    plain, pm = make_train_step(model, opt)(state, batch)
    with sh.use_mesh(ctx):
        new, m = train.fn(place(state, train.in_shardings[0]),
                          place(batch, train.in_shardings[1]))
    out["train"] = dict(loss=(float(pm["loss"]), float(m["loss"])),
                        params=[(_np(a), _np(b)) for a, b in zip(
                            tree.leaves(plain.params),
                            tree.leaves(new.params))])
    prefill = make_cell("tinyllama-1.1b", "prefill_32k", ctx, cfg=cfg,
                        shape=ShapeSpec("prefill", SEQ_LEN, BATCH,
                                        "prefill"), device="cpu")
    params = state.params
    pb = {"tokens": batch["tokens"]}
    want_logits, want_cache = prefill.fn(params, pb)
    with sh.use_mesh(ctx):
        logits, cache = prefill.fn(place(params, prefill.in_shardings[0]),
                                   place(pb, prefill.in_shardings[1]))
    out["prefill"] = dict(
        logits=(_np(want_logits), _np(logits)),
        k=(_np(want_cache.data["k"]), _np(cache.data["k"])),
        length=(int(want_cache.length), int(sh.full(cache.length))))
    return out if rank == 0 else None
