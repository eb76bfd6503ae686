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


# ------------------------------------------------------ decode on a mesh --
#: (arch, config overrides, batch): the dense family with its kv heads
#: sharded over 'model' and with its head dim sharded (one kv head), the
#: ring cache, ssm, hybrid, and a B = 1 cache sharded along the sequence
DECODE_CASES = {
    "dense": ("tinyllama-1.1b", {"n_kv_heads": 2}, 4),
    "dense_head_dim": ("tinyllama-1.1b", {}, 4),
    "ring": ("mixtral-8x7b", {}, 4),
    "ssm": ("falcon-mamba-7b", {}, 4),
    "hybrid": ("zamba2-1.2b", {"n_layers": 5}, 4),
    "sequence": ("tinyllama-1.1b", {"n_kv_heads": 2}, 1),
}
DECODE_STEPS, PROMPT, MAX_LEN = 8, 12, 32
#: chunked prefill: a prompt of CHUNK_PROMPT tokens in chunks of CHUNKS
#: (the second reads the first's KV back and crosses the ring's seam at
#: 16), then one chunk of PAD_CHUNK tokens over the first lanes and a pad
#: lane; ``prefill_chunked`` in chunks of CHUNKED
CHUNK_PROMPT, CHUNKS, PAD_CHUNK, CHUNKED = 20, (12, 8), 4, 10
#: the case held against the JAX package's own ``prefill_chunk``
JAX_CHUNK_CASE = "dense"


def chunk_steps(B, vocab, seed):
    """The prompt and the ``prefill_chunk`` calls (tokens, offsets,
    chunk_lens, slot_ids) of a B-lane cache, numpy from ``seed``: CHUNKS
    over every lane, then a chunk over lanes 0 and 1 (lane 0 alone when
    B = 1), which continue, and a pad lane with slot id B."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, vocab, (B, CHUNK_PROMPT))
    steps, off = [], 0
    for n in CHUNKS:
        steps.append((prompt[:, off:off + n], np.full(B, off), np.full(B, n),
                      np.arange(B)))
        off += n
    slots = np.array(list(range(min(B, 2))) + [B])
    steps.append((rng.integers(0, vocab, (len(slots), PAD_CHUNK)),
                  np.where(slots < B, off, 0), np.full(len(slots), PAD_CHUNK),
                  slots))
    return prompt, steps


def _run_chunks(model, params, cache, steps):
    """The chunks' real-lane logits and the cache after the last."""
    logits = []
    for step in steps:
        last, cache = model.prefill_chunk(
            params, cache, *(torch.from_numpy(a) for a in step))
        logits.append(_np(last)[step[3] < cache.length.shape[0]])
    return logits, cache


def _caches(want, got):
    return {k: (v.float().numpy().copy(), _np(got.data[k]))
            for k, v in want.data.items()}


def _placements(cache):
    return {k: [str(p) for p in v.placements] for k, v in cache.data.items()}


def _chunk_case(model, params, dp, B, ctx, seed):
    """``prefill_chunk`` over ``chunk_steps`` and ``prefill_chunked``,
    unsharded and on the mesh (params ``dp``, the cache laid out by
    ``launch.specs``)."""
    from repro_torch.launch.specs import _cache_specs
    from repro_torch.models.model import DecodeCache
    prompt, steps = chunk_steps(B, model.cfg.vocab_size, seed)
    prompt = torch.from_numpy(prompt)
    base = model.init_cache(B, MAX_LEN)
    fresh = DecodeCache(base.data, torch.zeros(B, dtype=torch.int64))
    want, wc = _run_chunks(model, params, tree.map(torch.clone, fresh), steps)
    wl, wcc = model.prefill_chunked(params, prompt, CHUNKED, max_len=MAX_LEN)
    with sh.use_mesh(ctx):
        specs = _cache_specs(model, fresh, B, ctx)
        dc = tree.map(lambda t, s: sh.redistribute(t, s.mesh, s.placements),
                      fresh, specs)
        got, gc = _run_chunks(model, dp, dc, steps)
        gl, gcc = model.prefill_chunked(dp, prompt, CHUNKED, max_len=MAX_LEN)
        laid_out = _placements(dc)
    return dict(
        logits=list(zip(want, got)), cache=_caches(wc, gc),
        length=(wc.length.tolist(), sh.full(gc.length).tolist()),
        placements=(laid_out, _placements(gc)),
        chunked=dict(logits=(_np(wl), _np(gl)), cache=_caches(wcc, gcc),
                     length=(wcc.length.tolist(),
                             sh.full(gcc.length).tolist()),
                     placements=(laid_out, _placements(gcc))))


def mesh_decode(rank, jax_params):
    """For each of ``DECODE_CASES``: a prefill, then ``DECODE_STEPS``
    decode steps unsharded and with the params and the cache laid out on
    (data=4, model=2) as ``launch.specs`` lays them out; each step's
    logits and the final caches of both; then ``_chunk_case``.  Last,
    ``JAX_CHUNK_CASE``'s chunks on the mesh from the JAX package's
    parameters, pickled at ``jax_params`` (out["jax_chunks"])."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.specs import _cache_specs
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import DecodeCache
    ctx = sh.make_context(make_host_mesh(data=4, model=2))
    out = {}
    for name, (arch, over, B) in DECODE_CASES.items():
        cfg = dataclasses.replace(f32_reduced(arch), **over)
        model = LM(cfg, device="cpu")
        params = model.init(0)
        rng = np.random.default_rng(1)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (B, PROMPT)))
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (DECODE_STEPS, B, 1)))
        _, cache = model.prefill(params, prompt, max_len=MAX_LEN)
        start = tree.map(torch.clone, cache)
        want = []
        for t in toks:
            logits, cache = model.decode_step(params, cache, t)
            want.append(logits.numpy().copy())
        with sh.use_mesh(ctx):
            dp = sh.distribute_tree(
                params, sh.param_specs(params, cfg.n_experts, ctx), ctx)
            specs = _cache_specs(model, start, B, ctx)
            dc = tree.map(lambda t, s: distribute_tensor(
                t, s.mesh, s.placements, src_data_rank=None), start, specs)
            got = []
            for t in toks:
                logits, dc = model.decode_step(dp, dc, t)
                got.append(_np(logits))
            placements = _placements(dc)
        assert isinstance(dc, DecodeCache)
        out[name] = dict(
            logits=(np.stack(want), np.stack(got)),
            cache={k: (v.float().numpy().copy(), _np(dc.data[k]))
                   for k, v in cache.data.items()},
            length=(int(cache.length), int(sh.full(dc.length))),
            placements=placements,
            chunks=_chunk_case(model, params, dp, B, ctx, seed=2))
    arch, over, B = DECODE_CASES[JAX_CHUNK_CASE]
    cfg = dataclasses.replace(f32_reduced(arch), **over)
    model = LM(cfg, device="cpu")
    params = params_from_jax(_wait_for_pickle(jax_params), cfg, device="cpu")
    _, steps = chunk_steps(B, cfg.vocab_size, seed=3)
    base = model.init_cache(B, MAX_LEN)
    with sh.use_mesh(ctx):
        dp = sh.distribute_tree(
            params, sh.param_specs(params, cfg.n_experts, ctx), ctx)
        fresh = DecodeCache(base.data, torch.zeros(B, dtype=torch.int64))
        dc = tree.map(lambda t, s: sh.redistribute(t, s.mesh, s.placements),
                      fresh, _cache_specs(model, fresh, B, ctx))
        logits, dc = _run_chunks(model, dp, dc, steps)
    out["jax_chunks"] = dict(logits=logits,
                             cache={k: _np(v) for k, v in dc.data.items()},
                             length=sh.full(dc.length).tolist())
    return out if rank == 0 else None


# ------------------------------------------------------- uneven heads --
#: reduced tinyllama with 2 kv heads, which a 'model' axis of 4 does not
#: divide
UNEVEN = dict(n_kv_heads=2)


def uneven_heads(rank, state_file):
    """Reduced float32 tinyllama with ``UNEVEN`` kv heads from the pickled
    JAX initial state, on (data=2, model=4): ``LM.apply``'s logits and one
    train step, unsharded and sharded."""
    from repro_torch.models.convert import train_state_from_jax
    st_np = _wait_for_pickle(state_file)
    ctx = sh.make_context(make_host_mesh(data=2, model=4))
    cfg = dataclasses.replace(f32_reduced("tinyllama-1.1b"), **UNEVEN)
    model = LM(cfg, device="cpu")
    opt = AdamWConfig(**OPT)
    batch = _batch(cfg)
    state = train_state_from_jax(st_np, cfg, device="cpu")
    plain_logits = model.apply(state.params, batch["tokens"])[0]
    ref, rm = make_train_step(model, opt)(state, batch)
    with sh.use_mesh(ctx):
        sstate, grad_sh = _sharded_state(state, cfg, ctx)
        logits = model.apply(sstate.params, batch["tokens"])[0]
        new, m = make_train_step(model, opt,
                                 grad_shardings=grad_sh)(sstate, batch)
    out = dict(
        logits=(plain_logits.numpy().copy(), _np(logits)),
        port=dict(metrics={k: float(v) for k, v in rm.items()},
                  params=[_np(p) for p in tree.leaves(ref.params)]),
        sharded=dict(metrics={k: float(v) for k, v in m.items()},
                     params=[_np(p) for p in tree.leaves(new.params)]))
    return out if rank == 0 else None


# ------------------------------------------------------------ fake worlds --
# Bodies run in a spawned process of their own, made rank 0 of a fake world
# (``launch.mesh.fake_world``): they count, and no collective moves data.
def fake_scan_loop(device):
    """The 7-step loop of the JAX package's
    ``test_scan_flops_and_collectives_exact`` on a fake (data=2, model=2)
    mesh: ``c = c @ w`` with w (2048, 2048) sharded ``P(None, 'model')``,
    c starting as x (256, 2048) ``P('data', None)`` and constrained to
    ``P('data', 'model')`` after each product, counted on ``device``
    stand-ins (a "cpu" mesh, so that cpu tensors may be placed)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import fake_world
    from repro_torch.roofline.op_cost import count
    fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    w = DTensor.from_local(torch.zeros((2048, 1024), device=device), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    x = DTensor.from_local(torch.zeros((128, 2048), device=device), mesh,
                           [Shard(0), Replicate()], run_check=False)

    def f(w, x):
        c = x
        for _ in range(7):
            c = (c @ w).redistribute(mesh, [Shard(0), Shard(1)])
        return c.sum()

    # and one elementwise op on the sharded w, counted at its local shape
    return (dataclasses.asdict(count(f, w, x)[1]),
            dataclasses.asdict(count(torch.mul, w, 2.0)[1]))


def fake_collectives():
    """Each collective the port issues, once, on 8 x 4 float32 (128 bytes)
    in a fake world of 4: the functional ones DTensor calls (each waited)
    and the ``torch.distributed`` ones (c10d) the MoE and the pipeline
    call."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from repro_torch.launch.mesh import fake_world
    from repro_torch.roofline.op_cost import count
    fake_world(4)
    x = torch.ones(8, 4)
    world = dist.group.WORLD

    def functional():
        for t in (funcol.all_reduce(x, "sum", world),
                  funcol.all_gather_tensor(x, 0, world),
                  funcol.reduce_scatter_tensor(x, "sum", 0, world),
                  funcol.all_to_all_single(x, None, None, world)):
            funcol.wait_tensor(t)

    def c10d():
        dist.all_reduce(x.clone())
        dist.all_gather_into_tensor(torch.empty(32, 4), x)
        dist.reduce_scatter_tensor(torch.empty(2, 4), x)
        dist.all_to_all_single(torch.empty(8, 4), x)
        recv = torch.empty(8, 4)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1),
                                           dist.P2POp(dist.irecv, recv, 3)]):
            req.wait()

    def waits():
        t = funcol.all_reduce(x, "sum", world)
        for _ in range(3):
            t = funcol.wait_tensor(t)

    return {name: dataclasses.asdict(count(fn)[1]) for name, fn in
            (("functional", functional), ("c10d", c10d), ("waits", waits))}


def fake_cell_counts(cells, data, model, device="meta", mesh_type="cuda"):
    """``launch.dryrun.count_cell`` of each (arch, kind, overrides, seq,
    batch) cell of reduced configs on a fake (data, model) mesh of
    ``mesh_type``: {key: OpCost as a dict}.  With ``device="cpu"`` the
    cell's arguments are placed from zero-filled cpu tensors instead of
    meta stand-ins."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    fake_world(data * model)
    mesh = init_device_mesh(mesh_type, (data, model),
                            mesh_dim_names=("data", "model"))
    out = {}
    for key, (arch, kind, over, seq, batch) in cells.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        _, cost, _, _, _ = dryrun.count_cell(
            arch, kind, mesh, cfg=cfg, shape=ShapeSpec(kind, seq, batch, kind),
            device=device)
        out[key] = dataclasses.asdict(cost)
    return out


def fake_depth_extrapolation(cells, data, model):
    """For each cell of reduced configs on a fake (data, model) mesh: the
    count at full depth, and the one ``launch.dryrun`` extrapolates from
    two reduced depths (``dryrun.depths(cfg, dryrun.DEPTH)``), as dicts,
    with those depths."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    fake_world(data * model)
    mesh = init_device_mesh("cuda", (data, model),
                            mesh_dim_names=("data", "model"))
    out = {}
    for key, (arch, kind, over, seq, batch) in cells.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        shape = ShapeSpec(kind, seq, batch, kind)

        def at(n):
            return dryrun.count_cell(
                arch, kind, mesh, cfg=dataclasses.replace(cfg, n_layers=n),
                shape=shape)[1]

        ds = dryrun.depths(cfg, dryrun.DEPTH)
        ext = dryrun._extrapolate([(d, at(d)) for d in ds], cfg.n_layers)
        full = at(cfg.n_layers)
        out[key] = dict(depths=list(ds), full=dataclasses.asdict(full),
                        extrapolated=dataclasses.asdict(ext))
    return out


def fake_dryrun_rows(cells, tech, data=2, model=4):
    """``launch.dryrun.run_cell``'s row of each (arch, kind, overrides, seq,
    batch) cell of reduced configs on a fake (data, model) mesh, the chip
    policy on the cpu from ``tech`` (``TechParams.values``); and one
    ``launch.hillclimb.measure`` row, of the first cell at 2
    microbatches."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.energy_model import TechParams
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.mesh import fake_world
    fake_world(data * model)
    tech = TechParams(tuple(tech))
    mesh = make_host_mesh(data=data, model=model)
    rows, first = {}, None
    for key, (arch, kind, over, seq, batch) in cells.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        shape = ShapeSpec(kind, seq, batch, kind)
        rows[key] = dryrun.run_cell(arch, kind, mesh=mesh, cfg=cfg,
                                    shape=shape, microbatches=1, depth=0,
                                    device="cpu", tech=tech, verbose=False)
        first = first or (arch, kind, cfg, shape)
    arch, kind, cfg, shape = first
    climb = hillclimb.measure(arch, kind, microbatches=2, label="mb2",
                              hypothesis="two microbatches", depth=0,
                              device="cpu", tech=tech, mesh=mesh, cfg=cfg,
                              shape_spec=shape)
    return rows, climb


def fake_production_rows(n_ranks, cells, tech):
    """``launch.dryrun.run_cell``'s row of each (arch, shape, n_layers)
    production cell at full width, counted at ``n_layers`` (0: the
    config's), on the production mesh of a fake world of ``n_ranks``, the
    chip policy on the cpu from ``tech`` (``TechParams.values``)."""
    from repro_torch.core.energy_model import TechParams
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    fake_world(n_ranks)
    tech = TechParams(tuple(tech))
    out = {}
    for arch, shape, layers in cells:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        out[f"{arch}|{shape}"] = dryrun.run_cell(
            arch, shape, multi_pod=n_ranks == 512, cfg=cfg, depth=0,
            device="cpu", tech=tech, verbose=False)
    return out
