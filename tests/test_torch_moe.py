"""The port's MoE layer against the JAX package's ``repro.models.moe``.

Parameters are layer 0's ``moe`` subtree of a JAX ``LM.init`` of the
reduced mixtral-8x7b (4 routed experts, top-2, no shared) and
deepseek-moe-16b (4 routed, top-2, 2 shared experts), loaded with
``params_from_jax``; the activations are drawn with numpy from a seed.
Each case runs at ``capacity_factor`` 1.25 with a router that sends every
token to one expert first (so entries drop) and at 8.0 (nothing drops).

Tolerances:
  * routing: the picks, the keep mask, the dispatch slots, the tokens and
    the capacity identical to the reference's own steps (``moe.py:67-93``,
    replayed with ``jnp``); ``dropped_frac`` equal (a count over T*k);
    ``aux_loss`` within rtol 1e-6 (float32 means in another order);
  * output: float32 within 4e-6 * max|out| (the products' summation
    order), bfloat16 within 2**-7 * max|out| (one bf16 ulp at the largest
    output);
  * the combine: bitwise equal to XLA:CPU's ``zeros.at[tok].add(y)`` in
    bfloat16, which adds a token's k entries one rounded add at a time in
    dispatch-sort order (ascending expert id);
  * planted exact ties (an exactly computed router whose columns 0 and 1
    are equal): the picks go to the lower expert index, as ``lax.top_k``
    breaks them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import LM as JLM
from repro.models import moe as jmoe
from repro_torch.configs.base import get_config
from repro_torch.models import moe
from repro_torch.models.convert import _to_tensor, params_from_jax
from repro_torch.models.model import _layer

ARCHS = ["mixtral-8x7b", "deepseek-moe-16b"]


@functools.lru_cache(maxsize=None)
def _layer0(arch, dtype):
    """Layer 0's MoE parameters: (the JAX tree, the port's, the config)."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    jp = JLM(jcfg).init(jax.random.PRNGKey(7))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return (jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            _layer(tp["layers"], 0)["moe"], cfg)


def _skewed(jp, tp):
    """Both trees with a router column 0 that puts expert 0 first for
    every token of positive activations."""
    r = np.array(jp["router"])
    r[:, 0] = 0.05
    return ({**jp, "router": jnp.asarray(r)},
            {**tp, "router": torch.from_numpy(r)})


def _jax_routing(p, xf, top_k, capacity_factor):
    """The reference's routing steps (``moe.py:67-93``) in ``jnp``."""
    T = xf.shape[0]
    E = p["router"].shape[1]
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    top_w, top_i = jax.lax.top_k(probs, top_k)
    cap = int(capacity_factor * T * top_k / E)
    cap = max(cap, 4)
    if cap >= 128:
        cap = ((cap + 127) // 128) * 128
    cap = min(cap, T * top_k)
    e_flat = top_i.reshape(-1)
    order = jnp.argsort(e_flat)
    e_sorted = e_flat[order]
    starts = jnp.searchsorted(e_sorted, jnp.arange(E), side="left")
    pos = jnp.arange(T * top_k) - starts[e_sorted]
    keep = pos < cap
    slot = e_sorted * cap + jnp.clip(pos, 0, cap - 1)
    tok = (jnp.arange(T * top_k) // top_k)[order]
    return dict(top_i=top_i, cap=cap, order=order, keep=keep, slot=slot,
                tok=tok, probs=probs)


def _activations(cfg, shape, seed, dtype):
    x = np.abs(np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,))).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    return jx, _to_tensor(np.asarray(jx), getattr(torch, dtype), "cpu")


def _check_routing(tr, want):
    np.testing.assert_array_equal(tr.top_i.numpy(), np.asarray(want["top_i"]))
    assert tr.cap == want["cap"]
    for name in ("order", "keep", "slot", "tok"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, cf, dtype):
    jp, tp, cfg = _layer0(arch, dtype)
    if cf == 1.25:
        jp, tp = _skewed(jp, tp)
    k = cfg.experts_per_token
    jx, tx = _activations(cfg, (2, 24), 0, dtype)
    jout, jaux = jmoe.moe_apply(jp, jx, top_k=k, capacity_factor=cf)
    tout, taux = moe.moe_apply(tp, tx, top_k=k, capacity_factor=cf)
    want = _jax_routing(jp, jx.reshape(-1, cfg.d_model), k, cf)
    _check_routing(moe.route(tp["router"], tx.reshape(-1, cfg.d_model),
                             top_k=k, capacity_factor=cf), want)
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    assert (float(taux["dropped_frac"]) > 0) == (cf == 1.25)
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=1e-6)
    got = tout.float().numpy()
    ref = np.asarray(jout.astype(jnp.float32))
    share = 4e-6 if dtype == "float32" else 2.0 ** -7
    assert np.abs(got - ref).max() <= share * np.abs(ref).max()
    assert ("shared" in tp) == (arch == "deepseek-moe-16b")


@pytest.mark.parametrize("T", [4, 48, 256])
def test_capacity_and_dispatch_match_jax(T):
    """The capacity formula at the floor of 4 (T = 4), below 128 and
    rounded up to a multiple of 128 (T = 256: 1.25 * 256 * 2 / 4 = 160 ->
    256); every dispatch slot of every kept entry distinct."""
    jp, tp, cfg = _layer0("deepseek-moe-16b", "float32")
    jx, tx = _activations(cfg, (1, T), 1, "float32")
    xf = tx.reshape(T, -1)
    want = _jax_routing(jp, jx.reshape(T, -1), 2, 1.25)
    r = moe.route(tp["router"], xf, top_k=2, capacity_factor=1.25)
    _check_routing(r, want)
    assert r.cap == {4: 4, 48: 30, 256: 256}[T]
    kept = r.slot[r.keep]
    assert kept.unique().numel() == kept.numel()


def test_planted_ties_pick_the_lower_expert():
    """An exactly computed router (multiples of 1/16 on activations in
    multiples of 1/8, so every logit is exact in any summation order) with
    columns 0 and 1 equal: the two experts tie exactly for every token,
    and both packages list expert 0 before expert 1."""
    jp, tp, cfg = _layer0("mixtral-8x7b", "float32")
    rng = np.random.default_rng(2)
    r = (rng.integers(-2, 3, (cfg.d_model, cfg.n_experts)) / 16.0)
    r[:, 1] = r[:, 0]
    r = r.astype(np.float32)
    x = (rng.integers(-4, 5, (2, 16, cfg.d_model)) / 8.0).astype(np.float32)
    jp = {**jp, "router": jnp.asarray(r)}
    tp = {**tp, "router": torch.from_numpy(r)}
    want = _jax_routing(jp, jnp.asarray(x.reshape(32, -1)), 2, 8.0)
    probs = np.asarray(want["probs"])
    assert (probs[:, 0] == probs[:, 1]).all()
    tr = moe.route(tp["router"], torch.from_numpy(x.reshape(32, -1)),
                   top_k=2, capacity_factor=8.0)
    _check_routing(tr, want)
    top = tr.top_i.numpy()
    tied = (top == 0).any(-1) & (top == 1).any(-1)
    assert tied.any()  # some tokens pick both tied experts ...
    assert (top[tied] == [0, 1]).all()  # ... lower index first
    only_one = ((top == 0) | (top == 1)).sum(-1) == 1
    assert (top[only_one] != 1).all()  # a single pick of the pair is 0
    jout, _ = jmoe.moe_apply(jp, jnp.asarray(x), top_k=2, capacity_factor=8.0)
    tout, _ = moe.moe_apply(tp, torch.from_numpy(x), top_k=2,
                            capacity_factor=8.0)
    ref = np.asarray(jout)
    assert np.abs(tout.numpy() - ref).max() <= 4e-6 * np.abs(ref).max()


def test_combine_order_is_xla_cpus():
    """Top-3 routing (with two picks, a + b is the same either way) and
    y_slot entries spread over 2**-12 .. 2**4 in bfloat16, where the order
    of the rounded adds shows: the port's combine equals XLA:CPU's
    scatter-add bit for bit, and the reversed order does not."""
    jp, tp, cfg = _layer0("deepseek-moe-16b", "bfloat16")
    T = 64
    _, tx = _activations(cfg, (1, T), 3, "bfloat16")
    r = moe.route(tp["router"], tx.reshape(T, -1), top_k=3,
                  capacity_factor=8.0)
    rng = np.random.default_rng(4)
    y = (rng.standard_normal((3 * T, 8))
         * np.exp2(rng.integers(-12, 5, (3 * T, 8)))).astype(np.float32)
    ty = torch.from_numpy(y).to(torch.bfloat16)
    jy = jnp.asarray(y).astype(jnp.bfloat16)
    want = jnp.zeros((T, 8), jnp.bfloat16).at[jnp.asarray(r.tok.numpy())] \
        .add(jy)
    want = np.asarray(want.astype(jnp.float32))
    got = moe.combine(ty, r, T).float().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    flipped = r._replace(order=r.order.flip(0))
    other = moe.combine(ty.flip(0), flipped, T).float().numpy()
    assert (other != want).any()  # the control: order matters here
