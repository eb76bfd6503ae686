"""The port's sliding-window ring KV cache (mixtral-8x7b) and the MoE family
(deepseek-moe-16b with its float8 KV cache) against the JAX package's
``LM``.

mixtral's ``reduced()`` config keeps a window of 16: a cache of
``max_len`` >= 16 is a ring of 16 slots, position p at slot p % 16, with no
window mask in decode (the ring is the window).  Prompts of 8, 16 and 40
tokens are prefilled (40 keeps the ring-aligned tail) and decoded across
the wrap; ``prefill_chunked`` with chunks of 5 and 16 reads its history
back across the ring's seam.  deepseek-moe's ``reduced()`` clears its
``kv_cache_dtype``; here it is put back (float8_e4m3fn).  Weights come from
the JAX ``LM.init`` through ``params_from_jax``, tokens from numpy with a
seed.  Tolerances, as ``test_torch_model.py`` holds the dense family:

  * ``policy=None`` (float32): rtol = atol = 1e-4 (float8 caches: the cast
    of values that agree to 1e-6 may land one fp8 step apart, so caches
    are held to 2**-3 * max|cache|, the logits to 1e-4);
  * ``EmulatedPolicy("bf16", "fused")``: |delta| <= 4 * 2**-8 * max|x|;
  * ``prefill_chunked`` against ``prefill`` in the config's own bfloat16:
    bitwise (the JAX package's contract), and against JAX's
    ``prefill_chunked`` at the tolerances above;
  * the MoE's ``aux_loss``: rtol 1e-5.
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
from repro.models.numerics import EmulatedPolicy as JPolicy
from repro_torch.configs.base import get_config
from repro_torch.models import LM
from repro_torch.models.convert import params_from_jax
from repro_torch.models.numerics import EmulatedPolicy
from test_torch_model import pad_lane_chunk

POLICIES = [None, ("bf16", "fused")]
POLICY_IDS = ["native", "bf16-fused"]
FP8 = dict(dtype="float32", kv_cache_dtype="float8_e4m3fn")


@functools.lru_cache(maxsize=None)
def _pair(arch, **kw):
    kw = dict(kw) or dict(dtype="float32")
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = LM(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def _policies(spec):
    if spec is None:
        return None, None
    return JPolicy(*spec), EmulatedPolicy(*spec)


def _close(got, want, spec, what, fp8=False):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, what
    if spec is None and not fp8:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
        return
    share = 2.0 ** -3 if fp8 else 4 * 2.0 ** -8
    bound = share * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (what, bound)


def _close_kv(tdata, jdata, spec, what, fp8=False):
    for name in ("k", "v"):
        _close(tdata[name], jdata[name], spec, f"{what} {name}", fp8)


@pytest.mark.parametrize("spec", POLICIES, ids=POLICY_IDS)
@pytest.mark.parametrize("S", [8, 16, 40])
def test_ring_prefill_and_decode_across_the_wrap(S, spec):
    """The ring holds 16 slots; 12 decode steps wrap it from every
    prompt length."""
    jm, jp, tm, tp = _pair("mixtral-8x7b")
    assert tm.ring and tm.cfg.window == 16
    jpol, tpol = _policies(spec)
    toks = np.random.default_rng(S).integers(0, 256, (2, S))
    jl, ja = jm.apply(jp, jnp.asarray(toks), policy=jpol)
    tl, ta = tm.apply(tp, torch.from_numpy(toks), policy=tpol)
    _close(tl, jl, spec, "apply")
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    jlast, jc = jm.prefill(jp, jnp.asarray(toks), max_len=64, policy=jpol)
    tlast, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=64,
                           policy=tpol)
    assert tc.data["k"].shape[2] == 16
    _close(tlast, jlast, spec, "prefill")
    _close_kv(tc.data, jc.data, spec, "prefill")
    nxt = np.array(jnp.argmax(jlast, -1))[:, None]
    for step in range(12):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), policy=jpol)
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                                  policy=tpol)
        _close(tlog, jlog, spec, f"decode_step {step}")
        nxt = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
    _close_kv(tc.data, jc.data, spec, "decode")


@pytest.mark.parametrize("chunk", [5, 16])
def test_ring_prefill_chunked_matches_jax(chunk):
    """40 tokens in chunks that cross the window edge (16) and the ring's
    seam, against JAX's ``prefill_chunked`` and against ``prefill``."""
    jm, jp, tm, tp = _pair("mixtral-8x7b")
    toks = np.random.default_rng(7).integers(0, 256, (2, 40))
    jl, jc = jm.prefill_chunked(jp, jnp.asarray(toks), chunk, max_len=48)
    tl, tc = tm.prefill_chunked(tp, torch.from_numpy(toks), chunk,
                                max_len=48)
    _close(tl, jl, None, "prefill_chunked")
    _close_kv(tc.data, jc.data, None, "prefill_chunked")
    ml, mc = tm.prefill(tp, torch.from_numpy(toks), max_len=48)
    _close(tl, ml.numpy(), None, "chunked vs monolithic")
    _close_kv(tc.data, {k: v.numpy() for k, v in mc.data.items()}, None,
              "chunked vs monolithic")
    assert tc.length.tolist() == [40, 40]


def test_ring_pad_lane_matches_jax():
    """mixtral's ring of 16 slots with a pad lane (slot id 2 of a 2-lane
    cache, ``test_torch_model.pad_lane_chunk``) in float32 against the JAX
    package, rtol = atol = 1e-4."""
    jm, jp, tm, tp = _pair("mixtral-8x7b")
    pad_lane_chunk(jm, jp, tm, tp,
                   lambda got, want, what: _close(got, want, None, what),
                   max_len=24)
    assert tm.ring


@pytest.mark.parametrize("chunk", [5, 16, 40])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-moe-16b"])
def test_prefill_chunked_is_prefill_bitwise(arch, chunk):
    """In the config's own bfloat16, the JAX package's contract: the last
    logits and the cache (the ring, or the prompt's positions) of
    ``prefill_chunked`` are ``prefill``'s bit for bit, whatever the chunk
    size (40 is the whole prompt in one chunk)."""
    tm = LM(get_config(arch).reduced(), device="cpu")
    tp = tm.init(seed=1)
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, 256,
                                                              (2, 40)))
    last_m, cm = tm.prefill(tp, toks, max_len=48)
    last_c, cc = tm.prefill_chunked(tp, toks, chunk, max_len=48)
    assert torch.equal(last_m, last_c)
    n = cm.data["k"].shape[2] if tm.ring else 40
    for name in ("k", "v"):
        assert torch.equal(cm.data[name][:, :, :n], cc.data[name][:, :, :n])


def test_ring_decode_scan_keeps_inactive_lanes():
    """A ring write is not masked by length: an inactive lane's ring keeps
    its bits while the active lanes wrap."""
    jm, jp, tm, tp = _pair("mixtral-8x7b")
    toks = np.random.default_rng(9).integers(0, 256, (3, 14))
    _, jc = jm.prefill(jp, jnp.asarray(toks), max_len=32)
    _, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=32)
    jc = type(jc)(jc.data, jnp.full((3,), 14, jnp.int32))
    tc = tm.cache_at_length(tc, [14, 14, 14])
    held = {k: v[:, 1].clone() for k, v in tc.data.items()}
    tok = np.array([[5], [7], [9]])
    active = np.array([True, False, True])
    budget = np.array([6, 6, 6])
    jout = jm.decode_scan(jp, jc, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(active), jnp.asarray(budget, jnp.int32),
                          6)
    tout = tm.decode_scan(tp, tc, torch.from_numpy(tok),
                          torch.from_numpy(active), torch.from_numpy(budget),
                          6)
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    np.testing.assert_array_equal(tout[0].length.numpy(),
                                  np.asarray(jout[0].length))
    _close_kv(tout[0].data, jout[0].data, None, "decode_scan")
    for k, v in held.items():
        assert torch.equal(tout[0].data[k][:, 1], v), k


# ------------------------------------------- deepseek-moe, fp8 cache back
@pytest.mark.parametrize("spec", POLICIES, ids=POLICY_IDS)
def test_moe_fp8_cache_every_path(spec):
    """``apply``, ``prefill`` + three ``decode_step``s, the bucket-padded
    ``prefill_batched``, ``prefill_chunked`` and ``decode_scan`` of the
    reduced deepseek-moe with its float8_e4m3fn cache."""
    jm, jp, tm, tp = _pair("deepseek-moe-16b", **FP8)
    assert tm.cache_dtype == torch.float8_e4m3fn
    jpol, tpol = _policies(spec)
    toks = np.random.default_rng(10).integers(0, 256, (2, 12))
    jl, ja = jm.apply(jp, jnp.asarray(toks), policy=jpol)
    tl, ta = tm.apply(tp, torch.from_numpy(toks), policy=tpol)
    _close(tl, jl, spec, "apply")
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    jlast, jc = jm.prefill(jp, jnp.asarray(toks), max_len=20, policy=jpol)
    tlast, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=20,
                           policy=tpol)
    _close(tlast, jlast, spec, "prefill")
    _close_kv(tc.data, jc.data, spec, "prefill", fp8=True)
    nxt = np.array(jnp.argmax(jlast, -1))[:, None]
    for step in range(3):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), policy=jpol)
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                                  policy=tpol)
        _close(tlog, jlog, spec, f"decode_step {step}")
        nxt = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
    lens = np.array([9, 12])
    padded = np.where(np.arange(12)[None] < lens[:, None], toks, 0)
    jb, jkv, _ = jm.prefill_batched(jp, jnp.asarray(padded),
                                    jnp.asarray(lens), policy=jpol)
    tb, tkv, _ = tm.prefill_batched(tp, torch.from_numpy(padded),
                                    torch.from_numpy(lens), policy=tpol)
    _close(tb, jb, spec, "prefill_batched")
    for got, want in zip(tkv, jkv):
        _close(got, want, spec, "prefill_batched kv", fp8=True)
    jl, jc = jm.prefill_chunked(jp, jnp.asarray(toks), 5, max_len=20,
                                policy=jpol)
    tl, tc = tm.prefill_chunked(tp, torch.from_numpy(toks), 5, max_len=20,
                                policy=tpol)
    _close(tl, jl, spec, "prefill_chunked")
    _close_kv(tc.data, jc.data, spec, "prefill_chunked", fp8=True)
    tok = np.array(jnp.argmax(jl, -1))[:, None]
    active, budget = np.array([True, False]), np.array([4, 4])
    jout = jm.decode_scan(jp, jc, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(active), jnp.asarray(budget, jnp.int32),
                          4, policy=jpol)
    tout = tm.decode_scan(tp, tc, torch.from_numpy(tok),
                          torch.from_numpy(active), torch.from_numpy(budget),
                          4, policy=tpol)
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    _close_kv(tout[0].data, jout[0].data, spec, "decode_scan", fp8=True)


@pytest.mark.parametrize("cf", [0.5, 64.0])
def test_moe_stats_per_layer(cf):
    """``apply(moe_stats=True)``: the summed ``aux_loss`` equal to plain
    ``apply``'s and within rtol 1e-5 of JAX's, and one dropped share per
    layer, each in [0, 1]: all zero at ``capacity_factor = n_experts``
    (nothing can drop), some above zero at 0.5."""
    jm, jp, tm, tp = _pair("deepseek-moe-16b", **FP8)
    jm = JLM(dataclasses.replace(jm.cfg, capacity_factor=cf))
    tm = LM(dataclasses.replace(tm.cfg, capacity_factor=cf), device="cpu")
    toks = np.random.default_rng(11).integers(0, 256, (2, 12))
    _, ja = jm.apply(jp, jnp.asarray(toks))
    tl, ta = tm.apply(tp, torch.from_numpy(toks))
    sl, stats = tm.apply(tp, torch.from_numpy(toks), moe_stats=True)
    assert torch.equal(sl, tl)
    assert float(stats["aux_loss"]) == float(ta)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    d = stats["dropped_frac"]
    assert d.shape == (tm.cfg.n_layers,) and d.dtype == torch.float32
    assert bool(((d >= 0) & (d <= 1)).all())
    assert bool((d == 0).all()) if cf == 64.0 else bool((d > 0).any())
