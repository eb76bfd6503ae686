"""The port's hybrid family (zamba2-1.2b) against the JAX package's ``LM``.

zamba2's ``reduced()`` config has 2 layers and applies the shared block
after every 2, which hides the trailing segment; here it has 5 layers
(``n_layers=5``, ``shared_attn_every=2``): two shared applications (after
layers 1 and 3) and a trailing 1-layer segment with none.  Its scan chunk
is 4 (``ssm_scan_chunk=4``) so that chunked prefills of a few tokens cross
real resume points, as the JAX package's own chunked tests do.  Weights
come from the JAX ``LM.init`` through ``params_from_jax``; token ids are
drawn with numpy from a seed.  Tolerances, as ``test_torch_model.py``
holds the dense and ssm families:

  * ``policy=None`` (float32): rtol = atol = 1e-4;
  * ``EmulatedPolicy("bf16", "fused")``: |delta| <= 4 * 2**-8 * max|x|;
  * the decode states after a prefill under the policy: rtol = atol = 1e-4,
    since both packages take them from a second forward whose shared
    blocks run with no policy (the JAX ``_prefill_ssm_states``); the
    states of the emulated pass itself lie further from them than that;
  * ``prefill_chunked`` against ``prefill`` in the config's own bfloat16:
    bitwise, the JAX package's contract for chunk boundaries on multiples
    of ``ssm_scan_chunk``.
"""
import dataclasses

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

HYBRID = dict(n_layers=5, shared_attn_every=2, ssm_scan_chunk=4)
POLICIES = [None, ("bf16", "fused")]
POLICY_IDS = ["native", "bf16-fused"]


def _cfgs(**kw):
    return (dataclasses.replace(jget_config("zamba2-1.2b").reduced(),
                                **HYBRID, **kw),
            dataclasses.replace(get_config("zamba2-1.2b").reduced(),
                                **HYBRID, **kw))


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = _cfgs(dtype="float32")
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def _policies(spec):
    if spec is None:
        return None, None
    return JPolicy(*spec), EmulatedPolicy(*spec)


def _close(got, want, spec, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if spec is None:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        bound = 4 * 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want).max() <= bound, (what, bound)


def _close_cache(tdata, jdata, spec, what):
    assert sorted(tdata) == sorted(jdata)
    for name in jdata:
        _close(tdata[name], jdata[name], spec, f"{what} {name}")


def test_segments_match_jax(pair):
    jm, _, tm, tp = pair
    assert tm._segments() == jm._segments() == [(0, 2, True), (2, 4, True),
                                                 (4, 5, False)]
    assert tm.n_shared_applications == jm.n_shared_applications == 2
    assert tm.init_cache(3, 16).data["k"].shape == (2, 3, 16, 4, 16)
    assert "shared_attn" in tp and "mlp" in tp["shared_attn"]


@pytest.mark.parametrize("spec", POLICIES, ids=POLICY_IDS)
def test_hybrid_matches_jax(pair, spec):
    """``apply``, ``prefill`` (logits, conv, h and the shared KV), three
    ``decode_step``s and the exact-length ``prefill_batched``."""
    jm, jp, tm, tp = pair
    jpol, tpol = _policies(spec)
    toks = np.random.default_rng(0).integers(0, 256, (2, 19))
    jl, ja = jm.apply(jp, jnp.asarray(toks), policy=jpol)
    tl, ta = tm.apply(tp, torch.from_numpy(toks), policy=tpol)
    _close(tl, jl, spec, "apply")
    assert float(ja) == ta == 0.0

    jlast, jc = jm.prefill(jp, jnp.asarray(toks), max_len=24, policy=jpol)
    tlast, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=24,
                           policy=tpol)
    _close(tlast, jlast, spec, "prefill")
    _close_cache(tc.data, jc.data, spec, "prefill")
    nxt = np.array(jnp.argmax(jlast, -1))[:, None]
    for step in range(3):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), policy=jpol)
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                                  policy=tpol)
        _close(tlog, jlog, spec, f"decode_step {step}")
        nxt = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
    _close_cache(tc.data, jc.data, spec, "decode")
    assert int(tc.length) == int(jc.length) == 22

    lens = np.array([19, 19])
    jb, jkv, jst = jm.prefill_batched(jp, jnp.asarray(toks),
                                      jnp.asarray(lens), policy=jpol)
    tb, tkv, tst = tm.prefill_batched(tp, torch.from_numpy(toks),
                                      torch.from_numpy(lens), policy=tpol)
    _close(tb, jb, spec, "prefill_batched")
    for got, want, name in zip(tkv + tst, jkv + jst, ("k", "v", "conv",
                                                      "h")):
        _close(got, want, spec, f"prefill_batched {name}")


def test_decode_states_come_from_a_native_pass(pair):
    """Under ``EmulatedPolicy`` the states after a prefill are the JAX
    package's at the native tolerance, and the emulated pass's own states
    are not (the control)."""
    jm, jp, tm, tp = pair
    jpol, tpol = _policies(("bf16", "fused"))
    toks = np.random.default_rng(1).integers(0, 256, (2, 12))
    _, jc = jm.prefill(jp, jnp.asarray(toks), policy=jpol)
    _, tc = tm.prefill(tp, torch.from_numpy(toks), policy=tpol)
    _, _, _, (conv, h) = tm.apply(tp, torch.from_numpy(toks), policy=tpol,
                                  collect_kv=True, collect_states=True)
    for name, own in (("conv", conv), ("h", h)):
        _close(tc.data[name], jc.data[name], None, name)
        with pytest.raises(AssertionError):
            _close(own, jc.data[name], None, f"emulated pass {name}")


@pytest.mark.parametrize("spec", POLICIES, ids=POLICY_IDS)
def test_hybrid_prefill_chunk_matches_jax(pair, spec):
    """Lanes 2 and 0 of a three-slot cache, prefilled in chunks of 8, 8
    and 4 (boundaries on the scan chunk of 4); slot 2 held another
    request's state, which a fresh lane must not inherit."""
    jm, jp, tm, tp = pair
    jpol, tpol = _policies(spec)
    toks = np.random.default_rng(3).integers(0, 256, (2, 20))
    slots = np.array([2, 0])
    jc = jm.init_cache(3, 24)
    jc = type(jc)({k: v.at[:, 2].set(1.0) for k, v in jc.data.items()},
                  jnp.zeros(3, jnp.int32))
    tc = tm.init_cache(3, 24)
    for v in tc.data.values():
        v[:, 2] = 1.0
    tc = tm.cache_at_length(tc, [0, 0, 0])
    for off, n in ((0, 8), (8, 8), (16, 4)):
        args = (np.full(2, off), np.full(2, n), slots)
        jlast, jc = jm.prefill_chunk(
            jp, jc, jnp.asarray(toks[:, off:off + n]),
            *(jnp.asarray(x, jnp.int32) for x in args), policy=jpol)
        tlast, tc = tm.prefill_chunk(
            tp, tc, torch.from_numpy(toks[:, off:off + n]),
            *(torch.from_numpy(x) for x in args), policy=tpol)
        _close(tlast, jlast, spec, f"chunk at {off}")
        _close_cache(tc.data, jc.data, spec, f"chunk at {off}")
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jc.length))
    jl, jcc = jm.prefill_chunked(jp, jnp.asarray(toks), 8, max_len=24,
                                 policy=jpol)
    tl, tcc = tm.prefill_chunked(tp, torch.from_numpy(toks), 8, max_len=24,
                                 policy=tpol)
    _close(tl, jl, spec, "prefill_chunked")
    _close_cache(tcc.data, jcc.data, spec, "prefill_chunked")


@pytest.mark.parametrize("chunk", [4, 8])
def test_prefill_chunked_is_prefill_bitwise(chunk):
    """In the config's own bfloat16: chunk boundaries on multiples of the
    scan chunk carry conv, h and the shared KV bit for bit (the last chunk
    of 10 tokens is partial)."""
    _, cfg = _cfgs()
    tm = LM(cfg, device="cpu")
    tp = tm.init(seed=0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256,
                                                              (2, 10)))
    last_m, cm = tm.prefill(tp, toks, max_len=24)
    last_c, cc = tm.prefill_chunked(tp, toks, chunk, max_len=24)
    assert torch.equal(last_m, last_c)
    for name in ("conv", "h"):
        assert torch.equal(cm.data[name], cc.data[name]), name
    for name in ("k", "v"):
        assert torch.equal(cm.data[name][:, :, :10],
                           cc.data[name][:, :, :10]), name
    assert cc.length.tolist() == [10, 10]


@pytest.mark.parametrize("spec", POLICIES, ids=POLICY_IDS)
def test_hybrid_decode_scan_matches_jax(pair, spec):
    """Inactive lanes keep their conv/h states and shared KV bit for bit."""
    jm, jp, tm, tp = pair
    jpol, tpol = _policies(spec)
    toks = np.random.default_rng(4).integers(0, 256, (3, 12))
    _, jc = jm.prefill(jp, jnp.asarray(toks), max_len=24, policy=jpol)
    _, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=24, policy=tpol)
    jc = type(jc)(jc.data, jnp.full((3,), 12, jnp.int32))
    tc = tm.cache_at_length(tc, [12, 12, 12])
    held = {k: v[:, 1].clone() for k, v in tc.data.items()}
    tok = np.array([[5], [7], [9]])
    active = np.array([True, False, True])
    budget = np.array([6, 6, 2])
    jout = jm.decode_scan(jp, jc, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(active), jnp.asarray(budget, jnp.int32),
                          5, policy=jpol, stop_tokens=(3,))
    tout = tm.decode_scan(tp, tc, torch.from_numpy(tok),
                          torch.from_numpy(active), torch.from_numpy(budget),
                          5, policy=tpol, stop_tokens=(3,))
    (jcache, _, jact, jbud, jtoks, jemit) = jout
    (tcache, _, tact, tbud, ttoks, temit) = tout
    np.testing.assert_array_equal(temit.numpy(), np.asarray(jemit))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(tbud.numpy(), np.asarray(jbud))
    _close_cache(tcache.data, jcache.data, spec, "decode_scan")
    for k, v in held.items():
        assert torch.equal(tcache.data[k][:, 1], v), k


def test_hybrid_policy_routes_the_shared_block_and_unembed(pair,
                                                           monkeypatch):
    """Under an emulating policy the Mamba-2 projections stay plain
    matmuls: a forward routes the shared block's six projections per
    application and the unembed (on the card, 6 * 2 + 1 K1 launches here;
    zamba2-1.2b's six applications make 37)."""
    from repro_torch.numerics import emulate
    _, _, tm, tp = pair
    calls = []
    real = emulate.emulated_matmul

    def counting(*args, **kw):
        calls.append(tuple(args[1].shape))
        return real(*args, **kw)

    monkeypatch.setattr(emulate, "emulated_matmul", counting)
    pol = EmulatedPolicy("bf16", "fused")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 9)))
    tm.apply(tp, toks, policy=pol)
    d, hd = tm.cfg.d_model, tm.cfg.head_dim
    shared = [(d, 4 * hd), (d, 4 * hd), (d, 4 * hd), (4 * hd, d),
              (d, tm.cfg.d_ff), (tm.cfg.d_ff, d)]
    assert calls == shared * 2 + [(d, tm.vocab_padded)]
    calls.clear()
    _, cache = tm.prefill(tp, toks, max_len=12, policy=pol)
    assert len(calls) == 13  # the states' second pass routes nothing
    calls.clear()
    tm.decode_step(tp, cache, toks[:, :1], policy=pol)
    assert len(calls) == 13
