"""The port's LM against the JAX package on exported weights.

The JAX ``tinyllama-1.1b`` (dense) and ``falcon-mamba-7b`` (ssm)
``reduced()`` configs in float32 (and, through ``apply``, ``prefill`` and
three ``decode_step``s, the dense chatglm3-6b, starcoder2-7b and
deepseek-67b) draw their parameters with the JAX PRNG;
``params_from_jax`` loads the same tree into the port, and both packages run
the same token ids (numpy, from a seed) through ``apply``, ``prefill`` +
``decode_step`` x4, ``prefill_batched``, ``decode_scan`` and, for the ssm
family, ``prefill_chunk`` and the decode states.  Tolerances:

  * ``policy=None``: rtol = atol = 1e-4 (f32 end to end; only the
    summation order of the products differs);
  * emulating policies: |delta| <= 4 * 2**-8 * max|logit|.  A bf16/fp8
    rounding step can flip by one format ulp when the two sides' f32
    partial dots differ in their last bit, and such a flip propagates
    through the layers; four bf16 ulps of the largest logit bound it.

The ssm family's policy reaches the unembed alone: one policy-routed
matmul per forward (one K1 launch on the card).
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

POLICIES = [None, ("bf16", "fused"), ("bf16", "cascade"),
            ("bf16", "cascade_fwd"), ("fp8_e4m3", "fused")]
POLICY_IDS = ["native", "bf16-fused", "bf16-cascade", "bf16-cascade_fwd",
              "fp8_e4m3-fused"]


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
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
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if spec is None:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        bound = 4 * 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want).max() <= bound, (what, bound)


@pytest.mark.parametrize("spec", POLICIES, ids=POLICY_IDS)
def test_logits_match_jax(pair, spec):
    jm, jp, tm, tp = pair
    jpol, tpol = _policies(spec)
    r = np.random.default_rng(0)
    toks = r.integers(0, 256, (2, 24))

    jl, _ = jm.apply(jp, jnp.asarray(toks), policy=jpol)
    tl, _ = tm.apply(tp, torch.from_numpy(toks), policy=tpol)
    _close(tl, jl, spec, "apply")

    # prefill, then four decode steps from the same greedy tokens
    jlast, jc = jm.prefill(jp, jnp.asarray(toks), max_len=32, policy=jpol)
    tlast, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=32,
                           policy=tpol)
    _close(tlast, jlast, spec, "prefill")
    nxt = np.array(jnp.argmax(jlast, -1))[:, None]
    for step in range(4):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), policy=jpol)
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                                  policy=tpol)
        _close(tlog, jlog, spec, f"decode_step {step}")
        nxt = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]

    # bucket-padded batched prefill with per-sample lengths
    lens = np.array([17, 24])
    padded = np.where(np.arange(24)[None] < lens[:, None], toks, 0)
    jb, jkv, _ = jm.prefill_batched(jp, jnp.asarray(padded),
                                    jnp.asarray(lens), policy=jpol)
    tb, tkv, _ = tm.prefill_batched(tp, torch.from_numpy(padded),
                                    torch.from_numpy(lens), policy=tpol)
    _close(tb, jb, spec, "prefill_batched")
    for jt, tt in zip(jkv, tkv):
        _close(tt, jt, spec, "prefill_batched kv")


@pytest.mark.parametrize("spec", [None, ("bf16", "cascade")],
                         ids=["native", "bf16-cascade"])
def test_decode_scan_matches_jax(pair, spec):
    jm, jp, tm, tp = pair
    jpol, tpol = _policies(spec)
    toks = np.random.default_rng(1).integers(0, 256, (3, 12))
    _, jc = jm.prefill(jp, jnp.asarray(toks), max_len=24, policy=jpol)
    _, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=24, policy=tpol)
    jc = jm.cache_at_length(jc, jnp.full((3,), 12, jnp.int32))
    jc = type(jc)(jc.data, jnp.full((3,), 12, jnp.int32))
    tc = tm.cache_at_length(tc, [12, 12, 12])
    tok = np.array([[5], [7], [9]])
    active = np.array([True, False, True])
    budget = np.array([6, 6, 2])
    jout = jm.decode_scan(jp, jc, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(active), jnp.asarray(budget, jnp.int32),
                          5, policy=jpol, stop_tokens=(3,))
    tout = tm.decode_scan(tp, tc, torch.from_numpy(tok),
                          torch.from_numpy(active), torch.from_numpy(budget),
                          5, policy=tpol, stop_tokens=(3,))
    (jcache, jtok, jact, jbud, jtoks, jemit) = jout
    (tcache, ttok, tact, tbud, ttoks, temit) = tout
    np.testing.assert_array_equal(temit.numpy(), np.asarray(jemit))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(tbud.numpy(), np.asarray(jbud))
    np.testing.assert_array_equal(tcache.length.numpy(),
                                  np.asarray(jcache.length))
    for name in ("k", "v"):
        _close(tcache.data[name], jcache.data[name], spec, name)


# ---------------------------------------------- the other dense configs
#: dense configs with features tinyllama lacks: chatglm3-6b (half-width
#: RoPE, qkv biases), starcoder2-7b (gelu MLP, qkv biases), deepseek-67b
DENSE_ARCHS = ["chatglm3-6b", "starcoder2-7b", "deepseek-67b"]


@functools.lru_cache(maxsize=None)
def _dense_pair(arch):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    tm = LM(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("spec", [None, ("bf16", "fused")],
                         ids=["native", "bf16-fused"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_configs_match_jax(arch, spec):
    """``apply``, ``prefill`` and three ``decode_step``s of each reduced
    config, at the file's tolerances."""
    jm, jp, tm, tp = _dense_pair(arch)
    jpol, tpol = _policies(spec)
    toks = np.random.default_rng(5).integers(0, 256, (2, 8))
    jl, _ = jm.apply(jp, jnp.asarray(toks), policy=jpol)
    tl, _ = tm.apply(tp, torch.from_numpy(toks), policy=tpol)
    _close(tl, jl, spec, f"{arch} apply")
    jlast, jc = jm.prefill(jp, jnp.asarray(toks), max_len=24, policy=jpol)
    tlast, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=24,
                           policy=tpol)
    _close(tlast, jlast, spec, f"{arch} prefill")
    nxt = np.array(jnp.argmax(jlast, -1))[:, None]
    for step in range(3):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), policy=jpol)
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                                  policy=tpol)
        _close(tlog, jlog, spec, f"{arch} decode_step {step}")
        nxt = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]


ALL_ARCHS = ["chatglm3-6b", "deepseek-67b", "deepseek-moe-16b",
             "falcon-mamba-7b", "internvl2-1b", "mixtral-8x7b",
             "musicgen-large", "starcoder2-7b", "tinyllama-1.1b",
             "zamba2-1.2b"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_builds(arch):
    """Each of the ten configs builds in the port, its ``reduced()`` config
    runs a forward on the CPU, and the full config builds too."""
    from repro_torch.configs.base import all_configs
    assert sorted(all_configs()) == ALL_ARCHS
    assert LM(get_config(arch), device="cpu").cfg.name == arch
    cfg = get_config(arch).reduced()
    model = LM(cfg, device="cpu")
    params = model.init(seed=0)
    B, S = 2, 5
    toks = torch.zeros((B, S), dtype=torch.int64)
    kw = {}
    if cfg.family == "vlm":
        kw["prefix_embeds"] = torch.ones((B, cfg.n_prefix_tokens,
                                          cfg.d_model))
    elif cfg.family == "audio":
        toks, kw["frame_embeds"] = None, torch.ones((B, S, cfg.d_model))
    logits, _ = model.apply(params, toks, **kw)
    n = S + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    assert logits.shape == (B, n, model.vocab_padded)
    assert bool(torch.isfinite(logits).all())


# ------------------------------------------------------------ ssm family
@pytest.fixture(scope="module")
def ssm_pair():
    jcfg = dataclasses.replace(jget_config("falcon-mamba-7b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("falcon-mamba-7b").reduced(),
                              dtype="float32")
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = LM(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def _close_states(tdata, jdata, spec, what):
    for name in ("conv", "h"):
        _close(tdata[name], jdata[name], spec, f"{what} {name}")


@pytest.mark.parametrize("spec", POLICIES, ids=POLICY_IDS)
def test_ssm_logits_match_jax(ssm_pair, spec):
    """100 tokens: one whole scan chunk of 64 and a padded one."""
    jm, jp, tm, tp = ssm_pair
    jpol, tpol = _policies(spec)
    toks = np.random.default_rng(2).integers(0, 256, (2, 100))

    jl, _ = jm.apply(jp, jnp.asarray(toks), policy=jpol)
    tl, _ = tm.apply(tp, torch.from_numpy(toks), policy=tpol)
    _close(tl, jl, spec, "apply")

    jlast, jc = jm.prefill(jp, jnp.asarray(toks), policy=jpol)
    tlast, tc = tm.prefill(tp, torch.from_numpy(toks), policy=tpol)
    _close(tlast, jlast, spec, "prefill")
    _close_states(tc.data, jc.data, spec, "prefill")
    nxt = np.array(jnp.argmax(jlast, -1))[:, None]
    for step in range(4):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), policy=jpol)
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                                  policy=tpol)
        _close(tlog, jlog, spec, f"decode_step {step}")
        nxt = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
    _close_states(tc.data, jc.data, spec, "decode")

    # exact-length batched prefill: the states come back for the engine
    lens = np.array([100, 100])
    jb, jkv, (jconv, jh) = jm.prefill_batched(jp, jnp.asarray(toks),
                                              jnp.asarray(lens), policy=jpol)
    tb, tkv, (tconv, th) = tm.prefill_batched(tp, torch.from_numpy(toks),
                                              torch.from_numpy(lens),
                                              policy=tpol)
    assert jkv is None and tkv is None
    _close(tb, jb, spec, "prefill_batched")
    _close_states({"conv": tconv, "h": th}, {"conv": jconv, "h": jh}, spec,
                  "prefill_batched")


@pytest.mark.parametrize("spec", [None, ("bf16", "fused")],
                         ids=["native", "bf16-fused"])
def test_ssm_prefill_chunk_matches_jax(ssm_pair, spec):
    """Lanes 2 and 0 of a three-slot cache, prefilled in a chunk of 64 and
    then the remaining 36 tokens; slot 2 held another request's state,
    which a fresh lane must not inherit."""
    jm, jp, tm, tp = ssm_pair
    jpol, tpol = _policies(spec)
    toks = np.random.default_rng(3).integers(0, 256, (2, 100))
    slots = np.array([2, 0])
    jc = jm.init_cache(3, 128)
    jc = type(jc)({k: v.at[:, 2].set(1.0) for k, v in jc.data.items()},
                  jnp.zeros(3, jnp.int32))
    tc = tm.init_cache(3, 128)
    for v in tc.data.values():
        v[:, 2] = 1.0
    tc = tm.cache_at_length(tc, [0, 0, 0])
    for off, n in ((0, 64), (64, 36)):
        args = (np.full(2, off), np.full(2, n), slots)
        jlast, jc = jm.prefill_chunk(
            jp, jc, jnp.asarray(toks[:, off:off + n]),
            *(jnp.asarray(x, jnp.int32) for x in args), policy=jpol)
        tlast, tc = tm.prefill_chunk(
            tp, tc, torch.from_numpy(toks[:, off:off + n]),
            *(torch.from_numpy(x) for x in args), policy=tpol)
        _close(tlast, jlast, spec, f"chunk at {off}")
        _close_states(tc.data, jc.data, spec, f"chunk at {off}")
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jc.length))
    # and the chunked prefill equals the monolithic one
    mlast, mc = tm.prefill(tp, torch.from_numpy(toks), policy=tpol)
    _close(tlast, mlast.numpy(), spec, "chunked vs monolithic")
    for name in ("conv", "h"):
        _close(tc.data[name][:, slots], mc.data[name].numpy(), spec, name)


def test_ssm_decode_scan_matches_jax(ssm_pair):
    """Inactive lanes keep their conv/h states bit for bit."""
    jm, jp, tm, tp = ssm_pair
    toks = np.random.default_rng(4).integers(0, 256, (3, 12))
    _, jc = jm.prefill(jp, jnp.asarray(toks))
    _, tc = tm.prefill(tp, torch.from_numpy(toks))
    jc = type(jc)(jc.data, jnp.full((3,), 12, jnp.int32))
    tc = tm.cache_at_length(tc, [12, 12, 12])
    held = {k: v[:, 1].clone() for k, v in tc.data.items()}
    tok = np.array([[5], [7], [9]])
    active = np.array([True, False, True])
    budget = np.array([6, 6, 2])
    jout = jm.decode_scan(jp, jc, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(active), jnp.asarray(budget, jnp.int32),
                          5, stop_tokens=(3,))
    tout = tm.decode_scan(tp, tc, torch.from_numpy(tok),
                          torch.from_numpy(active), torch.from_numpy(budget),
                          5, stop_tokens=(3,))
    (jcache, jtok, jact, jbud, jtoks, jemit) = jout
    (tcache, ttok, tact, tbud, ttoks, temit) = tout
    np.testing.assert_array_equal(temit.numpy(), np.asarray(jemit))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(tbud.numpy(), np.asarray(jbud))
    _close_states(tcache.data, jcache.data, None, "decode_scan")
    for k, v in held.items():
        assert torch.equal(tcache.data[k][:, 1], v), k


def test_ssm_policy_reaches_the_unembed_alone(ssm_pair, monkeypatch):
    """Under an emulating policy the mamba projections stay plain matmuls:
    each forward routes one matmul, the unembed, through emulated_matmul
    (one K1 launch on the card)."""
    from repro_torch.numerics import emulate
    _, _, tm, tp = ssm_pair
    calls = []
    real = emulate.emulated_matmul

    def counting(*args, **kw):
        calls.append(args[1].shape)
        return real(*args, **kw)

    monkeypatch.setattr(emulate, "emulated_matmul", counting)
    pol = EmulatedPolicy("bf16", "fused")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 9)))
    tm.apply(tp, toks, policy=pol)
    _, cache = tm.prefill(tp, toks, policy=pol)
    tm.decode_step(tp, cache, toks[:, :1], policy=pol)
    d = tm.cfg.d_model
    assert calls == [(d, tm.vocab_padded)] * 3
