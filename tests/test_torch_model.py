"""The port's dense LM against the JAX package on exported weights.

The JAX ``tinyllama-1.1b`` ``reduced()`` config in float32 draws its
parameters with the JAX PRNG; ``params_from_jax`` loads the same tree into
the port, and both packages run the same token ids (numpy, from a seed)
through ``apply``, ``prefill`` + ``decode_step`` x4, ``prefill_batched`` and
``decode_scan``.  Tolerances:

  * ``policy=None``: rtol = atol = 1e-4 (f32 end to end; only the
    summation order of the products differs);
  * emulating policies: |delta| <= 4 * 2**-8 * max|logit|.  A bf16/fp8
    rounding step can flip by one format ulp when the two sides' f32
    partial dots differ in their last bit, and such a flip propagates
    through the layers; four bf16 ulps of the largest logit bound it.
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


def test_later_families_raise_not_implemented():
    for arch in ("falcon-mamba-7b", "zamba2-1.2b", "mixtral-8x7b",
                 "internvl2-1b", "musicgen-large"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            LM(get_config(arch).reduced(), device="cpu")
