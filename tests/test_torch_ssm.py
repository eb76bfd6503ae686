"""The port's selective state-space blocks against the JAX package.

``repro_torch.models.ssm`` (chunked linear scan, causal conv, Mamba-1 and
Mamba-2 blocks) runs the same seeded numpy inputs and the same parameters
(drawn by the JAX ``*_init`` and exported as numpy) as ``repro.models.ssm``.
Tolerance: rtol = atol = 1e-5.  Everything is float32; the JAX package scans
each chunk with ``lax.associative_scan`` and the port with a Hillis-Steele
doubling scan, which multiply the decays in another order, and XLA may
contract a product and a sum into one FMA where PyTorch rounds twice.

Streaming decode (a chunked prefix, then one token at a time with the state
carried) must equal the full forward within 1e-4, the bound
tests/test_ssm_and_moe.py::test_mamba_streaming_equals_full holds the JAX
package to.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs.base import get_config
from repro_torch.models import ssm

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(p):
    return {k: _tree(v) if isinstance(v, dict) else _t(v)
            for k, v in p.items()}


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **(tol or TOL))


@pytest.mark.parametrize("S,chunk", [(64, 16), (100, 16), (37, 64), (5, 8)],
                         ids=["whole-chunks", "padded", "one-chunk",
                              "short"])
@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["full-a", "head-a"])
def test_chunked_linear_scan_matches_jax(S, chunk, broadcast):
    r = np.random.default_rng(S + chunk)
    B, H, P = 2, 3, 4
    a_shape = (B, S, H, 1, 1) if broadcast else (B, S, H, P, 5)
    a = r.uniform(0.5, 1.0, a_shape).astype(np.float32)
    b = r.standard_normal((B, S, H, P, 5)).astype(np.float32)
    h0 = r.standard_normal((B, H, P, 5)).astype(np.float32)
    want_seq, want_last = jssm.chunked_linear_scan(jnp.asarray(a),
                                                   jnp.asarray(b),
                                                   jnp.asarray(h0), chunk)
    got_seq, got_last = ssm.chunked_linear_scan(_t(a), _t(b), _t(h0), chunk)
    _close(got_seq, want_seq, "h_seq")
    _close(got_last, want_last, "h_last")


def test_inclusive_scan_is_prefix_stable():
    """A position's result does not depend on what follows it, so padding a
    chunk's tail leaves the valid positions' bits as they were (what the
    chunked serving prefill relies on)."""
    r = np.random.default_rng(0)
    a = _t(r.uniform(0.5, 1.0, (2, 64, 8)).astype(np.float32))
    b = _t(r.standard_normal((2, 64, 8)).astype(np.float32))
    full_a, full_b = ssm._inclusive_scan(a, b)
    for n in (1, 7, 36, 63):
        pa, pb = ssm._inclusive_scan(a[:, :n], b[:, :n])
        assert torch.equal(pa, full_a[:, :n]) and torch.equal(pb,
                                                              full_b[:, :n])


@pytest.mark.parametrize("with_carry", [False, True], ids=["fresh", "carry"])
@pytest.mark.parametrize("K", [1, 4])
def test_causal_conv1d_matches_jax(K, with_carry):
    r = np.random.default_rng(K)
    x = r.standard_normal((2, 9, 6)).astype(np.float32)
    w = r.standard_normal((K, 6)).astype(np.float32)
    b = r.standard_normal(6).astype(np.float32)
    carry = r.standard_normal((2, K - 1, 6)).astype(np.float32) \
        if with_carry else None
    want, want_c = jssm.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if carry is None else jnp.asarray(carry))
    got, got_c = ssm.causal_conv1d(_t(x), _t(w), _t(b),
                                   None if carry is None else _t(carry))
    _close(got, want, "out")
    _close(got_c, want_c, "carry")


def _mamba(version):
    """(JAX params, port params, JAX apply, port apply) of one block at
    d_model 16, d_state 4, chunk 4."""
    key = jax.random.key(version)
    if version == 1:
        jp = jssm.mamba1_init(key, 16, d_state=4, expand=2, conv=4,
                              dtype=jnp.float32)
        kw = dict(d_state=4, chunk=4)
        return jp, _tree(jp), jssm.mamba1_apply, ssm.mamba1_apply, kw
    jp = jssm.mamba2_init(key, 16, d_state=4, expand=2, conv=4, head_dim=8,
                          dtype=jnp.float32)
    kw = dict(d_state=4, head_dim=8, chunk=4)
    return jp, _tree(jp), jssm.mamba2_apply, ssm.mamba2_apply, kw


def _states(st):
    return tuple(_t(s) for s in st)


@pytest.mark.parametrize("version", [1, 2], ids=["mamba1", "mamba2"])
@pytest.mark.parametrize("S", [1, 7, 12], ids=["decode", "padded", "chunks"])
def test_mamba_apply_matches_jax(version, S):
    jp, tp, japply, tapply, kw = _mamba(version)
    r = np.random.default_rng(10 + S)
    x = r.standard_normal((2, S, 16)).astype(np.float32)
    prefix = r.standard_normal((2, 5, 16)).astype(np.float32)
    # from zero state, and resumed from the state a prefix left
    _close(tapply(tp, _t(x), **kw), japply(jp, jnp.asarray(x), **kw), "out")
    _, jst = japply(jp, jnp.asarray(prefix), return_state=True, **kw)
    jout, (jconv, jh) = japply(jp, jnp.asarray(x), state=jst,
                               return_state=True, **kw)
    tout, (tconv, th) = tapply(tp, _t(x), state=_states(jst),
                               return_state=True, **kw)
    _close(tout, jout, "resumed out")
    _close(tconv, jconv, "conv carry")
    _close(th, jh, "h")


@pytest.mark.parametrize("version", [1, 2], ids=["mamba1", "mamba2"])
def test_mamba_streaming_equals_full(version):
    """The port alone: a chunked prefix then per-token decode with the state
    carried equals the full forward."""
    _, tp, _, tapply, kw = _mamba(version)
    x = _t(np.random.default_rng(2).standard_normal((2, 12, 16))
           .astype(np.float32))
    full = tapply(tp, x, **kw)
    _, st = tapply(tp, x[:, :7], return_state=True, **kw)
    outs = []
    for t in range(7, 12):
        y, st = tapply(tp, x[:, t:t + 1], state=st, return_state=True, **kw)
        outs.append(y)
    tail = torch.cat(outs, dim=1)
    assert float((tail - full[:, 7:]).abs().max()) < 1e-4


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_state_shapes_match_jax(arch):
    for reduce in (False, True):
        jcfg, cfg = jget_config(arch), get_config(arch)
        if reduce:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        cfg = dataclasses.replace(cfg, dtype="float32") if reduce else cfg
        jcfg = dataclasses.replace(jcfg, dtype=cfg.dtype)
        for (shape, dtype), want in zip(ssm.mamba_state_shapes(cfg, 3),
                                        jssm.mamba_state_shapes(jcfg, 3)):
            assert shape == tuple(want.shape)
            assert str(dtype).removeprefix("torch.") == str(want.dtype)
