"""The port's float8_e4m3fn KV cache against the JAX package's.

deepseek-67b keeps its KV cache in float8_e4m3fn; ``reduced()`` clears
that, so the config here puts it back (float32 compute) and switches
``qkv_bias`` on to plant exact values: in the last layer the k and v weight
columns of a few head dims are zeroed, so those dims of k and v are their
biases (k then rotated by RoPE, in its slowest pairs, so that each planted
value keeps its side of 464 over the positions used).  Planted: 464 (the tie
that rounds to 448), 465 (beyond it), 3e38 and -inf.  JAX's cast gives NaN
beyond 464; torch's saturates to +-448, so the port turns those values into
NaN before it casts.

Tolerances: caches NaN where JAX's are and bitwise equal elsewhere (the
f32 k and v agree to an ulp, and no other value lies on an fp8 rounding
tie); logits NaN where JAX's are and within rtol = atol = 1e-4 elsewhere
(f32 end to end; only the products' summation order differs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import LM as JLM
from repro_torch.configs.base import get_config
from repro_torch.models import LM
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import to_cache

FP8 = dict(dtype="float32", kv_cache_dtype="float8_e4m3fn", qkv_bias=True)
PLANTED = (464.0, 465.0, 3e38, -np.inf)
#: head dims of k planted with PLANTED, in RoPE's slowest pairs (i, i + 8)
#: of the 16-wide head: 464 where the rotation only lowers it, 465 where it
#: stays above 464 over 32 positions
K_DIMS = (4, 7, 6, 5)
V_DIMS = (0, 1, 2, 3)


def _plant(jp):
    """The JAX parameter tree with PLANTED in the last layer's k and v."""
    layers = dict(jp["layers"])
    for w, b, dims in (("wk", "bk", K_DIMS), ("wv", "bv", V_DIMS)):
        wn, bn = np.array(layers[w]), np.array(layers[b])
        for d, val in zip(dims, PLANTED):
            wn[-1, :, d] = 0.0
            bn[-1, d] = val
            if w == "wk":  # the rotation partner stays zero
                wn[-1, :, d + 8] = 0.0
                bn[-1, d + 8] = 0.0
        layers[w], layers[b] = jnp.asarray(wn), jnp.asarray(bn)
    return {**jp, "layers": layers}


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config("deepseek-67b").reduced(), **FP8)
    cfg = dataclasses.replace(get_config("deepseek-67b").reduced(), **FP8)
    jm = JLM(jcfg)
    jp = _plant(jm.init(jax.random.PRNGKey(0)))
    tm = LM(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _cache_equal(got, want, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all(), what
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32), err_msg=what)


def _logits_close(got, want, what):
    got, want = _f32(got), _f32(want)
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all(), what
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-4, atol=1e-4,
                               err_msg=what)


@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_to_cache_matches_jax_astype(src):
    x = np.array([448, 463.99997, 464, 464.00003, 465, -464, -465, 479, 480,
                  3e38, np.inf, -np.inf, np.nan, 1e-10, -0.0, 2.0 ** -9,
                  2.0 ** -10, 0.3], np.float32)
    t = torch.from_numpy(x).to(src)
    want = jnp.asarray(t.float().numpy()).astype(
        {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[src]
    ).astype(jnp.float8_e4m3fn)
    _cache_equal(to_cache(t, torch.float8_e4m3fn), want, str(src))
    # other cache types are a plain cast
    _cache_equal(to_cache(t, torch.bfloat16), t.to(torch.bfloat16), "bf16")


@pytest.mark.parametrize("path", ["prefill-decode", "prefill_batched",
                                  "prefill_chunk"])
def test_fp8_kv_cache_matches_jax(pair, path):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(0).integers(0, 256, (2, 12))
    if path == "prefill_batched":
        lens = np.array([9, 12])
        jl, jkv, _ = jm.prefill_batched(jp, jnp.asarray(toks),
                                        jnp.asarray(lens))
        tl, tkv, _ = tm.prefill_batched(tp, torch.from_numpy(toks),
                                        torch.from_numpy(lens))
        _logits_close(tl, jl, path)
        for name, jt, tt in zip("kv", jkv, tkv):
            assert tt.dtype == torch.float8_e4m3fn
            _cache_equal(tt, jt, f"{path} {name}")
        # the planted values came through: NaN where JAX's cast gives it
        assert np.isnan(_f32(tkv[1])[-1, ..., 1]).all()
        return
    if path == "prefill-decode":
        jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=16)
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=16)
    else:  # two chunks into lanes 1 and 0 of a two-slot cache
        jc = jm.init_cache(2, 16)
        jc = type(jc)(jc.data, jnp.zeros(2, jnp.int32))
        tc = tm.cache_at_length(tm.init_cache(2, 16), [0, 0])
        for off, n in ((0, 8), (8, 4)):
            args = (np.full(2, off), np.full(2, n), np.array([1, 0]))
            jl, jc = jm.prefill_chunk(
                jp, jc, jnp.asarray(toks[:, off:off + n]),
                *(jnp.asarray(a, jnp.int32) for a in args))
            tl, tc = tm.prefill_chunk(
                tp, tc, torch.from_numpy(toks[:, off:off + n]),
                *(torch.from_numpy(a) for a in args))
    _logits_close(tl, jl, path)
    for name in "kv":
        _cache_equal(tc.data[name], jc.data[name], f"{path} {name}")
    for step, tok in enumerate(([[5], [7]], [[9], [11]], [[13], [2]])):
        tok = np.array(tok)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _logits_close(tl, jl, f"{path} decode {step}")
        for name in "kv":
            _cache_equal(tc.data[name], jc.data[name],
                         f"{path} decode {step} {name}")
    assert np.isnan(_f32(tl)).all()  # the last layer reads NaN from its cache
    assert not np.isnan(_f32(tc.data["k"])[0]).any()  # layer 0 is clean
