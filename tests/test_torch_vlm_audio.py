"""The port's vlm and audio families (internvl2-1b, musicgen-large) against
the JAX package's ``LM``.

Both are the dense decoder over embedding inputs: internvl2's precomputed
patch embeddings (``prefix_embeds``) go in front of the token embeddings,
musicgen's precomputed frame embeddings (``frame_embeds``) replace them.
The ``reduced()`` configs run in float32 on weights drawn by the JAX
``LM.init`` and loaded with ``params_from_jax``; internvl2's qkv biases,
which ``init`` zeroes, get values from a seed in both trees so that they
count.  Embeddings and tokens come from numpy with a seed.  ``apply``,
``prefill`` (whose cache length counts the prefix) and four
``decode_step``s run in both packages, and each model is served as a token
LM by both engines.  musicgen is run again with its float8_e4m3fn KV cache
put back on the reduced config, as tests/test_torch_window.py does for
deepseek-moe.  Tolerances, as tests/test_torch_model.py holds the dense
family:

  * ``policy=None``: rtol = atol = 1e-4, and served tokens equal;
  * ``EmulatedPolicy("bf16", "fused")`` (K1's plain version on the CPU):
    |delta| <= 4 * 2**-8 * max|logit|;
  * float8 caches: the cast of values that agree to 1e-6 may land one fp8
    step apart, so caches are held to 2**-3 * max|cache|.
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
from repro.serve import engine as jengine
from repro_torch.configs.base import get_config
from repro_torch.models import LM
from repro_torch.models.convert import params_from_jax
from repro_torch.models.numerics import EmulatedPolicy
from repro_torch.serve import BatchedServer, Request

ARCHS = ["internvl2-1b", "musicgen-large"]
POLICIES = [None, ("bf16", "fused")]
POLICY_IDS = ["native", "bf16-fused"]
FP8 = (("dtype", "float32"), ("kv_cache_dtype", "float8_e4m3fn"))


@functools.lru_cache(maxsize=None)
def _pair(arch, kw=(("dtype", "float32"),)):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **dict(kw))
    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(kw))
    jm = JLM(jcfg)
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(4)))
    if cfg.qkv_bias:
        rng = np.random.default_rng(6)
        for name in ("bq", "bk", "bv"):
            leaf = tree["layers"][name]
            tree["layers"][name] = (0.5 * rng.standard_normal(
                leaf.shape)).astype(leaf.dtype)
    jp = jax.tree.map(jnp.asarray, tree)
    tm = LM(cfg, device="cpu")
    tp = params_from_jax(tree, cfg, device="cpu")
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


def _inputs(cfg, B=2, S=8, seed=3):
    """Tokens and the family's embeddings, as numpy: (tokens or None,
    kwargs for apply/prefill)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        toks = rng.integers(0, cfg.vocab_size, (B, S))
        embeds = rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_model))
        return toks, {"prefix_embeds": embeds.astype(np.float32)}
    embeds = rng.standard_normal((B, S, cfg.d_model))
    return None, {"frame_embeds": embeds.astype(np.float32)}


def _run(jm, jp, tm, tp, spec, fp8=False):
    """apply, prefill + four decode steps in both packages, compared."""
    jpol, tpol = _policies(spec)
    toks, emb = _inputs(tm.cfg)
    jkw = {k: jnp.asarray(v) for k, v in emb.items()}
    tkw = {k: torch.from_numpy(v) for k, v in emb.items()}
    jt = None if toks is None else jnp.asarray(toks)
    tt = None if toks is None else torch.from_numpy(toks)
    jl, _ = jm.apply(jp, jt, policy=jpol, **jkw)
    tl, _ = tm.apply(tp, tt, policy=tpol, **tkw)
    _close(tl, jl, spec, "apply")
    S = tl.shape[1]  # prefix positions included
    jlast, jc = jm.prefill(jp, jt, max_len=S + 8, policy=jpol, **jkw)
    tlast, tc = tm.prefill(tp, tt, max_len=S + 8, policy=tpol, **tkw)
    _close(tlast, jlast, spec, "prefill")
    assert int(tc.length) == int(jc.length) == S
    for name in ("k", "v"):
        _close(tc.data[name], jc.data[name], spec, f"prefill {name}", fp8)
    nxt = np.array(jnp.argmax(jlast, -1))[:, None]
    for step in range(4):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), policy=jpol)
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                                  policy=tpol)
        _close(tlog, jlog, spec, f"decode_step {step}")
        nxt = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
    for name in ("k", "v"):
        _close(tc.data[name], jc.data[name], spec, f"decode {name}", fp8)
    return tl


@pytest.mark.parametrize("spec", POLICIES, ids=POLICY_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_embedding_inputs_match_jax(arch, spec):
    jm, jp, tm, tp = _pair(arch)
    logits = _run(jm, jp, tm, tp, spec)
    want = 8 + (tm.cfg.n_prefix_tokens if tm.cfg.family == "vlm" else 0)
    assert logits.shape == (2, want, tm.vocab_padded)


@pytest.mark.parametrize("spec", POLICIES, ids=POLICY_IDS)
def test_musicgen_fp8_cache_matches_jax(spec):
    """musicgen-large keeps its float8_e4m3fn cache (``to_cache``) through
    prefill and decode, and the bucket-padded batched prefill's KV."""
    jm, jp, tm, tp = _pair("musicgen-large", FP8)
    assert tm.cache_dtype == torch.float8_e4m3fn
    _run(jm, jp, tm, tp, spec, fp8=True)
    jpol, tpol = _policies(spec)
    toks = np.random.default_rng(9).integers(0, 256, (2, 12))
    lens = np.array([9, 12])
    padded = np.where(np.arange(12)[None] < lens[:, None], toks, 0)
    jb, jkv, _ = jm.prefill_batched(jp, jnp.asarray(padded),
                                    jnp.asarray(lens), policy=jpol)
    tb, tkv, _ = tm.prefill_batched(tp, torch.from_numpy(padded),
                                    torch.from_numpy(lens), policy=tpol)
    _close(tb, jb, spec, "prefill_batched")
    for got, want in zip(tkv, jkv):
        assert got.dtype == torch.float8_e4m3fn
        _close(got, want, spec, "prefill_batched kv", fp8=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_match_jax(arch):
    """Each model served as a token LM (the engine's ``Request`` carries
    token ids): the port's ``BatchedServer`` and the JAX one give the same
    tokens, monolithic and chunked."""
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 256, n) for n in (5, 11, 3, 17, 8)]
    outs = {}
    for key, eng, model, params, dtype in (
            ("jax", jengine, jm, jp, np.int32),
            ("port", None, tm, tp, np.int64)):
        for chunk in (None, 4):
            cls = BatchedServer if eng is None else eng.BatchedServer
            req = Request if eng is None else eng.Request
            srv = cls(model, params, slots=3, max_len=40, dispatch_tokens=3,
                      prefill_chunk=chunk)
            reqs = [req(uid=i, prompt=p.astype(dtype), max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                srv.submit(r)
            srv.run()
            outs[key, chunk] = [list(r.output) for r in reqs]
    assert outs["port", None] == outs["jax", None]
    assert outs["port", 4] == outs["jax", 4]
    assert all(len(o) == 6 for o in outs["port", None])


@pytest.mark.parametrize("arch,per_layer", [("internvl2-1b", 7),
                                            ("musicgen-large", 6)])
def test_policy_routes_every_projection(arch, per_layer, monkeypatch):
    """Under an emulating policy every projection and the unembed go
    through ``emulated_matmul`` (K1 on the card): q, k, v, o and the MLP's
    three (swiglu) or two (gelu) matrices a layer, plus the unembed."""
    from repro_torch.numerics import emulate
    _, _, tm, tp = _pair(arch)
    calls = []
    real = emulate.emulated_matmul

    def counting(*args, **kw):
        calls.append(args[1].shape)
        return real(*args, **kw)

    monkeypatch.setattr(emulate, "emulated_matmul", counting)
    toks, emb = _inputs(tm.cfg)
    kw = {k: torch.from_numpy(v) for k, v in emb.items()}
    pol = EmulatedPolicy("bf16", "fused")
    tt = None if toks is None else torch.from_numpy(toks)
    per_fwd = per_layer * tm.cfg.n_layers + 1
    _, cache = tm.prefill(tp, tt, policy=pol, max_len=40, **kw)
    assert len(calls) == per_fwd
    tm.decode_step(tp, cache, torch.zeros((2, 1), dtype=torch.int64),
                   policy=pol)
    assert len(calls) == 2 * per_fwd
    assert calls[-1] == (tm.cfg.d_model, tm.vocab_padded)


def test_full_configs_build_with_their_trees():
    """The full configs build with no gate left, and the parameter trees
    ``params_from_jax`` checks against carry internvl2's qkv biases and
    musicgen's two-matrix gelu MLP."""
    from repro_torch.models.convert import _expected_shapes
    for arch in ARCHS:
        cfg = get_config(arch)
        model = LM(cfg, device="meta")
        shapes = _expected_shapes(cfg)
        assert model.cfg.family in ("vlm", "audio")
        assert shapes["embed"] == (model.vocab_padded, cfg.d_model)
        assert ("bq" in shapes["layers"]) == cfg.qkv_bias
        assert ("w_gate" in shapes["layers"]["mlp"]) == \
            (cfg.mlp_act == "swiglu")
