"""The port's training-path flash attention (``flash_attention_trainable``,
a ``torch.autograd.Function`` with the recompute backward) and the
``triangle_skip`` forward against the JAX package on the CPU.

Tolerances: dq, dk and dv within 1e-5 * max|g| of ``jax.grad`` through the
JAX ``flash_attention_trainable`` (the bound tests/test_attention.py holds
the JAX backward to against a dense reference), the forwards within 2e-5
(tests/test_attention.py's bound).  Without grad, and with grad on the
forward, the output is bitwise ``attention.flash_attention``'s, so the
serving paths do not depend on the autograd function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as jflash
from repro.models.flash_vjp import flash_attention_trainable as jtrain
from repro_torch.models.attention import flash_attention
from repro_torch.models.flash_vjp import flash_attention_trainable

GRAD_REL = 1e-5
FWD_ABS = 2e-5

# (B, Sq, Sk, Hq, Hkv, D, keywords): test_attention.py's gradient case,
# a window, kv_len < Sk with q_offset > 0, and a q_offset < 0 whose first
# rows attend nothing (the lse = NEG_INF guard)
CASES = {
    "gqa": (2, 48, 48, 4, 2, 8, dict(block_q=16, block_k=16)),
    "window": (2, 100, 100, 8, 8, 8, dict(window=24, block_q=32,
                                          block_k=16)),
    "kv_len_offset": (1, 40, 64, 4, 2, 8, dict(kv_len=50, q_offset=20,
                                               block_q=16, block_k=16)),
    "masked_rows": (1, 40, 64, 6, 1, 8, dict(q_offset=-10, block_q=16,
                                             block_k=16)),
}


def _operands(case, seed=1):
    B, Sq, Sk, Hq, Hkv, D, _ = case
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
             (B, Sq, Hq, D))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name):
    case = CASES[name]
    q, k, v, w = _operands(case)
    kw = case[-1]
    want = jax.grad(lambda qkv: jnp.sum(
        jtrain(*qkv, **kw).astype(jnp.float32) * w))(
        tuple(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = flash_attention_trainable(*ts, **kw)
    (out * torch.tensor(w)).sum().backward()
    for what, a, t in zip("qkv", want, ts):
        a, g = np.asarray(a), t.grad.numpy()
        assert np.isfinite(g).all(), what
        rel = np.abs(a - g).max() / (np.abs(a).max() + 1e-9)
        assert rel < GRAD_REL, (what, rel)


def test_masked_rows_give_zero_gradient():
    q, k, v, w = _operands(CASES["masked_rows"])
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = flash_attention_trainable(*ts, **CASES["masked_rows"][-1])
    (out * torch.tensor(w)).sum().backward()
    # q positions -10..-1 see no key: their output and dq are exactly 0
    assert torch.equal(out[:, :10], torch.zeros_like(out[:, :10]))
    assert torch.equal(ts[0].grad[:, :10], torch.zeros_like(out[:, :10]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_is_the_plain_forward(name):
    """Bitwise ``flash_attention``'s output without grad and with it."""
    case = CASES[name]
    q, k, v, _ = (torch.tensor(x) for x in _operands(case, seed=2))
    kw = case[-1]
    plain = flash_attention(q, k, v, **kw)
    assert torch.equal(flash_attention_trainable(q, k, v, **kw), plain)
    qg = q.clone().requires_grad_(True)
    assert torch.equal(flash_attention_trainable(qg, k, v, **kw), plain)
    want = jtrain(*(jnp.asarray(t.numpy()) for t in (q, k, v)), **kw)
    assert np.abs(plain.numpy() - np.asarray(want)).max() < FWD_ABS


def test_bf16_gradients_in_input_dtypes():
    q, k, v, w = _operands(CASES["gqa"])
    kw = CASES["gqa"][-1]
    ts = [torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
          for x in (q, k, v)]
    out = flash_attention_trainable(*ts, **kw)
    (out.float() * torch.tensor(w)).sum().backward()
    want = jax.grad(lambda qkv: jnp.sum(
        jtrain(*qkv, **kw).astype(jnp.float32) * w))(
        tuple(jnp.asarray(t.detach().float().numpy()).astype(jnp.bfloat16)
              for t in ts))
    for a, t in zip(want, ts):
        assert t.grad.dtype == torch.bfloat16 and a.dtype == jnp.bfloat16
        a = np.asarray(a, np.float32)
        g = t.grad.float().numpy()
        # two bf16 roundings of the f32 gradient: one bf16 ulp of max|g|
        assert np.abs(a - g).max() <= 2.0 ** -7 * np.abs(a).max()


def test_backward_saves_no_score_matrix():
    """The forward keeps q, k, v, the output blocks and the row stats:
    O(S * D), not a block's (bq, bk) probabilities per pair."""
    B, S, H, D = 1, 256, 1, 8
    r = np.random.default_rng(3)
    q, k, v = (torch.tensor(r.standard_normal((B, S, H, D)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        flash_attention_trainable(q, k, v, block_q=32, block_k=32)
    assert sum(saved) <= 5 * B * S * H * D, saved


@pytest.mark.parametrize("name", ["gqa", "window", "kv_len_offset"])
def test_triangle_skip_forward_matches_jax(name):
    case = CASES[name]
    q, k, v, _ = _operands(case, seed=4)
    kw = dict(case[-1])
    got = flash_attention(*(torch.tensor(x) for x in (q, k, v)),
                          triangle_skip=True, **kw)
    want = jflash(*(jnp.asarray(x) for x in (q, k, v)),
                  triangle_skip=True, **kw)
    assert np.abs(got.numpy() - np.asarray(want)).max() < FWD_ABS
    # the skipped blocks are fully masked: the same output as no skip
    plain = flash_attention(*(torch.tensor(x) for x in (q, k, v)), **kw)
    assert torch.equal(got, plain)


def test_lm_apply_triangle_skip_matches_jax():
    """``LM.apply(triangle_skip=True)`` over two 1024-row q blocks: the
    port's logits bitwise its own without the skip (the skipped kv block
    is fully masked) and within rtol = atol = 1e-4 of JAX's
    (tests/test_torch_model.py's float32 bound)."""
    import dataclasses

    from repro.configs.base import get_config as jget_config
    from repro.models import LM as JLM
    from repro_torch.configs.base import get_config
    from repro_torch.models import LM
    from repro_torch.models.convert import params_from_jax
    jcfg = dataclasses.replace(jget_config("tinyllama-1.1b").reduced(),
                               dtype="float32", n_layers=1)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32", n_layers=1)
    jm, tm = JLM(jcfg), LM(cfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 1500))
    got, _ = tm.apply(tp, torch.from_numpy(toks), triangle_skip=True)
    plain, _ = tm.apply(tp, torch.from_numpy(toks))
    assert torch.equal(got, plain)
    want, _ = jm.apply(jp, jnp.asarray(toks), triangle_skip=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
