"""DeepSeek-V2-Lite in the port (multi-head latent attention, YaRN RoPE, a
leading dense layer, dropless routed experts), held to the benchmark's
plain float32 reference ``perfbench/reference/deepseek_v2.py``.

The JAX package has no MLA, so the reference is the benchmark's.  Weights
are the benchmark's own (``perfbench/families/deepseek_v2.make_weights``,
seeded) at a small V2-Lite-shaped size: 3 layers (1 dense), 8 routed
experts top-2 with 1 shared, ``kv_lora_rank`` 32, rope 16, nope 32, v 32,
vocabulary 256, float32 throughout; YaRN keeps its published numbers.

Tolerances:
  * logits within 1e-5 x max |reference logit|: both compute in float32,
    and only the order of the sums differs (the blockwise online softmax,
    the absorbed products, the experts' padded rows); the port reads 1.1e-6
    here, and the reference's own float8_e4m3fn control departs by ~0.3,
    so the bound is tight enough to tell a lower precision;
  * a dropless token's output alone, beside other tokens and beside
    padding: the same picks, bit for bit, and outputs within 1e-5 x max
    |out|, the matmuls' blocking by shape (a BLAS product's row depends at
    the last bit on how many rows it has, as in any batched layer); the
    capacity path, given the same tokens, drops picks and moves a token's
    output by a share of its size.
"""
from __future__ import annotations

import ast
import json
import math
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.families import deepseek_v2 as fam  # noqa: E402
from perfbench.reference import deepseek_v2 as ref  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import mla, moe  # noqa: E402
from repro_torch.models.layers import yarn_frequencies  # noqa: E402
from repro_torch.models.model import DecodeCache  # noqa: E402

CPU = torch.device("cpu")
FILE = ROOT / "perfbench" / "configs" / "deepseek-v2-lite.json"
SMALL = dict(hidden_size=64, num_hidden_layers=3, first_k_dense_replace=1,
             num_attention_heads=4, num_key_value_heads=4,
             intermediate_size=96, moe_intermediate_size=32,
             n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
             kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=32,
             v_head_dim=32, vocab_size=256, dtype="float32",
             kv_cache_dtype="float32")
TOL = 1e-5


def published():
    return json.loads(FILE.read_text())


@pytest.fixture(scope="module")
def small():
    """(file config, port LM, weights) at the small size."""
    cfg = published()
    cfg.update(SMALL)
    return cfg, fam.program(cfg, CPU), fam.make_weights(cfg, 7, CPU)


def tokens(B, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, SMALL["vocab_size"], (B, S), generator=g)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# ------------------------------------------------------------- the model
def test_apply_matches_the_reference(small):
    cfg, model, w = small
    toks = tokens(2, 40)
    with torch.no_grad():
        got, _ = model.apply(w, toks)
        want = ref.reference_logits(cfg, w, toks)
    assert rel(got[..., :cfg["vocab_size"]], want) < TOL
    assert rel(ref.reference_logits(cfg, w, toks, fp8=True), want) > 10 * TOL


def test_prefill_and_absorbed_decode_match_the_full_forward(small):
    """``prefill_batched`` on two bucket-padded prompts writes the latent
    cache; ``decode_scan`` decodes greedily through it (absorbed); the
    reference's full forward over prompt + served tokens (expanded) puts
    each served token first, and ``decode_step``'s logits, teacher-forced,
    are its logits."""
    cfg, model, w = small
    lens, bucket, n = [13, 20], 32, 6
    prompts = tokens(2, 20, seed=1)
    padded = torch.zeros((2, bucket), dtype=torch.int64)
    for j, P in enumerate(lens):
        padded[j, :P] = prompts[j, :P]
    true_lens = torch.tensor(lens)
    with torch.no_grad():
        last, kv, states = model.prefill_batched(w, padded, true_lens)
        assert states is None and len(kv) == 1
        assert kv[0].shape == (3, 2, bucket, 32 + 16)
        cache = model.init_cache(2, bucket + n)
        assert set(cache.data) == {"latent"}
        cache.data["latent"][:, :, :bucket] = kv[0]
        snapshot = cache.data["latent"].clone()
        first = last.argmax(-1)
        _, _, _, _, toks, emitted = model.decode_scan(
            w, DecodeCache(cache.data, true_lens.clone()), first[:, None],
            torch.ones(2, dtype=torch.bool), torch.full((2,), n), n)
        assert emitted.all()
        for j, P in enumerate(lens):
            seq = torch.cat([prompts[j, :P], first[j:j + 1], toks[:-1, j]])
            want = ref.reference_logits(cfg, w, seq[None])[0, P - 1:]
            served = torch.cat([first[j:j + 1], toks[:, j]])
            assert torch.equal(want.argmax(-1), served)
            assert rel(last[j, :cfg["vocab_size"]], want[0]) < TOL
            # teacher-forced decode steps over a fresh copy of the cache
            data = {"latent": snapshot.clone()}
            length = true_lens.clone()
            for k in range(n):
                logits, _ = model.decode_step(
                    w, DecodeCache(data, length), served[None, k].expand(
                        2, 1).contiguous(),
                    write_mask=torch.arange(2) == j)
                length = length + (torch.arange(2) == j)
                assert rel(logits[j, 0, :cfg["vocab_size"]], want[k + 1]) \
                    < TOL


# ------------------------------------------------------ dropless routing
def layer_moe(w):
    """Layer 1's (the first MoE layer's) expert parameters."""
    m = w["layers"]["moe"]
    return {k: v[0] if not isinstance(v, dict) else
            {kk: vv[0] for kk, vv in v.items()} for k, v in m.items()}


@pytest.mark.parametrize("others,chunk", [(39, None), (299, None),
                                          (299, 64)])
def test_a_dropless_token_does_not_depend_on_the_call(small, monkeypatch,
                                                      others, chunk):
    """Alone, beside ``others`` tokens (both sides of ``PAD_ALL_TOKENS``,
    and routed in chunks of ``chunk``) and beside zero padding, a token
    gets the same picks and the same output; the capacity path drops picks
    beside the same tokens."""
    if chunk:
        monkeypatch.setattr(moe, "DROPLESS_CHUNK_TOKENS", chunk)
    _, _, w = small
    p = layer_moe(w)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, others + 1, 64, generator=g)
    last = x[:, -1:]
    kw = dict(top_k=2, norm_topk=False)
    with torch.no_grad():
        alone, _ = moe.moe_apply(p, last, dropless=True, **kw)
        beside, aux = moe.moe_apply(p, x, dropless=True, **kw)
        padded, _ = moe.moe_apply(p, torch.cat([last, torch.zeros(
            1, 7, 64)], 1), dropless=True, **kw)
        assert float(aux["dropped_frac"]) == 0.0
        picks = [moe.pick(p["router"], t.reshape(-1, 64), **kw)[1][-1]
                 for t in (last, x)]
        assert torch.equal(picks[0], picks[1])
        for out in (beside[:, -1], padded[:, 0]):
            assert rel(out, alone[:, 0]) < TOL
        # every token to expert 0 first: the capacity path drops the last
        # token's pick beside the others
        sk = dict(p, router=p["router"].clone())
        sk["router"][:, 0] = 0.0
        sk["router"][0, 0] = 5.0
        xs = x.clone()
        xs[..., 0] = 10.0
        cap_alone, _ = moe.moe_apply(sk, xs[:, -1:], capacity_factor=1.25,
                                     **kw)
        cap_beside, caux = moe.moe_apply(sk, xs, capacity_factor=1.25, **kw)
        drop_alone, _ = moe.moe_apply(sk, xs[:, -1:], dropless=True, **kw)
        drop_beside, _ = moe.moe_apply(sk, xs, dropless=True, **kw)
    assert float(caux["dropped_frac"]) > 0
    assert rel(cap_beside[:, -1], cap_alone[:, 0]) > 1e-2
    assert rel(drop_beside[:, -1], drop_alone[:, 0]) < TOL


def test_dropless_weights_are_not_renormalised(small):
    """The output is the shared experts plus each pick's expert output
    times its softmax probability, unrenormalised, times the scaling."""
    _, _, w = small
    p = layer_moe(w)
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        probs, top_i, top_w = moe.pick(p["router"], x, top_k=2,
                                       norm_topk=False, scaling=1.5)
        assert torch.equal(top_w, probs.gather(1, top_i) * 1.5)
        assert (top_w.sum(-1) < 1.5 * (1 - 1e-3)).all()
        out, _ = moe.moe_apply(p, x[None], top_k=2, norm_topk=False,
                               scaling=1.5, dropless=True)
        want = moe._shared_ffn(p["shared"], x)
        for t in range(5):
            for i in range(2):
                e = int(top_i[t, i])
                xe = x[t:t + 1]
                h = torch.nn.functional.silu(xe @ p["w_gate"][e]) \
                    * (xe @ p["w_up"][e])
                want[t] += top_w[t, i] * (h @ p["w_down"][e])[0]
    assert rel(out[0], want) < TOL


# ------------------------------------------------------ published numbers
def test_yarn_ramp_and_softmax_scale_at_the_published_sizes():
    cfg = get_config("deepseek-v2-lite")
    inv = yarn_frequencies(64, 10000.0, 40.0, 4096, 32.0, 1.0, CPU)
    f = 1.0 / 10000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    i = torch.arange(32, dtype=torch.float32)
    ramp = ((i - 10) / 13).clamp(0, 1)
    assert torch.equal(inv[:11], f[:11])
    assert torch.allclose(inv[23:], f[23:] / 40, rtol=1e-6, atol=0)
    assert torch.allclose(inv, f * (1 - ramp) + f / 40 * ramp, rtol=1e-6,
                          atol=0)
    ends = [64 * math.log(4096 / (b * 2 * math.pi)) / (2 * math.log(1e4))
            for b in (32, 1)]
    assert (math.floor(ends[0]), math.ceil(ends[1])) == (10, 23)
    assert mla.softmax_scale(cfg) == pytest.approx(0.114721, abs=5e-7)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m * m == pytest.approx(1.58963, abs=5e-6)
    pub = published()
    assert torch.allclose(ref.rope_frequencies(pub, CPU), inv, rtol=1e-6,
                          atol=0)
    assert ref.softmax_scale(pub) == pytest.approx(mla.softmax_scale(cfg),
                                                   rel=1e-12)
    assert mla.rope_tables(cfg, CPU)[1] == 1.0


def test_parameter_counts_by_hand():
    """15,706,484,224 parameters in all (untied head and final norm
    included) and 2,451,308,544 matmul parameters a token."""
    d, V, H, L = 2048, 102400, 16, 27
    attn = d * H * 192 + d * 576 + 512 * H * 256 + H * 128 * d
    norms = 2 * d + 512
    dense = 3 * d * 10944
    routed, shared, router = 64 * 3 * d * 1408, 3 * d * 2816, d * 64
    total = 2 * V * d + L * (attn + norms) + dense \
        + 26 * (routed + shared + router) + d
    assert get_config("deepseek-v2-lite").param_count() == total \
        == 15_706_484_224
    active = L * attn + dense + 26 * (6 * 3 * d * 1408 + shared + router) \
        + V * d
    assert fam.matmul_params(published()) == active == 2_451_308_544
    assert fam.model_flops(published(), 1, 1) == 2 * active + 10_240 * L


def test_registered_outside_the_jax_parity_set():
    assert "deepseek-v2-lite" not in ARCH_IDS
    cfg = get_config("deepseek-v2-lite")
    assert cfg.family == "moe" and cfg.is_mla and cfg.moe_dropless


def test_the_reference_imports_nothing_of_the_program():
    path = ROOT / "perfbench" / "reference" / "deepseek_v2.py"
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & {"repro_torch", "repro", "jax"}
    assert tops <= {"__future__", "math", "typing", "torch", "perfbench"}
