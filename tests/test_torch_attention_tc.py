"""The tensor-core attention kernel (``kernels.attention_tc``), its routing
in ``models.attention.flash_attention`` and the benchmark's readers of its
``attn`` scopes.

On the CPU: the routing predicate, a CPU call still running
``flash_blocks`` bit for bit with its ``attn`` scope, the wrapper's
refusals, and the four readers on synthetic scopes.  On the card (marked
``cuda``; this file imports no JAX, so it runs on the card's machine):

    python -m pytest -q -m cuda tests/test_torch_attention_tc.py

the kernel against its plain version ``attention.attention_blocks`` at the
benchmark cells' shapes and on ragged, offset, windowed, fp16 and strided
operands.

Tolerance: ``attention_tc.agreement_bound``, whose docstring gives its
reason.  Both sides round p to the operands' type against different
running maxima (rescales every 64 keys against every 1024), so about a
third of the outputs differ by an ulp or more; a bound of 2 ulps at the
larger of the element and 2^-6 of its row's max |output| fails on about
5% of them (by up to 23 times) at the cells' shapes on the card.
"""
from __future__ import annotations

import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch.kernels import attention_tc as tc
from repro_torch.kernels._build import NoBackwardError
from repro_torch.models import attention

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BF16, FP16, F32 = torch.bfloat16, torch.float16, torch.float32


# ------------------------------------------------------------- the routing
def _operand(device, dtype, width, grad):
    """What ``kernel_takes`` reads of a tensor (device, dtype, shape and
    requires_grad), for devices this machine may lack."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           shape=(1, 8, 2, width), requires_grad=grad)


@pytest.mark.parametrize("grad", ["off", "on", "on_no_input"])
@pytest.mark.parametrize("widths", [(128, 128), (192, 128), (64, 64),
                                    (256, 256), (16, 48), (120, 128),
                                    (128, 272)],
                         ids=lambda w: f"D{w[0]}_Dv{w[1]}")
@pytest.mark.parametrize("dtype", [BF16, FP16, F32], ids=str)
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_routing_predicate(device, dtype, widths, grad):
    """The kernel runs exactly where the operands are CUDA tensors of one
    16-bit type, D and Dv are multiples of 16 up to 256, and autograd does
    not need the result."""
    D, Dv = widths
    needs = grad == "on"
    q = _operand(device, dtype, D, needs)
    k = _operand(device, dtype, D, False)
    v = _operand(device, dtype, Dv, False)
    with torch.set_grad_enabled(grad != "off"):
        got = tc.kernel_takes(q, k, v)
    want = (device == "cuda" and dtype in (BF16, FP16)
            and D % 16 == 0 and Dv % 16 == 0 and max(D, Dv) <= 256
            and not needs)
    assert got is want


def test_routing_needs_one_type():
    q = _operand("cuda", BF16, 128, False)
    for other in (FP16, F32):
        assert not tc.kernel_takes(q, _operand("cuda", other, 128, False), q)
        assert not tc.kernel_takes(q, q, _operand("cuda", other, 128, False))


def _operands(B, Sq, Sk, Hq, Hkv, D, Dv, dtype, device="cpu", seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(B, S, H, W, generator=g).to(dtype).to(device)
               for S, H, W in ((Sq, Hq, D), (Sk, Hkv, D), (Sk, Hkv, Dv)))
    return q, k, v


CPU_CASES = {
    "causal_gqa": (dict(B=2, Sq=40, Sk=40, Hq=4, Hkv=2, D=16, Dv=16), {}),
    "mla_widths": (dict(B=1, Sq=24, Sk=24, Hq=2, Hkv=2, D=48, Dv=32),
                   dict(scale=0.1)),
    "offset_kv_len": (dict(B=1, Sq=9, Sk=30, Hq=2, Hkv=1, D=16, Dv=16),
                      dict(q_offset=21, kv_len=27, window=8)),
}


@pytest.mark.filterwarnings("ignore:.*Profiler clears events:UserWarning")
@pytest.mark.parametrize("dtype", [BF16, F32], ids=str)
@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_call_runs_flash_blocks_bitwise(case, dtype):
    """On the CPU ``flash_attention`` is ``flash_blocks`` bit for bit,
    launches nothing, and records one ``attn`` scope with path "blocks"."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import telemetry as tel
    shape, kw = CPU_CASES[case]
    q, k, v = _operands(**shape, dtype=dtype)
    kw = dict(dict(causal=True, window=0, q_offset=0, kv_len=None), **kw)
    before = tc.flash_attention_tc.launches
    with profile(activities=[ProfilerActivity.CPU]):
        got = attention.flash_attention(q, k, v, block_q=16, block_k=8,
                                        **kw)
    scale = kw.pop("scale", 1.0 / math.sqrt(shape["D"]))
    kv_len = shape["Sk"] if kw["kv_len"] is None else kw["kv_len"]
    qb, kb, vb, _, _ = attention._blocks(q, k, v, 16, 8)
    want = attention.unblock(attention.flash_blocks(
        qb, kb, vb, scale=scale, causal=kw["causal"], window=kw["window"],
        kv_len=kv_len, q_offset=kw["q_offset"]), shape["Sq"], dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert tc.flash_attention_tc.launches == before
    (sc,) = tel.profiled_session().scopes_named("attn")
    assert sc.attrs == {"path": "blocks", "positions": shape["B"] *
                        shape["Sq"], "heads": shape["Hq"], "d": shape["D"],
                        "dv": shape["Dv"]}
    assert sc.device_s is None


def test_wrapper_refuses_what_it_does_not_take():
    q, k, v = _operands(1, 32, 32, 4, 2, 64, 64, BF16)
    run = tc.flash_attention_tc
    with pytest.raises(ValueError, match="one CUDA device"):
        run(q, k, v, scale=0.125)
    with pytest.raises(TypeError, match="one type"):
        run(q, k.float(), v, scale=0.125)
    with pytest.raises(TypeError, match="one type"):
        run(q.float(), k.float(), v.float(), scale=0.125)
    with pytest.raises(ValueError, match="4-d"):
        run(q[0], k, v, scale=0.125)
    with pytest.raises(ValueError, match="do not match"):
        run(q, k[:, :16], v, scale=0.125)
    with pytest.raises(ValueError, match="q heads over"):
        run(q, k[:, :, :1].expand(1, 32, 3, 64), v[:, :, :1].expand(
            1, 32, 3, 64), scale=0.125)
    w = _operands(1, 32, 32, 4, 2, 72, 272, BF16)
    with pytest.raises(ValueError, match="D a multiple of 16"):
        run(*w, scale=0.125)
    with pytest.raises(ValueError, match="Dv a multiple of 16"):
        run(q, k, w[2], scale=0.125)
    with pytest.raises(ValueError, match="kv_len 33"):
        run(q, k, v, scale=0.125, kv_len=33)
    with pytest.raises(ValueError, match="window -1"):
        run(q, k, v, scale=0.125, window=-1)
    with pytest.raises(ValueError, match="last dimension"):
        run(q, k.transpose(2, 3).contiguous().transpose(2, 3), v,
            scale=0.125)
    wide = torch.zeros(1, 32, 2, 72, dtype=BF16)
    with pytest.raises(ValueError, match="16 bytes"):
        run(q, k, wide[..., 4:68], scale=0.125)


# -------------------------------------------------- the benchmark's readers
def _reader(name):
    from perfbench import harness
    return harness.metric_reader(name)


READERS = ("attn_ms_per_ktok.eval", "attn_kernel_share.eval",
           "attn_ms_per_ktok.serve", "attn_kernel_share.serve")


def _scope(name, start_s, device_s, **attrs):
    return SimpleNamespace(name=name, start_ns=int(start_s * 1e9),
                           end_ns=int((start_s + 0.01) * 1e9),
                           device_s=device_s, attrs=attrs)


def _session(monkeypatch, scopes):
    import repro_torch.telemetry as tel
    monkeypatch.setattr(tel, "profiled_session",
                        lambda: SimpleNamespace(scopes=scopes))


#: a warm-up scope at 0 s, then the window's: 3 ms over 8192 positions, of
#: which 6144 took the kernel; the serving window (10 s) leaves the first
SCOPES = [
    _scope("attn", 0.0, 0.005, path="blocks", positions=1024),
    _scope("attn", 20.0, 0.001, path="kernel", positions=4096),
    _scope("attn", 21.0, 0.0015, path="kernel", positions=2048),
    _scope("attn", 22.0, 0.0005, path="blocks", positions=2048),
    _scope("serve.prefill", 29.0, 0.2, real_tokens=5),
]


@pytest.mark.parametrize("name", READERS)
def test_attn_readers_on_synthetic_scopes(name, monkeypatch):
    _session(monkeypatch, SCOPES)
    got = _reader(name)({"window_s": 10.0})
    if name.endswith(".serve"):  # the warm-up scope lies before the window
        want = {"attn_ms_per_ktok": 1e3 * 0.003 / 8.192,
                "attn_kernel_share": 75.0}
    else:
        want = {"attn_ms_per_ktok": 1e3 * 0.008 / 9.216,
                "attn_kernel_share": 100.0 * 6144 / 9216}
    assert got == pytest.approx(want[name.rsplit(".", 1)[0]], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_attn_readers_read_nothing_without_the_scope(name, monkeypatch):
    import repro_torch.telemetry as tel
    record = {"window_s": 10.0}
    monkeypatch.delattr(tel, "profiled_session")
    assert _reader(name)(record) is None  # a program without scopes
    monkeypatch.setattr(tel, "profiled_session", lambda: None,
                        raising=False)
    assert _reader(name)(record) is None  # nothing profiled
    _session(monkeypatch, [s for s in SCOPES if s.name != "attn"])
    assert _reader(name)(record) is None  # a tree without ``attn``
    if "_ms_" in name:  # scopes without device times (a CPU run)
        _session(monkeypatch, [_scope("attn", 25.0, None, path="blocks",
                                      positions=64)])
        assert _reader(name)(record) is None


# ----------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32  # the plain products
    return torch.device("cuda")


def check_against_plain(q, k, v, **kw):
    """The kernel and the plain version on the same operands: the kernel
    launched once, the output's shape and type, and the bound."""
    before = tc.flash_attention_tc.launches
    got = attention.flash_attention(q, k, v, **kw)
    assert tc.flash_attention_tc.launches == before + 1
    kw = dict(dict(causal=True, window=0, q_offset=0, kv_len=k.shape[1]),
              **kw)
    kw["scale"] = kw.get("scale") or 1.0 / math.sqrt(q.shape[-1])
    want = attention.attention_blocks(q, k, v, **kw)
    a_mean = attention.attention_blocks(q.float(), k.float(),
                                        v.float().abs(), **kw)
    assert got.shape == want.shape and got.dtype == q.dtype
    err = (got.float() - want.float()).abs()
    tol = tc.agreement_bound(got, want, a_mean, k.shape[1])
    assert torch.isfinite(got).all()
    assert (err <= tol).all(), (float((err / tol).max()),
                                float(err.max()))
    return float((err / tol).max())


#: (B, Sq, Sk, Hq, Hkv, D, Dv, type, keywords): the four cells' shapes,
#: then ragged, offset, masked, windowed, fp16 and padded widths
CARD_CASES = {
    "starcoder2_eval": (2, 2048, 2048, 36, 4, 128, 128, BF16, {}),
    "chatglm3_4096": (1, 4096, 4096, 32, 2, 128, 128, BF16, {}),
    "chatglm3_2048": (2, 2048, 2048, 32, 2, 128, 128, BF16, {}),
    "chatglm3_1024": (4, 1024, 1024, 32, 2, 128, 128, BF16, {}),
    "ragged_gqa": (2, 300, 300, 8, 2, 64, 64, BF16, {}),
    "q_offset": (1, 77, 333, 8, 8, 128, 128, BF16, dict(q_offset=256)),
    "kv_len_full": (2, 200, 256, 4, 1, 128, 128, BF16,
                    dict(causal=False, kv_len=150)),
    "window": (1, 500, 500, 6, 3, 64, 64, BF16, dict(window=100)),
    "fp16": (2, 384, 384, 8, 8, 128, 128, FP16, {}),
    "widths_80_48": (1, 130, 130, 4, 2, 80, 48, BF16, {}),
    "widths_256": (1, 200, 200, 4, 4, 256, 256, BF16, {}),
    "widths_160_96": (1, 150, 150, 4, 4, 160, 96, BF16, {}),
    "decode_row": (3, 1, 1000, 8, 2, 128, 128, BF16, dict(q_offset=999)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_version(card, case):
    B, Sq, Sk, Hq, Hkv, D, Dv, dt, kw = CARD_CASES[case]
    q, k, v = _operands(B, Sq, Sk, Hq, Hkv, D, Dv, dt, card, seed=len(case))
    with torch.no_grad():
        check_against_plain(q, k, v, **kw)


@pytest.mark.cuda
def test_kernel_matches_plain_version_mla(card):
    """DeepSeek-V2-Lite's expanded prefill: q·k over 192, v over 128 read
    as the strided view ``kv[..., 128:]`` with no copy, its YaRN
    softmax scale."""
    from repro_torch.configs.deepseek_v2_lite import CONFIG
    from repro_torch.models.mla import softmax_scale
    q, k, kv = _operands(2, 4096, 4096, 16, 16, 192, 256, BF16, card,
                         seed=5)
    v = kv[..., 128:]
    assert not v.is_contiguous()
    with torch.no_grad():
        check_against_plain(q, k, v, scale=softmax_scale(CONFIG))


@pytest.mark.cuda
def test_kernel_reads_strided_heads(card):
    """q, k and v as head slices of wider tensors (every stride but the
    last one above its shape's)."""
    q, k, v = _operands(2, 260, 260, 12, 6, 128, 128, BF16, card, seed=9)
    qs, ks, vs = q[:, :, ::2], k[:, :, 2:5], v[:, :, 1:4]
    with torch.no_grad():
        check_against_plain(qs, ks, vs)


@pytest.mark.cuda
def test_row_attending_nothing_gives_zero(card):
    """kv_len 0 leaves every row without a key, and a window with a
    causal offset leaves none either: the output is 0 (the kernel visits
    no tile, so the v planted with NaN past kv_len is never read)."""
    q, k, v = _operands(2, 70, 128, 4, 2, 64, 64, BF16, card, seed=3)
    v[:, 1:] = float("nan")
    with torch.no_grad():
        got = attention.flash_attention(q, k, v, causal=False, kv_len=0)
    assert torch.equal(got, torch.zeros_like(got))
    # every key of the row lies before its window: rows past 64 + 16
    q, k, v = _operands(1, 64, 64, 2, 2, 64, 64, BF16, card, seed=4)
    with torch.no_grad():
        got = attention.flash_attention(q, k, v, q_offset=100, window=16)
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
def test_launch_counter_and_refusals_on_the_card(card):
    q, k, v = _operands(1, 64, 64, 4, 2, 64, 64, BF16, card)
    before = tc.flash_attention_tc.launches
    with torch.no_grad():
        attention.flash_attention(q, k, v)
        attention.flash_attention(q, k, v, causal=False)
    assert tc.flash_attention_tc.launches == before + 2
    # blockwise: f32 operands, and a graph that autograd needs
    attention.flash_attention(q.float(), k.float(), v.float())
    qg = q.clone().requires_grad_()
    out = attention.flash_attention(qg, k, v)
    assert out.grad_fn is not None
    assert tc.flash_attention_tc.launches == before + 2
    with pytest.raises(NoBackwardError):
        tc.flash_attention_tc(qg, k, v, scale=0.125)
    wide = torch.zeros(1, 64, 2, 72, dtype=BF16, device=card)
    with pytest.raises(ValueError, match="16 bytes"):
        tc.flash_attention_tc(q, k, wide[..., 4:68], scale=0.125)


@pytest.mark.cuda
def test_kernel_is_deterministic_and_timed(card):
    """Two calls on the same operands give the same bits; the kernel at
    chatglm3's 4096-position prefill takes under 5 ms (the eager blockwise
    path takes about 9 ms a layer)."""
    q, k, v = _operands(1, 4096, 4096, 32, 2, 128, 128, BF16, card, seed=1)
    with torch.no_grad():
        a = attention.flash_attention(q, k, v)
        b = attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert (time.perf_counter() - t0) / 5 < 5e-3
