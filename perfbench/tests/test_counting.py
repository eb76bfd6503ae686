"""The yardstick's counts against hand sums."""
from __future__ import annotations

import math

import pytest

from perfbench import counting, harness
from perfbench.drivers.serve_closed import window_work


def config(name):
    return harness.resolve_cell(name).config


def test_matmul_params_starcoder2_by_hand():
    d, ff, L, V = 4608, 18432, 32, 49152
    per_layer = d * d + 2 * d * 512 + d * d + 2 * d * ff  # q, k+v, o, up+down
    assert counting.matmul_params(config("starcoder2-7b.emulated_eval")) \
        == L * per_layer + V * d == 7_172_259_840


def test_matmul_params_chatglm3_by_hand():
    d, ff, L, V = 4096, 13696, 28, 65024
    per_layer = d * d + 2 * d * 256 + d * d + 3 * d * ff  # swiglu: 3 mats
    assert counting.matmul_params(config("chatglm3-6b.serve_longprompt")) \
        == L * per_layer + V * d


def test_model_flops_and_pairs():
    cfg = config("starcoder2-7b.emulated_eval")
    assert counting.causal_pairs(1) == 1
    assert counting.causal_pairs(2048) == sum(range(1, 2049))
    tokens, pairs = 4096, 2 * counting.causal_pairs(2048)
    want = 2 * 7_172_259_840 * tokens + 4 * 36 * 128 * 32 * pairs
    assert counting.model_flops(cfg, tokens, pairs) == pytest.approx(want,
                                                                     rel=1e-15)


def test_matmul_bound_by_hand():
    # ops-bound: 2 * 4096 * 4608 * 4608 over 989 TFLOP/s
    assert counting.matmul_bound_s(4096, 4608, 4608) == pytest.approx(
        2 * 4096 * 4608 * 4608 / 989e12)
    # bytes-bound at one row: weights read once, bf16
    m, k, n = 1, 4608, 18432
    assert counting.matmul_bound_s(m, k, n) == pytest.approx(
        (2 * m * k + 2 * k * n + 4 * m * n) / 3.35e12)


def test_k1_forward_bound_sums_every_projection():
    cfg = config("chatglm3-6b.serve_longprompt")
    m, d, ff = 4096, 4096, 13696
    shapes = [(d, d), (d, 256), (d, 256), (d, d), (d, ff), (d, ff), (ff, d)]
    want = 28 * sum(counting.matmul_bound_s(m, k, n) for k, n in shapes) \
        + counting.matmul_bound_s(m, d, 65024)
    assert counting.k1_forward_bound_s(cfg, m) == pytest.approx(want)


def test_k1_kernel_names():
    assert counting.is_k1("void (anonymous namespace)::qmm_tile_kernel<"
                          "__nv_bfloat16, __nv_bfloat16>(...)")
    assert counting.is_k1("qmm_fold_kernel")
    assert not counting.is_k1("flash_kernel<float>")
    assert not counting.is_k1("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n")


class Req:
    def __init__(self, uid, prompt_len, out_len):
        self.uid, self.prompt, self.output = uid, [0] * prompt_len, \
            [0] * out_len


def test_window_work_against_a_loop():
    cfg = config("chatglm3-6b.serve_longprompt")
    reqs = [Req(0, 100, 20), Req(1, 7, 3), Req(2, 50, 1), Req(3, 9, 0),
            Req(4, 30, 12)]
    start = {0: 5, 1: 0, 2: 0, 3: 0, 4: 1}
    prompt = decoded = pairs = 0
    for q in reqs:
        P = len(q.prompt)
        for k in range(start[q.uid], len(q.output)):
            if k == 0:  # from the prompt's forward
                prompt, pairs = prompt + P, pairs + P * (P + 1) // 2
            else:  # a decode step over P + k keys
                decoded, pairs = decoded + 1, pairs + P + k
    got = window_work(harness.family(cfg), cfg, reqs, start)
    assert (got["prompt_tokens"], got["decoded_tokens"]) == (prompt, decoded)
    assert math.isclose(got["model_flops"],
                        counting.model_flops(cfg, prompt + decoded, pairs))
