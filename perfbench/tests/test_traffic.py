"""The generator: deterministic per seed, the same work for every seed."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from perfbench import generate, harness


def take(traffic, seed, n, vocab=65024):
    return list(itertools.islice(generate.requests(traffic, seed, vocab), n))


def serve_traffic():
    return harness.resolve_cell("chatglm3-6b.serve_longprompt").traffic


def test_requests_deterministic_per_seed():
    tr = serve_traffic()
    a, b = take(tr, 2**31 + 99, 40), take(tr, 2**31 + 99, 40)
    assert all(np.array_equal(x.prompt, y.prompt)
               and x.max_new_tokens == y.max_new_tokens for x, y in zip(a, b))
    c = take(tr, 2**31 + 100, 40)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


def test_every_seed_brings_the_same_lengths_per_block():
    tr = serve_traffic()
    block = tr["block"]
    for seed in (0, 1, 2**31 + 5, 2**40):
        reqs = take(tr, seed, 3 * block)
        for b in range(3):
            part = reqs[b * block:(b + 1) * block]
            assert sorted(len(q.prompt) for q in part) == list(
                generate.quantiles(tr["prompt_len"], block))
            assert sorted(q.max_new_tokens for q in part) == list(
                generate.quantiles(tr["output_len"], block))


def test_the_order_is_drawn_from_the_seed():
    tr = serve_traffic()
    a, b = take(tr, 1, 48), take(tr, 2**31 + 1, 48)
    assert [len(q.prompt) for q in a] != [len(q.prompt) for q in b]
    assert [q.max_new_tokens for q in a] != [q.max_new_tokens for q in b]
    assert [len(q.prompt) for q in a] == [len(q.prompt)
                                          for q in take(tr, 1, 48)]


def test_lengths_in_range_and_ids_in_vocab():
    tr = serve_traffic()
    for q in take(tr, 3, 64, vocab=1000):
        assert tr["prompt_len"]["lo"] <= len(q.prompt) \
            <= tr["prompt_len"]["hi"]
        assert tr["output_len"]["lo"] <= q.max_new_tokens \
            <= tr["output_len"]["hi"]
        assert q.prompt.min() >= 0 and q.prompt.max() < 1000


def test_quantiles_follow_the_distribution():
    lu = generate.quantiles({"dist": "loguniform", "lo": 512, "hi": 3584}, 16)
    assert lu[0] > 512 and lu[-1] < 3584 and np.all(np.diff(lu) > 0)
    # half the mass below the geometric mean
    assert lu[7] < (512 * 3584) ** 0.5 < lu[8]
    un = generate.quantiles({"dist": "uniform", "lo": 16, "hi": 48}, 16)
    assert un[0] == 17 and un[-1] == 47


def test_token_batches_deterministic():
    a = generate.token_batch(2**31 + 1, 3, 2, 64, 49152, "cpu")
    assert torch.equal(a, generate.token_batch(2**31 + 1, 3, 2, 64, 49152,
                                               "cpu"))
    assert not torch.equal(a, generate.token_batch(2**31 + 1, 4, 2, 64,
                                                   49152, "cpu"))
    assert a.shape == (2, 64) and a.max() < 49152
