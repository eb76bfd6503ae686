"""The one general traffic generator: every mix is a data file of
parameters that these functions read.

Lengths are drawn by strata: each block of ``block`` requests holds the
same lengths (the distribution's quantiles at (i + 0.5) / block), so
every seed brings the same work; the order of the lengths in each block
and the token ids are drawn from the run's seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np

MASK64 = (1 << 64) - 1


def seed_seq(*keys: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([k & MASK64 for k in keys])


def torch_seed(*keys: int) -> int:
    """A 64-bit seed for a ``torch.Generator`` from ``keys``."""
    return int(seed_seq(*keys).generate_state(1, np.uint64)[0])


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` whole lengths at the quantiles (i + 0.5) / n of ``dist``:
    ``{"dist": "uniform" | "loguniform", "lo": a, "hi": b}`` over [a, b]."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


@dataclasses.dataclass
class Request:
    index: int
    prompt: np.ndarray
    max_new_tokens: int


def requests(traffic: dict, seed: int, vocab: int) -> Iterator[Request]:
    """The mix's requests in order, without end: ``prompt_len`` and
    ``output_len`` are length distributions, ``block`` the stratum: every
    block holds the same lengths, in an order drawn from ``seed``, as are
    the token ids."""
    block = int(traffic["block"])
    p_len = quantiles(traffic["prompt_len"], block)
    o_len = quantiles(traffic["output_len"], block)
    b = 0
    while True:
        order = np.random.default_rng(seed_seq(seed, 6, b))
        pp, oo = order.permutation(p_len), order.permutation(o_len)
        ids = np.random.default_rng(seed_seq(seed, 1, b))
        for j in range(block):
            yield Request(b * block + j,
                          ids.integers(0, vocab, int(pp[j]), dtype=np.int64),
                          int(oo[j]))
        b += 1


def token_batch(seed: int, index: int, batch: int, length: int, vocab: int,
                device):
    """Batch ``index`` of (batch, length) token ids, drawn on ``device``."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 2, index))
    return torch.randint(0, vocab, (batch, length), generator=g,
                         device=device, dtype=torch.int64)
