"""Deterministic, restart-safe synthetic LM data pipeline (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step, shard): a job that restarts
from step N regenerates the same batches from N, and each data-parallel
shard draws its own stream without coordination.  The distribution is a
Zipf-ish unigram with first-order Markov structure, so losses fall during
smoke training (uniform tokens would pin the cross-entropy at log V).

The batches are JAX's: this module carries a numpy threefry-2x32 with
JAX's ``key``, ``fold_in``, ``split``, ``uniform`` and ``bernoulli`` as
jax 0.9.0 computes them with ``jax_threefry_partitionable`` on (its
default): a key of seed s is (0, s); ``fold_in(key, d)`` hashes the counter
(0, d); ``split`` and the random bits hash the flat index i as the counter
(0, i), and 32 random bits are the two output words xor-ed.  Tokens and
labels are bitwise JAX's.  ``normal`` (the vlm prefix and audio frame
embeddings) is sqrt(2) * erfinv(u) with XLA's single-precision inverse
error function (M. Giles' polynomial), whose steps XLA:CPU contracts into
fused multiply-adds; the port does the same in numpy, but its ``log1p`` is
numpy's, not XLA's, so the draws sit within a few float32 ulps of JAX's
(tests/test_torch_data.py states the bound).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch._device import resolve_device

U32 = np.uint32


# ---------------------------------------------------------------------------
# threefry-2x32 (20 rounds), as jax.random's default implementation
# ---------------------------------------------------------------------------
def _rotl(x, r):
    return (x << U32(r)) | (x >> U32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 block cipher of key (k1, k2) on counters (x1, x2)
    (uint32 arrays of one shape); returns the two output words."""
    x1 = np.asarray(x1, U32).copy()
    x2 = np.asarray(x2, U32).copy()
    ks = (U32(k1), U32(k2), U32(k1) ^ U32(k2) ^ U32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x1 += ks[0]
        x2 += ks[1]
        for i in range(5):
            for r in rotations[i % 2]:
                x1 += x2
                x2 = _rotl(x2, r) ^ x1
            x1 += ks[(i + 1) % 3]
            x2 += ks[(i + 2) % 3] + U32(i + 1)
    return x1, x2


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data for 0 <= seed < 2**31: (0, seed)."""
    return np.array([0, seed & 0xFFFFFFFF], U32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    o1, o2 = threefry2x32(k[0], k[1], [0], [data & 0xFFFFFFFF])
    return np.array([o1[0], o2[0]], U32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """(num, 2) keys: the flat index i hashed as the counter (0, i)."""
    o1, o2 = threefry2x32(k[0], k[1], np.zeros(num, U32),
                          np.arange(num, dtype=U32))
    return np.stack([o1, o2], axis=1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element of ``shape`` (fewer than 2**32)."""
    n = int(np.prod(shape))
    o1, o2 = threefry2x32(k[0], k[1], np.zeros(n, U32),
                          np.arange(n, dtype=U32))
    return (o1 ^ o2).reshape(shape)


def uniform(k: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """float32 in [minval, maxval): 23 random mantissa bits under 1.0's
    exponent, minus 1, scaled and shifted."""
    bits = random_bits(k, shape)
    f = ((bits >> U32(9)) | U32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, f * (hi - lo) + lo)


def bernoulli(k: np.ndarray, p: float, shape) -> np.ndarray:
    return uniform(k, shape) < np.float32(p)


# XLA's ErfInv for float32 (M. Giles, "Approximating the erfinv function")
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    x = np.asarray(x, f32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x).astype(f32)
        lt = w < f32(5.0)
        w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
        p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
        w64 = w.astype(np.float64)
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            # a fused multiply-add: the f32 product is exact in float64
            p = (np.where(lt, f32(a), f32(b)).astype(np.float64)
                 + p.astype(np.float64) * w64).astype(f32)
        out = (p * x).astype(f32)
    return np.where(np.abs(x) == f32(1.0), x * np.finfo(f32).max, out)


def normal(k: np.ndarray, shape) -> np.ndarray:
    """Standard normal float32: sqrt(2) * erfinv(u), u uniform on
    (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(k, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erf_inv(u)).astype(np.float32)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard_id: int = 0
    prefix_tokens: int = 0  # vlm prefix embeddings
    d_model: int = 0
    frame_embeds: bool = False  # audio stub


def _batch_keys(cfg: DataConfig, step: int) -> np.ndarray:
    k = fold_in(fold_in(key(cfg.seed), step), cfg.shard_id)
    return split(k, 4)


def _markov_tokens(k, shape, vocab: int) -> np.ndarray:
    """Zipf unigram + first-order structure: t_{i+1} depends on t_i."""
    k1, k2 = split(k)
    u = uniform(k1, shape)
    base = (u * u * np.float32(vocab - 1)).astype(np.int32)
    # half the positions copy-shift their predecessor (+1 mod V)
    flip = bernoulli(k2, 0.5, shape)
    shifted = np.roll(base, 1, axis=-1)
    return np.where(flip, (shifted + 1) % np.int32(vocab), base)


def make_batch(cfg: DataConfig, step: int, device=None
               ) -> Dict[str, torch.Tensor]:
    """The batch of ``step`` for this shard: int32 ``tokens``/``labels``
    (B, seq_len), plus float32 ``prefix_embeds`` (vlm) or ``frame_embeds``
    in place of the tokens (audio), as tensors on ``device`` (default
    CUDA)."""
    dev = resolve_device(device)
    ks = _batch_keys(cfg, step)
    b = cfg.global_batch // cfg.n_shards
    toks = _markov_tokens(ks[0], (b, cfg.seq_len + 1), cfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.prefix_tokens:
        batch["prefix_embeds"] = normal(
            ks[1], (b, cfg.prefix_tokens, cfg.d_model))
    if cfg.frame_embeds:
        batch["frame_embeds"] = normal(ks[2], (b, cfg.seq_len, cfg.d_model))
        del batch["tokens"]
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def data_iterator(cfg: DataConfig, device=None):
    """step -> batch callable (the restart-safe interface ``train_loop``
    uses)."""
    dev = resolve_device(device)

    def get(step: int):
        return make_batch(cfg, step, dev)
    return get


def for_arch(arch_cfg, seq_len: int, global_batch: int, *, seed: int = 0,
             n_shards: int = 1, shard_id: int = 0) -> DataConfig:
    """The pipeline for one architecture: the vlm family's prefix counts
    toward ``seq_len``, the audio family draws frames."""
    prefix = arch_cfg.n_prefix_tokens if arch_cfg.frontend == "vision" else 0
    return DataConfig(
        vocab_size=arch_cfg.vocab_size,
        seq_len=seq_len - prefix,
        global_batch=global_batch, seed=seed,
        n_shards=n_shards, shard_id=shard_id,
        prefix_tokens=prefix, d_model=arch_cfg.d_model,
        frame_embeds=arch_cfg.frontend == "audio")
