"""The port's data pipeline against the JAX package's.

Tolerances: the threefry keys, splits and uniform bits, and every batch's
``tokens`` and ``labels``, bitwise, over several (seed, step, shard)
values.  The vlm prefix and audio frame embeddings are
``jax.random.normal`` draws: the same uniforms through XLA's float32
inverse error function, which the port carries, but with numpy's ``log1p``
in place of XLA's, so they are held within 4 float32 ulps (the CPU
reads at most 3, and about 99% equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config as jget_config
from repro.data import pipeline as jdata
from repro_torch.configs.base import get_config
from repro_torch.data import pipeline as tdata

NORMAL_ULPS = 4


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_threefry_keys_match_jax():
    for seed in (0, 3, 12345, 2 ** 31 - 1):
        k = jax.random.key(seed)
        assert np.array_equal(jax.random.key_data(k), tdata.key(seed))
        for d in (0, 7, 123456):
            kj = jax.random.fold_in(k, d)
            kt = tdata.fold_in(tdata.key(seed), d)
            assert np.array_equal(jax.random.key_data(kj), kt)
            for n in (2, 4, 5):
                assert np.array_equal(
                    jax.random.key_data(jax.random.split(kj, n)),
                    tdata.split(kt, n))
            shape = (3, 37)
            assert np.array_equal(
                np.asarray(jax.random.uniform(kj, shape)),
                tdata.uniform(kt, shape))
            assert np.array_equal(
                np.asarray(jax.random.bernoulli(kj, 0.5, shape)),
                tdata.bernoulli(kt, 0.5, shape))


@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (0, 0, 0, 1), (3, 7, 0, 1), (3, 7, 1, 2), (11, 123456, 3, 4)])
def test_batches_match_jax(seed, step, shard, n_shards):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=8, seed=seed,
              n_shards=n_shards, shard_id=shard)
    want = jdata.make_batch(jdata.DataConfig(**kw), step)
    got = tdata.make_batch(tdata.DataConfig(**kw), step, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype) == "torch.int32"
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-large",
                                  "tinyllama-1.1b"])
def test_for_arch_batches_match_jax(arch):
    jd = jdata.for_arch(jget_config(arch).reduced(), seq_len=32,
                        global_batch=4, seed=2)
    td = tdata.for_arch(get_config(arch).reduced(), seq_len=32,
                        global_batch=4, seed=2)
    assert vars(jd) == vars(td)
    for step in (0, 5):
        want = jdata.make_batch(jd, step)
        got = tdata.make_batch(td, step, device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            a, b = np.asarray(want[k]), got[k].numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if a.dtype == np.float32:
                assert _ulps(a, b).max() <= NORMAL_ULPS, k
            else:
                assert np.array_equal(a, b), k


def test_normal_within_ulps_of_jax():
    k = jax.random.key(1)
    want = np.asarray(jax.random.normal(k, (200_000,), jnp.float32))
    got = tdata.normal(tdata.key(1), (200_000,))
    u = _ulps(want, got)
    assert u.max() <= NORMAL_ULPS
    assert (u == 0).mean() > 0.95
