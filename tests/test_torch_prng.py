"""paddle_tpu_torch.prng against jax.random (threefry2x32, partitionable
bits), on the CPU.

Keys of `prng_key`/`fold_in`/`split`, the bits of `random_bits32` and of
`uniform` are bit-identical to jax.random's for seeds at the int32 edges,
negative seeds and seeds past 2**32; `categorical` picks the token
`jax.random.categorical` picks, per row with per-row keys (the serving
engine's vmap) and over a whole batch with one key (run_generate's). The
Gumbel values themselves may differ by an ulp (torch.log against XLA's
log), which can flip a draw only at such a tie: none of these draws
is one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import prng

_SEEDS = (0, 1, 42, 2 ** 31 - 1, 2 ** 32, -1)
_COUNTS = (0, 1, 7, 10 ** 6)


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", _SEEDS)
def test_prng_key_matches_jax(seed):
    assert np.array_equal(prng.prng_key(seed).numpy(),
                          _np(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("count", _COUNTS)
@pytest.mark.parametrize("seed", _SEEDS)
def test_fold_in_matches_jax(seed, count):
    want = _np(jax.random.fold_in(jax.random.PRNGKey(seed), count))
    assert np.array_equal(prng.fold_in(prng.prng_key(seed), count).numpy(),
                          want)


def test_fold_in_batched_rows_match_jax():
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in _SEEDS])
    counts = np.array([0, 1, 7, 10 ** 6, 3, 31], np.int32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(keys),
                                                    jnp.asarray(counts)))
    got = prng.fold_in(torch.from_numpy(keys.astype(np.int64)),
                       torch.from_numpy(counts))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("num", [2, 3, 16])
@pytest.mark.parametrize("seed", _SEEDS)
def test_split_matches_jax(seed, num):
    want = _np(jax.random.split(jax.random.PRNGKey(seed), num))
    got = prng.split(prng.prng_key(seed), num).numpy()
    assert np.array_equal(got, want)
    # the foldlike split's i-th key is fold_in(key, i)
    assert np.array_equal(got[1], prng.fold_in(prng.prng_key(seed),
                                               1).numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 11), (2, 1000)])
@pytest.mark.parametrize("seed", _SEEDS)
def test_bits_and_uniform_match_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    bits = prng.random_bits32(prng.prng_key(seed), shape).numpy()
    assert np.array_equal(bits, _np(jax.random.bits(key, shape)))
    u = prng.uniform(prng.prng_key(seed), shape).numpy()
    ju = np.asarray(jax.random.uniform(key, shape))
    assert np.array_equal(u.view(np.int32), ju.view(np.int32))
    # gumbel's floor: u on [tiny, 1)
    tiny = np.finfo(np.float32).tiny
    ut = prng.uniform(prng.prng_key(seed), shape, minval=tiny).numpy()
    jt = np.asarray(jax.random.uniform(key, shape, minval=tiny))
    assert np.array_equal(ut.view(np.int32), jt.view(np.int32))


def test_batched_key_rows_draw_their_own_streams():
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(s),
                                                   c))
                     for s, c in zip(_SEEDS, _COUNTS + (5, 9))])
    got = prng.random_bits32(torch.from_numpy(keys.astype(np.int64)),
                             (50,)).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (50,)))(
        jnp.asarray(keys)))
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("vocab", [1000, 50257])
@pytest.mark.parametrize("seed", _SEEDS)
def test_categorical_matches_jax(seed, vocab):
    rs = np.random.RandomState(seed % 1000)
    logits = (rs.randn(4, vocab) * 3).astype(np.float32)
    counts = np.array([0, 1, 7, 10 ** 6], np.int32)
    base = np.stack([np.asarray(jax.random.PRNGKey(seed + i))
                     for i in range(4)])
    keys = jax.vmap(jax.random.fold_in)(jnp.asarray(base),
                                        jnp.asarray(counts))
    # per-row keys: the serving engine's vmap(categorical)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                       jnp.asarray(logits)))
    tkeys = prng.fold_in(torch.from_numpy(base.astype(np.int64)),
                         torch.from_numpy(counts))
    assert np.array_equal(tkeys.numpy(), np.asarray(keys).astype(np.int64))
    got = prng.categorical(tkeys, torch.from_numpy(logits)).numpy()
    assert np.array_equal(got, want)
    # one key over the batch: run_generate's categorical(key, logits)
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                             jnp.asarray(logits), axis=-1))
    got = prng.categorical(prng.prng_key(seed),
                           torch.from_numpy(logits)).numpy()
    assert np.array_equal(got, want)


def test_categorical_respects_masked_logits():
    """-1e30 entries (the engine's top-k/top-p mask) are never drawn."""
    logits = np.full((3, 64), -1e30, np.float32)
    logits[0, 5] = 0.0
    logits[1, [2, 40]] = [0.0, 0.5]
    logits[2, :] = 0.0
    keys = prng.fold_in(prng.prng_key(3).expand(3, 2),
                        torch.arange(3))
    for c in range(20):
        tok = prng.categorical(prng.fold_in(keys, c),
                               torch.from_numpy(logits)).numpy()
        assert tok[0] == 5 and tok[1] in (2, 40) and 0 <= tok[2] < 64
