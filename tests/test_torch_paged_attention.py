"""The port's paged-attention functions (paddle_tpu_torch.ops.
paged_attention) against the JAX package's, on the same numpy inputs.

On the CPU the port's wrappers run their plain versions, which copy the
JAX gather+dense fallbacks: they must match the fallback
(`use_kernel=False`) at 1e-5 in f32, and the JAX Pallas kernels
(`use_kernel=True`, interpret mode off the TPU) at the JAX registry's
declared tolerance, over the registry's own example generators and at
GPT-3 125M head geometry (N=12, H=64, block 16) with the edge cases:
ctx 0, ctx on a block boundary, an inactive slot with an all-null
table, p0 = 0, p0 inside a block, p0 on a block boundary, and a chunk
that runs past its table's last key. The plain mirrors of the kernels'
key splits (the prefill's over warps, the decode's over chunks of keys)
are held against the fallback and the Pallas kernel too.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops import pallas_decode as jax_pd
from paddle_tpu.ops.kernel_registry import get_kernel as jax_kernel

from paddle_tpu_torch.ops.kernel_registry import get_kernel, reset_launches
from paddle_tpu_torch.ops.paged_attention import (DECODE_CHUNK_KEYS,
                                                  flash_prefill_chunk,
                                                  flash_prefill_split_plain,
                                                  paged_decode_attention,
                                                  paged_decode_split_plain)

_EXACT = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _decode_both(q, kp, vp, tables, ctx, n_heads, use_kernel):
    ref = jax_pd.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ctx), n_heads,
        use_kernel=use_kernel)
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(ctx),
                                 n_heads)
    return np.asarray(ref), got.numpy()


def _prefill_both(q, kp, vp, row, p0, n_heads, use_kernel):
    ref = jax_pd.flash_prefill_chunk(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(row),
        np.int32(p0), n_heads, use_kernel=use_kernel)
    got = flash_prefill_chunk(_t(q), _t(kp), _t(vp), _t(row), p0, n_heads)
    return np.asarray(ref), got.numpy()


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    reset_launches()
    yield
    assert get_kernel("paged_decode").launches == 0
    assert get_kernel("flash_prefill_chunk").launches == 0


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", ["paged_decode", "flash_prefill_chunk"])
def test_registry_examples_match_jax(name, seed):
    """The JAX registry's `example(rng)` inputs through both packages."""
    jk = jax_kernel(name)
    args, _ = jk.example(np.random.default_rng(seed))
    both = _decode_both if name == "paged_decode" else _prefill_both
    ref, got = both(*args, use_kernel=False)
    np.testing.assert_allclose(got, ref, **_EXACT)
    ref, got = both(*args, use_kernel=True)
    rtol, atol = jk.tol
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _arena(rng, num_blocks, bs, nh, dtype=np.float32):
    kp = rng.standard_normal((num_blocks, bs, nh)).astype(dtype)
    vp = rng.standard_normal((num_blocks, bs, nh)).astype(dtype)
    return kp, vp


# GPT-3 125M head geometry at a few blocks
_N, _H, _BS, _MB = 12, 64, 16, 4


def _decode_case(seed, ctx):
    """Slot s owns distinct physical blocks for positions 0..ctx[s];
    ctx < 0 marks an inactive slot: ctx 0 and an all-null table."""
    rng = np.random.default_rng(seed)
    S = len(ctx)
    kp, vp = _arena(rng, S * _MB + 1, _BS, _N * _H)
    tables = np.zeros((S, _MB), np.int32)
    perm = rng.permutation(np.arange(1, S * _MB + 1)).astype(np.int32)
    for s, c in enumerate(ctx):
        if c >= 0:
            n_alloc = c // _BS + 1
            tables[s, :n_alloc] = perm[s * _MB:s * _MB + n_alloc]
    q = rng.standard_normal((S, 1, _N * _H)).astype(np.float32)
    ctx_arr = np.maximum(np.asarray(ctx, np.int32), 0)
    return q, kp, vp, tables, ctx_arr


@pytest.mark.parametrize("ctx", [
    [0, 15, 16, 63],         # ctx 0, last row of block 0, block boundary
    [17, -1, 40, -1],        # inactive slots with all-null tables
    [5, 31, 32, 48],
], ids=["edges", "inactive", "mixed"])
def test_decode_125m_geometry(ctx):
    args = _decode_case(len(ctx) + sum(ctx), ctx)
    ref, got = _decode_both(*args, _N, use_kernel=False)
    np.testing.assert_allclose(got, ref, **_EXACT)
    assert np.isfinite(got).all()
    ref, got = _decode_both(*args, _N, use_kernel=True)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def _prefill_case(p0):
    """A 16-query chunk at p0 over a 4-block table; from p0 400 a 32-query
    chunk over a 26-block table (416 keys), whose rows 16.. run past the
    table's end and clamp to its last key."""
    rng = np.random.default_rng(100 + p0)
    C, mb = 16, _MB
    if p0 >= _MB * _BS:
        C, mb = 32, (p0 + 16) // _BS + 1
    kp, vp = _arena(rng, mb + 3, _BS, _N * _H)
    n_alloc = min((p0 + C - 1) // _BS + 1, mb)
    row = np.zeros((mb,), np.int32)
    row[:n_alloc] = rng.permutation(np.arange(1, mb + 3))[:n_alloc]
    q = rng.standard_normal((1, C, _N * _H)).astype(np.float32)
    return q, kp, vp, row


@pytest.mark.parametrize("p0", [0, 7, 15, 16, 29, 400])
def test_prefill_125m_geometry(p0):
    """A chunk at p0 over its table (`_prefill_case`); rows past the last
    allocated block see null-block keys, which stay finite."""
    q, kp, vp, row = _prefill_case(p0)
    ref, got = _prefill_both(q, kp, vp, row, p0, _N, use_kernel=False)
    np.testing.assert_allclose(got, ref, **_EXACT)
    assert np.isfinite(got).all()
    ref, got = _prefill_both(q, kp, vp, row, p0, _N, use_kernel=True)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("p0", [0, 9, 29, 400])
def test_prefill_key_split_matches_jax_fallback(p0, splits):
    """The plain mirror of the bf16 kernel's key split and merge: 16-key
    steps round-robin over `splits` warps. At p0 0 the whole chunk lies
    in step 0, so warps 1.. see nothing; at p0 9 and 29 the first rows
    cannot see the last step; at p0 400 rows clamp to the last key."""
    q, kp, vp, row = _prefill_case(p0)
    ref = jax_pd.flash_prefill_chunk(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(row),
        np.int32(p0), _N, use_kernel=False)
    got = flash_prefill_split_plain(_t(q), _t(kp), _t(vp), _t(row), p0, _N,
                                    splits)
    assert got.shape == q.shape and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **_EXACT)


def _split_case(ctx, head_dim):
    """Two slots over 32 blocks of 16 (512 keys): slot 0 at `ctx`
    ("inactive": ctx 0 and an all-null table; "overlong": ctx 700, past
    the table's last key), slot 1 at ctx 200 (13 blocks)."""
    rng = np.random.default_rng(head_dim + (ctx if isinstance(ctx, int)
                                            else len(ctx)))
    mb, bs, n = 32, 16, 256 // head_dim
    kp, vp = _arena(rng, 2 * mb + 1, bs, n * head_dim)
    tables = np.zeros((2, mb), np.int32)
    perm = rng.permutation(np.arange(1, 2 * mb + 1)).astype(np.int32)
    c0 = {"inactive": 0, "overlong": 700}.get(ctx, ctx)
    if ctx != "inactive":
        blocks = min(c0 // bs + 1, mb)
        tables[0, :blocks] = perm[:blocks]
    tables[1, :200 // bs + 1] = perm[mb:mb + 200 // bs + 1]
    q = rng.standard_normal((2, 1, n * head_dim)).astype(np.float32)
    return q, kp, vp, tables, np.array([c0, 200], np.int32), n


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("ctx", [0, 15, 16, 63, 64, 65, 127, 128, 511,
                                 "inactive", "overlong"])
def test_decode_key_split_matches_jax(ctx, head_dim):
    """The plain mirror of the decode kernel's split over the keys
    (chunks of 16, DECODE_CHUNK_KEYS and 64 keys, merged with weights
    exp(m_c - M)) against the JAX fallback (1e-5) and the Pallas kernel
    in interpret mode (the registry's 1e-3), at and around the chunk
    edges, for an inactive slot and for a ctx past the table's reach."""
    q, kp, vp, tables, ctx_arr, n = _split_case(ctx, head_dim)
    args = tuple(jnp.asarray(a) for a in (q, kp, vp, tables, ctx_arr))
    fallback = np.asarray(jax_pd.paged_decode_attention(*args, n,
                                                        use_kernel=False))
    pallas = np.asarray(jax_pd.paged_decode_attention(*args, n,
                                                      use_kernel=True))
    for chunk in sorted({16, DECODE_CHUNK_KEYS, 64}):
        got = paged_decode_split_plain(_t(q), _t(kp), _t(vp), _t(tables),
                                       _t(ctx_arr), n, chunk).numpy()
        assert got.shape == q.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, fallback, **_EXACT)
        np.testing.assert_allclose(got, pallas, rtol=1e-3, atol=1e-3)


def test_plain_versions_in_bf16_match_jax_fallback():
    """bf16 inputs: both packages round probs and outputs to bf16 at the
    same points; the remaining difference is summation order."""
    q, kp, vp, tables, ctx = _decode_case(7, [3, 20, 47])
    bf = jnp.bfloat16
    ref = jax_pd.paged_decode_attention(
        jnp.asarray(q, bf), jnp.asarray(kp, bf), jnp.asarray(vp, bf),
        jnp.asarray(tables), jnp.asarray(ctx), _N, use_kernel=False)
    got = paged_decode_attention(
        _t(q).bfloat16(), _t(kp).bfloat16(), _t(vp).bfloat16(), _t(tables),
        _t(ctx), _N)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    row = tables[2]
    qc = np.random.default_rng(8).standard_normal((1, 16, _N * _H))
    ref = jax_pd.flash_prefill_chunk(
        jnp.asarray(qc, bf), jnp.asarray(kp, bf), jnp.asarray(vp, bf),
        jnp.asarray(row), np.int32(9), _N, use_kernel=False)
    got = flash_prefill_chunk(_t(qc).bfloat16(), _t(kp).bfloat16(),
                              _t(vp).bfloat16(), _t(row), 9, _N)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    """Only a CPU tensor takes the plain version; any other non-CUDA
    device raises instead of computing somewhere else."""
    q = torch.empty((2, 1, 128), device="meta")
    pages = torch.empty((3, 8, 128), device="meta")
    tab = torch.empty((2, 1), dtype=torch.int32, device="meta")
    ctx = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_decode_attention(q, pages, pages, tab, ctx, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill_chunk(q.reshape(1, 2, 128), pages, pages,
                            tab.reshape(2), 0, 4)
