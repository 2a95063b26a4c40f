"""The port's int8 head matvec (paddle_tpu_torch.ops.int8_matvec,
registry "int8_matvec") against the JAX package's, on the same numpy
inputs.

On the CPU the wrapper runs its plain version, which copies the JAX
`_matvec_fallback` (h rounded to bf16, exact products, f32 sums, scaled
per row). The rounding is the same in both packages; only the order of
summation differs (the card kernel sums each row over k-steps of 16 d's
in the tensor cores' order, the JAX kernel over its own blocks), so the
tolerance is the JAX registry's (1e-4, 1e-4) against both the fallback
and the Pallas kernel in interpret mode, for f32 and bf16 h, and at
every batch row count the quantized head sends to the card kernel.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops import pallas_int8 as jax_i8
from paddle_tpu.ops.kernel_registry import get_kernel as jax_kernel

from paddle_tpu_torch.ops.int8_matvec import (_BLOCK_V, int8_matvec,
                                              int8_matvec_preferred)
from paddle_tpu_torch.ops.kernel_registry import get_kernel, reset_launches

_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    reset_launches()
    yield
    assert get_kernel("int8_matvec").launches == 0


def _inputs(rng, B, D, V):
    h = rng.standard_normal((B, D)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(V, D)).astype(np.int8)
    scale = ((0.01 + rng.random(V)) * 0.01).astype(np.float32)
    return h, wq, scale


def _check(h, wq, scale, jdt, tdt):
    jh = jnp.asarray(h, jdt)
    fb = np.asarray(jax_i8._matvec_fallback(jh, jnp.asarray(wq),
                                            jnp.asarray(scale)))
    kern = np.asarray(jax_i8.int8_matvec(jh, jnp.asarray(wq),
                                         jnp.asarray(scale)))
    got = int8_matvec(torch.from_numpy(h).to(tdt), torch.from_numpy(wq),
                      torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == fb.shape
    np.testing.assert_allclose(got.numpy(), fb, **_TOL)
    np.testing.assert_allclose(got.numpy(), kern, **_TOL)


@pytest.mark.parametrize("B", [1, 3, 16, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax(B, dtype):
    rng = np.random.default_rng(B)
    h, wq, scale = _inputs(rng, B, 128, 2 * _BLOCK_V)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    _check(h, wq, scale, jdt, tdt)


@pytest.mark.parametrize("B", range(1, 65))
def test_every_kernel_row_count_matches_jax(B):
    """Every row count 1..64 (the card kernel's n-tiles of 8, 16, 32 and
    64 rows, full and ragged) at a small D and a V that is no multiple
    of a table tile, against the JAX fallback."""
    h, wq, scale = _inputs(np.random.default_rng(200 + B), B, 64, 300)
    jh = jnp.asarray(h, jnp.bfloat16)
    fb = np.asarray(jax_i8._matvec_fallback(jh, jnp.asarray(wq),
                                            jnp.asarray(scale)))
    got = int8_matvec(torch.from_numpy(h).to(torch.bfloat16),
                      torch.from_numpy(wq), torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == (B, 300)
    np.testing.assert_allclose(got.numpy(), fb, **_TOL)


@pytest.mark.parametrize("seed", range(3))
def test_registry_examples_match_jax(seed):
    args, _ = jax_kernel("int8_matvec").example(np.random.default_rng(seed))
    _check(*args, jnp.float32, torch.float32)


def test_bf16_scale_is_used_as_f32():
    """A bf16 decode casts the scale buffers to bf16; the matvec widens
    them, as the JAX kernel does."""
    h, wq, scale = _inputs(np.random.default_rng(5), 2, 64, 300)
    s16 = torch.from_numpy(scale).to(torch.bfloat16)
    got = int8_matvec(torch.from_numpy(h), torch.from_numpy(wq), s16)
    ref = int8_matvec(torch.from_numpy(h), torch.from_numpy(wq), s16.float())
    assert torch.equal(got, ref)


def test_preferred_only_for_decode_rows_on_the_card():
    assert not int8_matvec_preferred(1, "cpu")
    assert int8_matvec_preferred(64, torch.device("cuda"))
    assert not int8_matvec_preferred(65, torch.device("cuda"))


def test_unsupported_device_is_refused():
    h = torch.empty((2, 64), device="meta")
    w = torch.empty((16, 64), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        int8_matvec(h, w, torch.empty((16,), device="meta"))
