"""jax.random's threefry2x32 counter-based PRNG, in torch.

The JAX package draws every random number from `jax.random` with its
default implementation: threefry2x32 with partitionable bits
(`jax_threefry_partitionable`, the default since jax 0.5). That
generator is pure integer arithmetic on counters, so it can be
reproduced exactly: this module gives the same keys and the same bits
as `jax.random`, on the CPU and on the card, and draws the same
categorical samples wherever `torch.log` rounds as XLA's log does (it
may differ by an ulp, which flips a draw only at such a tie).

Keys are int64 tensors of shape [..., 2] holding two uint32 words (the
raw key data of `jax.random.PRNGKey`), and every word of the arithmetic
is an int64 masked to 32 bits, because torch has no full uint32
arithmetic. The references are jax/_src/prng.py (`threefry_seed`,
`_threefry2x32_lowering`, `_threefry_fold_in`,
`_threefry_split_foldlike`, `_threefry_random_bits_partitionable`) and
jax/_src/random.py (`_uniform`, `_gumbel` in its "low" mode,
`categorical`).
"""
import math

import torch

__all__ = ["prng_key", "fresh_seed", "fold_in", "split", "threefry2x32",
           "random_bits32", "uniform", "gumbel", "categorical"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block cipher, 20 rounds: key words (k1, k2) over
    counter words (x1, x2); int64 tensors holding uint32 values, which
    broadcast against each other. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed, device="cpu"):
    """`jax.random.PRNGKey(seed)` -> int64 [2]. With 64-bit types off
    (the JAX default) the seed is taken as an int32, so it wraps modulo
    2**32 and the high word is 0: PRNGKey(-1) is (0, 0xFFFFFFFF) and
    PRNGKey(2**32) is (0, 0)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fresh_seed():
    """A seed for a caller that gave none: 32 bits from torch's default
    CPU generator, so `torch.manual_seed` makes a seedless run
    reproducible (as `paddle.seed` does the JAX package's)."""
    return int(torch.randint(0, 2 ** 32, (), dtype=torch.int64))


def _words(keys):
    keys = torch.as_tensor(keys).long()
    return keys[..., 0], keys[..., 1]


def fold_in(keys, data):
    """`jax.random.fold_in`, batched: keys [..., 2] and data (an int or
    an integer tensor broadcasting against keys[..., 0]) -> [..., 2].
    The data word is taken modulo 2**32, as JAX's uint32 cast takes
    it."""
    k1, k2 = _words(keys)
    data = torch.as_tensor(data, device=k1.device).long() & _MASK
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def split(key, num=2):
    """`jax.random.split(key, num)` under partitionable threefry: the
    foldlike split, whose i-th key is threefry over the counter (0, i) —
    `fold_in(key, i)`. key [2] -> [num, 2]."""
    k1, k2 = _words(key)
    cnt = torch.arange(num, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, cnt >> 32, cnt & _MASK)
    return torch.stack([b1, b2], dim=-1)


def random_bits32(keys, shape):
    """32 random bits per element (int64 holding uint32): keys [..., 2]
    -> [..., *shape], each key drawing as `jax.random.bits(key, shape)`
    does, over the row-major counters 0 .. prod(shape) - 1 split into
    (high, low) words; the bits are the xor of the two output words."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = _words(keys)
    lead = k1.shape
    cnt = torch.arange(math.prod(shape), dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1.reshape(*lead, 1), k2.reshape(*lead, 1),
                          cnt >> 32, cnt & _MASK)
    return (b1 ^ b2).reshape(*lead, *shape)


def uniform(keys, shape, minval=0.0, maxval=1.0):
    """`jax.random.uniform` in f32: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, scaled to [minval, maxval) and clamped
    below at minval."""
    bits = random_bits32(keys, shape)
    one = (bits >> 9) | 0x3F800000            # < 2**30: fits an int32
    f = one.to(torch.int32).view(torch.float32) - 1.0
    # the bounds are filled on the device (no host-to-device copy, which
    # a captured CUDA graph could not hold); f32 as jax's are
    lo = torch.full((), minval, dtype=torch.float32, device=f.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(keys, shape):
    """`jax.random.gumbel` in its default "low" mode, f32:
    -log(-log(u)) with u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, shape, minval=_TINY)))


def categorical(keys, logits):
    """`jax.random.categorical` over the last axis, by the Gumbel-max
    trick: argmax(gumbel + logits), the first index on ties.

    - keys [2] with logits [..., V] draws one key over the whole array,
      as `categorical(key, logits)` does (run_generate's selector);
    - keys [R, 2] with logits [R, V] draws row i with key i, as
      `vmap(categorical)(keys, logits)` does (the serving engine's)."""
    keys = torch.as_tensor(keys, device=logits.device)
    if keys.dim() == 1:
        g = gumbel(keys, logits.shape)
    else:
        g = gumbel(keys, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
