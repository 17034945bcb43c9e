"""The JAX package's random draws, computed in numpy.

The JAX searchlight runner draws each block's imagery derangements with
``jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(null_seed), b),
(B, P), 0, 2, dtype=jnp.int32)``.  The port has no JAX, so this module
computes the same bits: the Threefry-2x32 hash (20 rounds, Salmon et al.
2011, as ``jax._src.prng`` implements it) and the key operations on top of
it in the mode JAX uses by default since 0.5 (``jax_threefry_partitionable``
on):

* ``prng_key(seed)``: the key ``[0, seed mod 2^32]`` (64-bit JAX types off);
* ``fold_in(key, data)``: ``threefry(key, [0], [data])``;
* ``split(key, n)``: ``threefry(key, hi, lo)`` of the 64-bit counter
  ``0..n-1`` split into its high and low words, one key per counter;
* ``random_bits(key, shape)``: the same counter over the flattened shape,
  the two output words XORed;
* ``randint(key, shape, minval, maxval)``: two ``random_bits`` draws from a
  split key combined modulo the span, as ``jax.random.randint`` does for
  32-bit integers.

All arithmetic is uint32 and wraps, as it does in XLA.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotate_left(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash of the word pairs ``(x0, x1)`` under ``key``
    (two uint32 words); returns the two hashed words."""
    k = np.asarray(key, dtype=np.uint32)
    ks = (k[0:1], k[1:2], k[0:1] ^ k[1:2] ^ _PARITY)
    x0 = np.asarray(x0, dtype=np.uint32) + ks[0]
    x1 = np.asarray(x1, dtype=np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotate_left(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s data with 64-bit types off."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], dtype=np.uint32)


def _counter_words(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``[num, 2]`` keys."""
    a, b = threefry2x32(key, *_counter_words(num))
    return np.stack([a, b], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element of ``shape`` (uint32)."""
    shape = tuple(int(s) for s in shape)
    a, b = threefry2x32(key, *_counter_words(int(np.prod(shape, dtype=np.int64))))
    return (a ^ b).reshape(shape)


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, dtype=jnp.int32)``."""
    lo, hi = int(minval), int(maxval)
    info = np.iinfo(np.int32)
    if not (info.min <= lo <= info.max and info.min <= hi <= info.max):
        raise ValueError(f"randint: bounds [{lo}, {hi}) must lie in the int32 range")
    k1, k2 = split(key, 2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(max(hi - lo, 1) & 0xFFFFFFFF)
    m = 2 ** 16 % int(span)
    multiplier = np.uint32((m * m & 0xFFFFFFFF) % int(span))  # uint32 product wraps
    offset = ((higher % span) * multiplier + lower % span) % span
    return (lo + offset.astype(np.int64)).astype(np.int32)
