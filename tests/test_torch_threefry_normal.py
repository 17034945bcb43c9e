"""Port parity: ``jax.random.uniform`` / ``jax.random.normal`` without JAX.

``utils/threefry.py`` computes the JAX package's float32 draws in numpy (the
plain reference) and as batched torch ops (what the port runs on the card).
The numpy draws are held to ``jax.random`` within 4 ulp (they are bit-equal
but for XLA's fused multiply-adds, which the module rounds through float64;
a double rounding can differ in ~2^-29 of those steps), and the torch draws
to the numpy draws bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_decoding_tpu_torch.utils import threefry as T

ULP_MAX = 4
SEEDS = [0, 3, 2**31 - 1, 2**32 + 3, -5]
SHAPES = [(6, 73, 1024), (1000, 37), (3, 5), (1,), (2, 3, 4, 5)]


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    # the int32 views of floats are monotone per sign; map negatives below zero
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _key(seed):
    return T.split(T.prng_key(seed), 2)[1]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed, shape):
    key = _key(seed)
    ref = np.asarray(jax.random.normal(jnp.asarray(key), shape))
    got = T.normal(key, shape)
    assert got.dtype == np.float32 and got.shape == shape
    assert _ulps(got, ref).max() <= ULP_MAX
    assert np.mean(got == ref) >= 0.999


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-2.0, 3.0), (-1e-3, 1e-3),
                                    (float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_matches_jax(seed, bounds):
    key = _key(seed)
    ref = np.asarray(jax.random.uniform(jnp.asarray(key), (513, 7), jnp.float32, *bounds))
    got = T.uniform(key, (513, 7), *bounds)
    assert got.dtype == np.float32
    assert _ulps(got, ref).max() <= ULP_MAX
    assert got.min() >= np.float32(bounds[0])


def test_erf_inv_matches_xla_on_the_edges():
    """Both branches of the polynomial (w < 5 and w >= 5), both log1p
    branches, and +-1 -> +-inf."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.concatenate([
        np.linspace(-1, 1, 20001, dtype=np.float32),
        np.array([lo, -lo, 0.0, -0.0, 0.6435, -0.6436, 0.99662, 0.99663,
                  np.nextafter(np.float32(1), np.float32(0))], np.float32),
    ])
    ref = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = T.erf_inv_f32(x)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isinf(got), ~finite)
    np.testing.assert_array_equal(np.sign(got[~finite]), np.sign(ref[~finite]))
    assert _ulps(got[finite], ref[finite]).max() <= ULP_MAX


@pytest.mark.parametrize("shape", SHAPES[1:], ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_torch_draws_equal_numpy_draws(seed, shape):
    """A batch of keys at once, each row the numpy draw of its key."""
    keys = T.split(T.prng_key(seed), 3)
    np.testing.assert_array_equal(
        T.random_bits_torch(keys, shape, "cpu").numpy(),
        np.stack([T.random_bits(k, shape) for k in keys]).astype(np.int64))
    got = T.normal_torch(keys, shape, "cpu").numpy()
    ref = np.stack([T.normal(k, shape) for k in keys])
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    got_u = T.uniform_torch(keys, shape, -2.0, 3.0, "cpu").numpy()
    ref_u = np.stack([T.uniform(k, shape, -2.0, 3.0) for k in keys])
    np.testing.assert_array_equal(got_u.view(np.int32), ref_u.view(np.int32))


def test_torch_draws_at_the_calibration_shape():
    """The calibration's per-permutation layout: split each key in two, draw
    latents from the first and predictions from the second."""
    keys = T.split(T.prng_key(0), 2)
    ks = T.split_torch(keys, 2, "cpu")
    np.testing.assert_array_equal(ks.numpy(), np.stack([T.split(k, 2) for k in keys]))
    got = T.normal_torch(ks[:, 0], (6, 73, 1024), "cpu").numpy()
    for i, k in enumerate(keys):
        sub = T.split(k, 2)[0]
        np.testing.assert_array_equal(got[i], T.normal(sub, (6, 73, 1024)))
        ref = np.asarray(jax.random.normal(jax.random.split(jnp.asarray(k), 2)[0], (6, 73, 1024)))
        assert _ulps(got[i], ref).max() <= ULP_MAX


def test_correctly_rounded_sqrt():
    rng = np.random.RandomState(0)
    w = np.concatenate([(rng.rand(200_000) * 30).astype(np.float32),
                        np.array([0.0, 4.0, 2.25, 1e-30, 3e38, 5.0, 17.0], np.float32)])
    np.testing.assert_array_equal(T._sqrt_f32_torch(torch.from_numpy(w)).numpy(), np.sqrt(w))
