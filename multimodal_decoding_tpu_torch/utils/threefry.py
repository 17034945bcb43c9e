"""The JAX package's random draws, computed in numpy and in torch.

The JAX searchlight runner draws each block's imagery derangements with
``jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(null_seed), b),
(B, P), 0, 2, dtype=jnp.int32)``, and the calibration of the analyses draws
its null with ``jax.random.normal``.  The port has no JAX, so this module
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
  32-bit integers;
* ``uniform`` and ``normal``: ``jax.random.uniform`` / ``jax.random.normal``
  in float32 (below).

All integer arithmetic is uint32 and wraps, as it does in XLA.  The numpy
functions are the plain reference; the ``*_torch`` functions compute the
same bits for a batch of keys on any device.
"""

from __future__ import annotations

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# Float32 draws: jax.random.uniform and jax.random.normal
# ---------------------------------------------------------------------------
#
# ``normal`` is ``sqrt(2) * erf_inv(uniform(key, shape, nextafter(-1, 0), 1))``
# and ``erf_inv`` is XLA's float32 ErfInv (M. Giles' single-precision
# polynomial), whose ``log1p`` XLA's CPU backend emits as Cephes' rational
# approximation below sqrt(2) - 1 and Cephes' ``logf`` of 1 + x above it.
# XLA contracts each multiply feeding an add into a fused multiply-add; ``_fma``
# rounds ``a * b + c`` once to float32 through float64 (the product of two
# float32 numbers is exact there), so these draws are bit-equal to
# ``jax.random.normal`` on the CPU (but for a double rounding in ~2^-29 of
# the fused steps), and every step is an IEEE operation, so the numpy and
# torch versions below agree bit for bit on any device.

_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_SMALL = 0.41421356237309504880  # sqrt(2) - 1
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
          1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
          3.3333331174E-1)
_LOG_Q1, _LOG_Q2, _SQRT_HALF = -2.12194440e-4, 0.693359375, 0.707106781186547524
_MIN_NORMAL_BITS, _HALF_BITS, _ONE_BITS = 0x00800000, 0x3F000000, 0x3F800000
_F32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _poly(x: np.ndarray, coefficients) -> np.ndarray:
    """Horner's rule from the highest degree, one fused step per coefficient."""
    p = np.zeros_like(x)
    for c in coefficients:
        p = _fma(p, x, _F32(c))
    return p


def _log_f32(x: np.ndarray) -> np.ndarray:
    """Cephes ``logf`` for positive finite float32 ``x`` (XLA CPU's log)."""
    x = np.maximum(x, np.array(_MIN_NORMAL_BITS, np.int32).view(np.float32))
    bits = x.view(np.int32)
    e = _F32(1) + ((bits >> 23) - 0x7F).astype(np.float32)
    m = ((bits & ~0x7F800000) | _HALF_BITS).view(np.float32)  # in [0.5, 1)
    small = m < _F32(_SQRT_HALF)
    t = (m - _F32(1)) + np.where(small, m, _F32(0))
    e = e - np.where(small, _F32(1), _F32(0))
    t2 = t * t
    t3 = t2 * t
    y = _fma(_fma(t, _F32(_LOG_P[0]), _F32(_LOG_P[1])), t, _F32(_LOG_P[2]))
    y1 = _fma(_fma(t, _F32(_LOG_P[3]), _F32(_LOG_P[4])), t, _F32(_LOG_P[5]))
    y2 = _fma(_fma(t, _F32(_LOG_P[6]), _F32(_LOG_P[7])), t, _F32(_LOG_P[8]))
    y = _fma(_fma(y, t3, y1), t3, y2)
    y = _fma(y, t3, _F32(_LOG_Q1) * e)
    t = (t - _F32(0.5) * t2) + y
    return t + _F32(_LOG_Q2) * e


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p`` for ``x`` in (-1, 0]."""
    x2 = x * x
    r = _poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN)
    small = x + _fma(_F32(-0.5), x2, (x * x2) * r)
    with np.errstate(divide="ignore"):
        large = _log_f32(x + _F32(1))
    return np.where(np.abs(x) < _F32(_LOG1P_SMALL), small, large)


def erf_inv_f32(x) -> np.ndarray:
    """XLA's float32 ``ErfInv`` (``jax.lax.erf_inv``) for ``x`` in [-1, 1]."""
    x = np.asarray(x, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -_log1p_f32(x * -x)
        lt = w < _F32(5)
        w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3))
    p = np.zeros_like(x)
    for lo, hi in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5):
        p = _fma(p, w, np.where(lt, _F32(lo), _F32(hi)))
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == _F32(1), x * _F32(np.inf), p * x)


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``."""
    lo, hi = _F32(minval), _F32(maxval)
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(_ONE_BITS)).view(np.float32) - _F32(1)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` (float32)."""
    lo = np.nextafter(_F32(-1), _F32(0))
    return _F32(np.sqrt(2)) * erf_inv_f32(uniform(key, shape, lo, 1.0))


# ---------------------------------------------------------------------------
# The same draws as torch ops, batched over keys, on any device
# ---------------------------------------------------------------------------
#
# uint32 words live in int64 lanes masked to 32 bits after every add and left
# shift; the float steps are the numpy ones above, op for op.

_M32 = 0xFFFFFFFF


def _keys_tensor(keys, device) -> torch.Tensor:
    """``[..., 2]`` uint32 key words as an int64 tensor on ``device``."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(keys, dtype=np.uint32).astype(np.int64), device=device)


def threefry2x32_torch(k0, k1, x0, x1):
    """``threefry2x32`` on int64 tensors holding uint32 values; the key words
    broadcast against the counter words."""
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = (x0 + k0).bitwise_and_(_M32)
    x1 = (x1 + k1).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            x1 = (x1 << r).bitwise_and_(_M32).bitwise_or_(x1 >> (32 - r)).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_M32)
    return x0, x1


def _counters_torch(n: int, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def split_torch(keys, num: int = 2, device=None) -> torch.Tensor:
    """``split`` of each key of a ``[..., 2]`` batch: ``[..., num, 2]`` (int64)."""
    k = _keys_tensor(keys, device)
    a, b = threefry2x32_torch(k[..., 0:1], k[..., 1:2], *_counters_torch(num, k.device))
    return torch.stack([a, b], dim=-1)


def random_bits_torch(keys, shape, device=None) -> torch.Tensor:
    """``random_bits`` of each key of a ``[..., 2]`` batch:
    ``[..., *shape]`` int64 holding uint32 values."""
    k = _keys_tensor(keys, device)
    shape = tuple(int(s) for s in shape)
    a, b = threefry2x32_torch(k[..., 0:1], k[..., 1:2],
                              *_counters_torch(int(np.prod(shape, dtype=np.int64)), k.device))
    return a.bitwise_xor_(b).reshape(*k.shape[:-1], *shape)


def _c32(value) -> float:
    """A constant rounded to float32 (so no op sees more precision than numpy's)."""
    return float(np.float32(value))


def _f64(x):
    return x.to(torch.float64) if isinstance(x, torch.Tensor) else x


def _fma_torch(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (``a`` a float32 tensor)."""
    return (_f64(a) * _f64(b) + _f64(c)).to(torch.float32)


def _sqrt_f32_torch(w: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of ``w >= 0`` (as numpy's and
    IEEE's): the float64 root rounded to float32, moved by one ulp where the
    exact square of the midpoint to its neighbour says so (float32 ``sqrt``
    on some CPUs is not correctly rounded)."""
    s = torch.sqrt(w.to(torch.float64)).to(torch.float32)
    w64 = w.to(torch.float64)
    for toward in (float("inf"), 0.0):
        n = torch.nextafter(s, torch.full_like(s, toward))
        mid = (s.to(torch.float64) + n.to(torch.float64)) * 0.5  # exact, and so is mid^2
        beyond = mid * mid < w64 if toward else mid * mid > w64
        s = torch.where(beyond, n, s)
    return s


def _log_f32_torch(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp_min(x, float(np.array(_MIN_NORMAL_BITS, np.int32).view(np.float32)))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | _HALF_BITS).view(torch.float32)
    small = m < _c32(_SQRT_HALF)
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(torch.float32)
    t2 = t * t
    t3 = t2 * t
    P = [_c32(v) for v in _LOG_P]
    y = _fma_torch(_fma_torch(t, P[0], P[1]), t, P[2])
    y1 = _fma_torch(_fma_torch(t, P[3], P[4]), t, P[5])
    y2 = _fma_torch(_fma_torch(t, P[6], P[7]), t, P[8])
    y = _fma_torch(_fma_torch(y, t3, y1), t3, y2)
    y = _fma_torch(y, t3, e * _c32(_LOG_Q1))
    t = (t - t2 * 0.5) + y
    return t + e * _c32(_LOG_Q2)


def _poly_torch(x: torch.Tensor, coefficients) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coefficients:
        p = _fma_torch(p, x, _c32(c))
    return p


def _log1p_f32_torch(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    r = _poly_torch(x, _LOG1P_NUM) / _poly_torch(x, _LOG1P_DEN)
    small = x + _fma_torch(torch.full_like(x2, -0.5), x2, (x * x2) * r)
    return torch.where(x.abs() < _c32(_LOG1P_SMALL), small, _log_f32_torch(x + 1.0))


def erf_inv_f32_torch(x: torch.Tensor) -> torch.Tensor:
    """``erf_inv_f32`` as torch ops (float32 in, float32 out)."""
    w = -_log1p_f32_torch(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt_f32_torch(w) - 3.0)
    p = torch.zeros_like(x)
    for lo, hi in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5):
        c = torch.where(lt, torch.tensor(_c32(lo), device=x.device),
                        torch.tensor(_c32(hi), device=x.device))
        p = _fma_torch(p, w, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def uniform_torch(keys, shape, minval=0.0, maxval=1.0, device=None) -> torch.Tensor:
    """``uniform`` of each key of a ``[..., 2]`` batch: ``[..., *shape]`` float32."""
    lo, hi = _F32(minval), _F32(maxval)
    bits = random_bits_torch(keys, shape, device)
    floats = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(_fma_torch(floats, float(hi - lo), float(lo)), float(lo))


def normal_torch(keys, shape, device=None) -> torch.Tensor:
    """``normal`` of each key of a ``[..., 2]`` batch: ``[..., *shape]`` float32."""
    u = uniform_torch(keys, shape, np.nextafter(_F32(-1), _F32(0)), 1.0, device)
    return erf_inv_f32_torch(u) * _c32(np.sqrt(2))
