"""jax's threefry2x32 PRNG in numpy: the JAX package's random draws, bit
for bit, without jax.

Follows ``jax._src.prng`` and ``jax._src.random`` of jax 0.9 with
``jax_threefry_partitionable`` on (its default): a key is a (2,) uint32
array; ``split``, ``fold_in`` and ``random_bits`` hash counters with
threefry2x32 (20 rounds); ``uniform`` fills the mantissa of [1, 2) with
the top 23 bits; ``normal`` is ``√2·erf⁻¹(u)`` with u on (−1, 1);
``truncated_normal`` maps u on (erf(a/√2), erf(b/√2)) the same way.
``erf_inv`` (with the ``log1p`` and ``log`` under it) and ``erf`` are
XLA's single-precision polynomials as its CPU backend runs them, written
in float32 numpy in the same order of operations, with XLA's fused
multiply-adds computed exactly (``_fma32``). On jax 0.9's CPU backend the
bits, ``uniform``, ``split``, ``fold_in``, ``normal`` and
``truncated_normal`` came out equal (``tests/test_torch_random.py``);
another XLA build may round a few values one ulp apart.

A batch of keys (…, 2) draws one independent stream per key, as
``jax.vmap`` over the key does. Every draw runs on the host; a caller moves
the result to its device.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Iterable, Sequence, Tuple, Union

import numpy as np

Shape = Union[int, Sequence[int]]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32 = np.float32


def _u32(v) -> np.ndarray:
    return np.asarray(v, dtype=np.uint32)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(d) for d in shape)


def threefry2x32(k0, k1, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 hash of the counter pairs (x0, x1) under the key
    (k0, k1); every argument a uint32 array, broadcast together."""
    k0, k1 = _u32(k0), _u32(k1)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = np.broadcast_arrays(_u32(x0), _u32(x1), k0)[:2]
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for 0 ≤ seed < 2⁶⁴: (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return _u32([seed >> 32, seed & 0xFFFFFFFF])


def as_key(key) -> np.ndarray:
    """``key`` as a uint32 array of one key (2,) or a batch (…, 2)."""
    key = _u32(key)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is a (..., 2) uint32 array, got shape {key.shape}")
    return key


def _hash_iota(key: np.ndarray, shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """threefry of the flat index of every element of ``shape`` (high word,
    low word), one stream per key of a (…, 2) batch: → two uint32 arrays of
    shape key.shape[:-1] + shape."""
    counts = np.arange(math.prod(shape), dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = counts.astype(np.uint32).reshape(shape)
    expand = (slice(None),) * (key.ndim - 1) + (None,) * len(shape)
    return threefry2x32(key[..., 0][expand], key[..., 1][expand], hi, lo)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` → (num, 2); a (B, 2) batch → (B, num, 2)."""
    key = as_key(key)
    b0, b1 = _hash_iota(key, (int(num),))
    return np.stack([b0, b1], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    key = as_key(key)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], np.uint32(0), _u32(int(data) & 0xFFFFFFFF))
    return np.stack([y0, y1], axis=-1)


_CHUNK = 1 << 18  # elements hashed and transformed at a time (cache-sized)


def _draw(key, shape: Shape, fn: Callable[[np.ndarray], np.ndarray], dtype) -> np.ndarray:
    """``fn`` of jax's 32 random bits of every element of ``shape``
    (bits1 ^ bits2 of the element's flat index), one stream per key of a
    (…, 2) batch, computed a chunk at a time."""
    key, shape = as_key(key), _shape(shape)
    n = math.prod(shape)
    out = np.empty(key.shape[:-1] + (n,), dtype)
    for idx in np.ndindex(key.shape[:-1]):
        k0, k1 = key[idx]
        for a in range(0, n, _CHUNK):
            counts = np.arange(a, min(a + _CHUNK, n), dtype=np.uint64)
            b0, b1 = threefry2x32(k0, k1, (counts >> np.uint64(32)).astype(np.uint32),
                                  counts.astype(np.uint32))
            b0 ^= b1
            out[idx + (slice(a, a + len(counts)),)] = fn(b0)
    return out.reshape(key.shape[:-1] + shape)


def random_bits(key, shape: Shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``; a (B, 2) batch of keys →
    (B,) + shape, one stream per key."""
    return _draw(key, shape, lambda b: b, np.uint32)


def randint(key, shape: Shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32 for bounds
    that fit int32 (jax's ``_randint``): two streams of 32 bits from
    ``split(key)``, reduced modulo the span as ``(hi % span)·(2³² % span) +
    lo % span`` in uint32 arithmetic; ``maxval <= minval`` returns
    ``minval``."""
    info = np.iinfo(np.int32)
    if not (info.min <= minval <= info.max and info.min <= maxval <= info.max):
        raise ValueError(f"randint bounds must fit int32, got [{minval}, {maxval})")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(max(maxval - minval, 1))
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = mult * mult % span
        off = ((higher % span) * mult + lower % span) % span
        return (np.int32(minval) + off.astype(np.int32)).astype(np.int32)


def _fma32(a, b, c) -> np.ndarray:
    """float32 a·b + c with one rounding, as XLA's fused multiply-add (the
    product of two float32 values is exact in float64; the float64 sum is
    then rounded to float32)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _uniform(bits: np.ndarray, minval: float, maxval: float) -> np.ndarray:
    bits >>= np.uint32(32 - 23)
    bits |= np.uint32(0x3F800000)
    f = bits.view(np.float32)
    f -= _F32(1.0)
    lo, hi = _F32(minval), _F32(maxval)
    return np.maximum(lo, _fma32(f, hi - lo, lo))


def uniform(key, shape: Shape = (), minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _draw(key, shape, lambda b: _uniform(b, minval, maxval), np.float32)


def _log(v: np.ndarray) -> np.ndarray:
    """float32 log as XLA's CPU backend computes it (Cephes' logf: the
    mantissa m in [√½, √2), log(1 + (m − 1)) from a degree-8 polynomial,
    plus e·ln 2 in two parts), for v > 0."""
    v = np.maximum(v, np.array(0x00800000, np.uint32).view(np.float32))
    bits = v.view(np.uint32)
    e = _F32(1.0) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(np.float32)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(np.float32)
    below = m < _F32(0.707106781186547524)
    m = (m - _F32(1.0)) + np.where(below, m, _F32(0.0))
    e = e - np.where(below, _F32(1.0), _F32(0.0))
    x2 = m * m
    x3 = x2 * m
    c = [_F32(v) for v in _LOG_P]
    y = _fma32(m, c[0], c[1])
    y1 = _fma32(m, c[3], c[4])
    y2 = _fma32(m, c[6], c[7])
    y = _fma32(y, m, c[2])
    y1 = _fma32(y1, m, c[5])
    y2 = _fma32(y2, m, c[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, _F32(-2.12194440e-4) * e)
    m = _fma32(_F32(-0.5), x2, m)
    m = m + y
    return _fma32(_F32(0.693359375), e, m)


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
# log1p for |x| < √2 − 1: x − x²/2 + x³·P(x)/Q(x) (Cephes), highest degree last
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner(x: np.ndarray, coefs) -> np.ndarray:
    p = _F32(coefs[0])
    for c in coefs[1:]:
        p = _fma32(p, x, _F32(c))
    return p


def log1p(x) -> np.ndarray:
    """float32 log1p as XLA's CPU backend computes it: the rational form
    for |x| < √2 − 1, else log(x + 1)."""
    x = np.asarray(x, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        x2 = x * x
        small = _horner(x, _LOG1P_P) / _horner(x, _LOG1P_Q)
        small = x + (_F32(-0.5) * x2 + (x * x2) * small)
        large = _log(x + _F32(1.0))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large).astype(np.float32)


# XLA's single-precision erf⁻¹ (Giles' polynomial in w = −log1p(−x²),
# switching at w = 5), coefficients highest degree first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x) -> np.ndarray:
    """float32 erf⁻¹ as XLA computes it (fused multiply-adds in the
    polynomial): ±inf at ±1."""
    x = np.asarray(x, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        w = -log1p(x * -x)
        small = w < _F32(5.0)
        z = np.where(small, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
        p = np.where(small, _F32(_ERFINV_SMALL[0]), _F32(_ERFINV_LARGE[0]))
        for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
            p = _fma32(p, z, np.where(small, _F32(cs), _F32(cl)))
        out = p * x
        return np.where(np.abs(x) == _F32(1.0), x * _F32(np.inf), out).astype(np.float32)


# XLA's single-precision erf (a rational function of x², fused multiply-adds,
# clamped to ±1 beyond erf⁻¹(1 − 2⁻²⁴)), coefficients highest degree first
_ERF_P = (0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
          0.18520832239976145, 1.128379143519084)
_ERF_Q = (-1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
          0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0)
_ERF_CLAMP = 3.832506856900711


def erf(x) -> np.ndarray:
    """float32 erf after XLA's CPU backend (within a few ulp of it; equal at
    the ±2σ bounds that ``truncated_normal`` takes)."""
    x = np.asarray(x, dtype=np.float32)
    x2 = x * x
    out = (x * _horner(x2, _ERF_P) / _horner(x2, _ERF_Q)).astype(np.float32)
    return np.where(np.abs(x) <= _F32(_ERF_CLAMP), out,
                    np.copysign(_F32(1.0), x)).astype(np.float32)


_SQRT2 = _F32(np.sqrt(2))


def normal(key, shape: Shape = ()) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    return _draw(key, shape, lambda b: _SQRT2 * erf_inv(_uniform(b, lo, 1.0)), np.float32)


def truncated_normal(key, lower: float, upper: float, shape: Shape = ()) -> np.ndarray:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``:
    values in the open interval (lower, upper)."""
    lower, upper = _F32(lower), _F32(upper)
    a, b = erf(lower / _SQRT2), erf(upper / _SQRT2)
    lo, hi = np.nextafter(lower, _F32(np.inf)), np.nextafter(upper, _F32(-np.inf))
    return _draw(key, shape,
                 lambda bits: np.clip(_SQRT2 * erf_inv(_uniform(bits, a, b)), lo, hi),
                 np.float32)


def fold_in_static(key, data: Iterable[Union[str, int]]) -> np.ndarray:
    """flax's ``_fold_in_static`` (``flax/core/scope.py``): fold the first
    four bytes of the SHA-1 of the path's names and counters into ``key``."""
    data = tuple(data)
    if not data:
        return _u32(key)
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or str, got {x!r}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))
