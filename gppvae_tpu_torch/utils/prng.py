"""The JAX package's random stream, on the host in numpy.

The JAX package draws every random number from threefry2x32 keys
(jax.random): the run key PRNGKey(seed), its splits and fold-ins, and the
samplers on top of them. This module computes the same draws bit for bit
without jax, so that `--seed s` in the port trains, generates and serves
what the JAX package does at seed s. It reproduces jax 0.9.0 with its
defaults: `jax_default_prng_impl = threefry2x32`,
`jax_threefry_partitionable = True`, and `jax_enable_x64 = False` (the
JAX package's production setting: a Python seed is taken mod 2³², and
`randint` draws int32).

A key is a uint32 array of shape (..., 2); the functions that take one key
also take a stack of keys (K, 2) where the docstring says so, and draw for
all of them in one vectorised pass (an epoch's ε per step, for instance).

  PRNGKey, split, fold_in    key derivation (jax.random's)
  random_bits                32-bit draws under the partitionable scheme
  uniform, normal            float32 (normal through XLA's float32 erf⁻¹)
  truncated_normal, randint  flax's lecun init, generate's cell draws
  permutation                the shuffle by rounds of stable sorts on keys
  fold_in_str                flax's derivation of a parameter's key

Equality with jax.random is bit for bit for keys, bits, uniform, normal,
randint and permutation. XLA's CPU code contracts a·b + c into one fused
multiply-add, so `uniform`'s scaling and the polynomials of `erfinv` (with
XLA's own float32 log1p and log) are written with `fma`. `normal` looks its
values up in a table of all 2²³ it can take, built once per process, so
that an epoch's draws cost a hash and a gather. truncated_normal
takes erf of its bounds from Python's math.erf rounded to float32: equal
to XLA's at (−2, 2), the bounds of flax's lecun init, the only ones the
port draws at; elsewhere the two can differ in the bounds' last bit.
"""

from __future__ import annotations

import functools
import hashlib
import math

import numpy as np

_U32 = np.uint32
_F32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x1, x2) under
    the key words (k1, k2); every argument a uint32 array, broadcast. Each
    round rotates in place (b ← rotl(b, r) ^ (a += b)) on two buffers."""
    shape = np.broadcast_shapes(np.shape(k1), np.shape(k2), np.shape(x1), np.shape(x2))
    # at least 1-D: uint32 sums of arrays wrap silently, of scalars they warn
    k1, k2 = np.atleast_1d(np.asarray(k1, _U32)), np.atleast_1d(np.asarray(k2, _U32))
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    a, b, t = (np.empty(shape or (1,), _U32) for _ in range(3))
    np.add(np.asarray(x1, _U32), ks[0], out=a)
    np.add(np.asarray(x2, _U32), ks[1], out=b)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            np.add(a, b, out=a)
            np.left_shift(b, _U32(r), out=t)
            np.right_shift(b, _U32(32 - r), out=b)
            np.bitwise_or(b, t, out=b)
            np.bitwise_xor(b, a, out=b)
        np.add(a, ks[(i + 1) % 3], out=a)
        np.add(b, ks[(i + 2) % 3] + _U32(i + 1), out=b)
    return a.reshape(shape), b.reshape(shape)


def _key(key) -> np.ndarray:
    key = np.asarray(key)
    if key.dtype != _U32 or key.shape[-1:] != (2,):
        raise TypeError(f"want a uint32 key of shape (..., 2); got {key.dtype} {key.shape}")
    return key


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) with x64 off: [0, seed mod 2³²]."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) keys."""
    k = _key(key)
    a, b = threefry2x32(k[0], k[1], np.zeros(num, _U32), np.arange(num, dtype=_U32))
    return np.stack([a, b], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data): the hash of the count pair
    (0, data mod 2³²). `key` may be a stack (..., 2)."""
    k = _key(key)
    a, b = threefry2x32(k[..., 0], k[..., 1], _U32(0), _U32(int(data) & 0xFFFFFFFF))
    return np.stack([a, b], axis=-1)


def fold_in_str(key, *data: str | int) -> np.ndarray:
    """flax's `_fold_in_static` (flax_fix_rng_separator off): fold in the
    first 4 bytes of the SHA-1 of the names and counters, big-endian."""
    m = hashlib.sha1()
    for x in data:
        m.update(x.encode() if isinstance(x, str) else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def random_bits(key, shape) -> np.ndarray:
    """jax.random.bits(key, shape) (uint32, partitionable): element i is
    the xor of the hash of the count pair (i // 2³², i mod 2³²). A stack of
    keys (K, 2) gives (K, *shape)."""
    k = _key(key)
    shape = tuple(shape)
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    lo, hi = (idx & 0xFFFFFFFF).astype(_U32), (idx >> 32).astype(_U32)
    k1, k2 = k[..., 0, None], k[..., 1, None]
    a, b = threefry2x32(k1, k2, hi, lo)
    return (a ^ b).reshape(k.shape[:-1] + shape)


def _unit_floats(bits: np.ndarray) -> np.ndarray:
    """[0, 1) float32 from 32 random bits: 23 mantissa bits over 1.0, − 1."""
    return ((bits >> _U32(9)) | _U32(0x3F800000)).view(_F32) - _F32(1.0)


def _fma_exact(ab: np.ndarray, c: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Round the float64 sum s = ab + c to odd (TwoSum's error nudges an
    inexact even result one step towards it), so that rounding it to
    float32 is the single correct rounding of ab + c."""
    v = s - ab
    err = (ab - (s - v)) + (c - v)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(_F32)


def fma(a, b, c) -> np.ndarray:
    """float32 a·b + c rounded once, as XLA's CPU code contracts it. a·b is
    exact in float64, and the float64 sum rounds to float32 correctly
    unless it lies exactly half-way between two floats (its low 29 bits
    1000…0), where it may have been rounded there: those few are redone
    exactly."""
    ab = np.multiply(a, b, dtype=np.float64)
    s = ab + c
    out = s.astype(_F32)
    tie = (s.view(np.int64) & 0x1FFFFFFF) == 0x10000000
    if tie.any():
        c = np.broadcast_to(np.asarray(c, np.float64), s.shape)
        out[tie] = _fma_exact(ab[tie], c[tie], s[tie])
    return out


def _scaled(bits: np.ndarray, lo, hi) -> np.ndarray:
    """uniform's float32 on [lo, hi) from 32 random bits."""
    lo, hi = _F32(lo), _F32(hi)
    return np.maximum(lo, fma(_unit_floats(bits), hi - lo, lo))


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    return _scaled(random_bits(key, shape), minval, maxval)


def _polynomial(x: np.ndarray, coeffs) -> np.ndarray:
    """Horner's rule with fused steps, highest degree first."""
    p = np.full(x.shape, _F32(coeffs[0]))
    for c in coeffs[1:]:
        p = fma(p, x, _F32(c))
    return p


# XLA's float32 log1p: for |y| < √2 − 1 Cephes's rational approximation,
# else log(1 + y) by its vectorised float32 log (Cephes's, as Eigen's plog)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = tuple(map(_F32, (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)))


def _log(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log of positive normal x."""
    bits = x.view(np.int32)
    e = ((bits >> 23) - 127).astype(_F32) + _F32(1.0)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(_F32)  # mantissa in [0.5, 1)
    low = m < _F32(0.707106781186547524)
    e -= low
    x = (m - _F32(1.0)) + np.where(low, m, _F32(0.0))
    x2 = x * x
    x3 = x2 * x
    y = _polynomial(x, _LOG_P[0:3])
    y1 = _polynomial(x, _LOG_P[3:6])
    y2 = _polynomial(x, _LOG_P[6:9])
    y = fma(fma(fma(y, x3, y1), x3, y2), x3, e * _F32(-2.12194440e-4))
    x = fma(-x2, _F32(0.5), x) + y
    return fma(e, _F32(0.693359375), x)


def log1p(y: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log1p of y > −1, each branch on its own rows."""
    y = np.asarray(y, _F32)
    out = np.empty_like(y)
    small = np.abs(y) < _F32(0.41421356237309504880)
    ys = y[small]
    y2 = ys * ys
    r = _polynomial(ys, _LOG1P_NUM) / _polynomial(ys, _LOG1P_DEN)
    out[small] = ys + fma(_F32(-0.5), y2, (ys * y2) * r)
    out[~small] = _log(y[~small] + _F32(1.0))
    return out


# XLA's float32 erf⁻¹ (M. Giles, "Approximating the erfinv function"), as
# the chlo → stablehlo lowering expands it: one polynomial in
# w = −log1p(−x²) for w < 5, one in √w beyond
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 erf⁻¹ of x in [−1, 1], ±inf at ±1."""
    x = np.asarray(x, _F32)
    w = -log1p(x * -x)
    out = np.empty_like(x)
    small = w < _F32(5.0)
    out[small] = _polynomial(w[small] - _F32(2.5), _ERFINV_SMALL) * x[small]
    large = ~small
    with np.errstate(invalid="ignore"):  # ±1 gives w = inf
        out[large] = _polynomial(np.sqrt(w[large]) - _F32(3.0), _ERFINV_LARGE) * x[large]
    one = np.abs(x) == _F32(1.0)
    out[one] = x[one] * _F32(np.inf)
    return out


_SQRT2 = _F32(math.sqrt(2.0))
_NORMAL_LO = np.nextafter(_F32(-1.0), _F32(0.0))


@functools.cache
def _normal_table() -> np.ndarray:
    """√2·erf⁻¹(u) for each of the 2²³ values u that `normal` can draw
    (u is a function of the 23 random bits it keeps), 32 MB, built once
    per process in chunks (~2 s); read-only."""
    table = np.empty(1 << 23, _F32)
    for start in range(0, 1 << 23, 1 << 20):
        bits = np.arange(start, start + (1 << 20), dtype=_U32) << _U32(9)
        table[start:start + (1 << 20)] = _SQRT2 * erfinv(_scaled(bits, _NORMAL_LO, 1.0))
    table.setflags(write=False)
    return table


def normal(key, shape) -> np.ndarray:
    """jax.random.normal(key, shape, float32): √2·erf⁻¹(u), u uniform on
    (nextafter(−1, 0), 1), looked up by u's 23 random bits in
    `_normal_table`. A stack of keys (K, 2) gives (K, *shape)."""
    return _normal_table()[random_bits(key, shape) >> _U32(9)]


def truncated_normal(key, lower: float, upper: float, shape) -> np.ndarray:
    """jax.random.truncated_normal(key, lower, upper, shape, float32)."""
    lower, upper = _F32(lower), _F32(upper)
    a = _F32(math.erf(float(lower / _SQRT2)))
    b = _F32(math.erf(float(upper / _SQRT2)))
    out = _SQRT2 * erfinv(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(lower, _F32(np.inf)), np.nextafter(upper, _F32(-np.inf)))


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval) as int32 (x64 off):
    two 32-bit draws per value, reduced mod the span."""
    if not -2**31 <= minval <= maxval <= 2**31 - 1:
        raise ValueError(f"randint range [{minval}, {maxval}) is not int32 with min ≤ max")
    k1, k2 = split(key)
    hi_bits, lo_bits = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(max(maxval - minval, 1))
    with np.errstate(over="ignore"):
        mult = _U32((_U32(2**16) % span) * (_U32(2**16) % span) % span)
        off = ((hi_bits % span) * mult + lo_bits % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def permutation(key, x) -> np.ndarray:
    """jax.random.permutation(key, x): x an int n (a shuffle of arange(n),
    int32) or a 1-D array (its entries shuffled). ⌈3·ln n / ln(2³²−1)⌉
    rounds, each a stable sort of the entries on 32 fresh random bits."""
    x = np.arange(x, dtype=np.int32) if np.ndim(x) == 0 else np.asarray(x)
    rounds = int(np.ceil(3 * np.log(max(1, x.size)) / np.log(2**32 - 1)))
    key = _key(key)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, x.shape), kind="stable")]
    return x
