"""A numpy copy of the parts of ``jax.random`` that the JAX package draws
with: the counterpart of ``jax.random`` as the reference uses it, so that a
seeded sampler, bagged forest or undersampler of the port draws the same
numbers as the JAX package does.

The layout copied is jax 0.9.0's with ``jax_threefry_partitionable = True``
(that release's default) and 64-bit types off:

- :func:`threefry2x32` is the Threefry-2x32 block cipher of
  ``jax/_src/prng.py`` (``_threefry2x32_lowering``): 20 rounds, rotations
  (13, 15, 26, 6) and (17, 29, 16, 24), a key injection after every four.
- :func:`prng_key` is ``jax.random.PRNGKey``: the seed as int32 (Python
  ints wrap to 32 bits, as ``jnp.asarray`` does with x64 off), the key
  ``(seed >>> 32, seed & 0xFFFFFFFF)`` with the shift taken on the int32,
  so the high word is 0.
- :func:`split` is ``_threefry_split_foldlike``: the key enciphers the
  64-bit counters ``0 .. num-1`` (high word, low word) and each child key
  is the pair of output words.  It is not Threefry of ``iota(2·num)``,
  which was the layout before the partitionable one.
- :func:`random_bits` is ``_threefry_random_bits_partitionable`` at 32
  bits: ``bits1 ^ bits2`` of the row-major counters of ``shape``.
- :func:`randint` is ``random._randint`` for int32: two bit draws from
  ``split(key)``, ``span`` and the multiplier ``2**32 mod span`` in
  wrapping uint32, and ``span = 1`` where ``maxval <= minval``.
- :func:`uniform` is ``random._uniform`` for float32: the top 23 bits as
  the mantissa of a float in [1, 2), minus 1, then ``u·(max−min) + min``,
  which XLA on the CPU fuses into one multiply-add: it is taken here in
  float64 and rounded once (the product is exact there).
- :func:`gumbel` is ``random._gumbel`` in its default ``"low"`` mode,
  ``-log(-log(uniform(key, shape, tiny, 1)))`` in float32: the uniform
  bits are :func:`uniform`'s, bit for bit, but each ``log`` is taken in
  float64 and rounded once to float32, where XLA's float32 ``log`` is a
  polynomial of its own.  The values stay within abs 1e-6 of
  ``jax.random.gumbel``'s, not bit for bit.
- :func:`categorical` is ``random.categorical`` with ``replace=True`` on
  the last axis: the first maximum of ``gumbel(key, logits.shape) +
  logits``.  Its indices equal ``jax.random``'s except where two entries
  lie within about 1e-6 of each other.

A JAX release that changes this layout makes the two packages draw
different numbers; ``tests/test_torch_prng.py`` holds every function here
against ``jax.random`` and fails first.  All arithmetic is uint32 numpy on
the host: the draws are cheap beside the work they index, and the host
keeps them the same on every device.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

_U32 = np.uint32
_MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(d) for d in shape)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words ``(x1, x2)`` (uint32 arrays of one
    shape) under the key ``(k1, k2)``; → the two enciphered words."""
    ks = (_U32(k1), _U32(k2), _U32(int(k1) ^ int(k2) ^ _PARITY))
    with np.errstate(over="ignore"):
        a = np.asarray(x1, _U32) + ks[0]
        b = np.asarray(x2, _U32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` → uint32 ``[2]``."""
    s32 = int(np.int64(seed).astype(np.int32))      # jnp.asarray with x64 off
    return np.array([0, s32 & _MASK32], _U32)


def _counters(shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """``iota_2x32_shape``: the row-major index of every element as a 64-bit
    counter, split into (high, low) uint32 words."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(_U32),
            (idx & np.uint64(_MASK32)).astype(_U32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` → uint32 ``[num, 2]``."""
    hi, lo = _counters((int(num),))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(key: np.ndarray, shape: Shape) -> np.ndarray:
    """32 uniform random bits per element of ``shape`` → uint32."""
    hi, lo = _counters(_shape(shape))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def randint(key: np.ndarray, shape: Shape, minval: int, maxval: int
            ) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) →
    int32 draws from [minval, maxval), biased as JAX's are where the span
    is not a power of two."""
    shape = _shape(shape)
    info = np.iinfo(np.int32)
    out_of_range = maxval > info.max
    lo_v = int(np.clip(minval, info.min, info.max))
    hi_v = int(np.clip(maxval, info.min, info.max))
    k1, k2 = split(key)
    higher = random_bits(k1, shape).astype(np.uint64)
    lower = random_bits(k2, shape).astype(np.uint64)
    span = (hi_v - lo_v) & _MASK32
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & _MASK32
    if span == 0:                  # the full 2**32 range: the bits themselves
        offset = lower
    else:
        mult = (1 << 16) % span
        mult = ((mult * mult) & _MASK32) % span
        offset = ((((higher % np.uint64(span)) * np.uint64(mult))
                   + (lower % np.uint64(span))) & np.uint64(_MASK32))
        offset = offset % np.uint64(span)
    return ((np.int64(lo_v) + offset.astype(np.int64)).astype(np.int64)
            & _MASK32).astype(_U32).view(np.int32)


def uniform(key: np.ndarray, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` (float32)."""
    bits = random_bits(key, shape)
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32)
    floats = floats - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    fused = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fused.astype(np.float32))


def gumbel(key: np.ndarray, shape: Shape) -> np.ndarray:
    """``jax.random.gumbel(key, shape)`` (float32, ``mode="low"``), each
    ``log`` correctly rounded to float32 (see the module docstring)."""
    u = uniform(key, shape, float(np.finfo(np.float32).tiny), 1.0)
    inner = np.log(u.astype(np.float64)).astype(np.float32)
    return -np.log(-inner.astype(np.float64)).astype(np.float32)


def categorical(key: np.ndarray, logits: np.ndarray) -> np.ndarray:
    """``jax.random.categorical(key, logits)`` over the last axis → int64
    indices, the first maximum of the perturbed logits."""
    logits = np.asarray(logits)
    perturbed = gumbel(key, logits.shape) + logits.astype(np.float32)
    return np.argmax(perturbed, axis=-1)
