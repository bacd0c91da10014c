"""``avenir_tpu_torch.utils.prng``, the port's numpy copy of
``jax.random``, held bit for bit against ``jax.random`` (jax 0.9.0's
partitionable threefry layout, 64-bit types off): keys, splits into 2 and
7, 32-bit random bits, ``randint`` over spans 1 to 10⁴ and past int32, and
float32 ``uniform``, for seeds that cover the int32 wrap."""

import numpy as np
import pytest

import jax

from avenir_tpu_torch.utils import prng

SEEDS = [0, 1, 42, -1, 2**31 - 1, 10**6, 2**31, -2**31]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("what", ["key", "split2", "split7", "bits",
                                  "randint", "randint_edges", "uniform"])
def test_prng_equals_jax_random(seed, what):
    jkey = jax.random.PRNGKey(seed)
    key = prng.prng_key(seed)
    if what == "key":
        pairs = [(jkey, key)]
    elif what == "split2":
        pairs = [(jax.random.split(jkey), prng.split(key))]
    elif what == "split7":
        pairs = [(jax.random.split(jkey, 7), prng.split(key, 7))]
    elif what == "bits":
        pairs = [(jax.random.bits(jkey, (3, 5), np.uint32),
                  prng.random_bits(key, (3, 5))),
                 (jax.random.bits(jkey, (1001,), np.uint32),
                  prng.random_bits(key, 1001))]
    elif what == "randint":
        pairs = [(jax.random.randint(jkey, (257,), 0, n),
                  prng.randint(key, 257, 0, n))
                 for n in (1, 2, 7, 1000, 10000)]
    elif what == "randint_edges":
        pairs = [(jax.random.randint(jkey, (9,), 5, 3),
                  prng.randint(key, 9, 5, 3)),
                 (jax.random.randint(jkey, (9,), -7, 2**31 - 1),
                  prng.randint(key, 9, -7, 2**31 - 1)),
                 (jax.random.randint(jkey, (4, 6), -50, 50),
                  prng.randint(key, (4, 6), -50, 50))]
    else:
        pairs = [(jax.random.uniform(jkey, (4, 33)), prng.uniform(key, (4, 33))),
                 (jax.random.uniform(jkey, (65,), minval=-2.0, maxval=3.0),
                  prng.uniform(key, 65, -2.0, 3.0))]
    for want, got in pairs:
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_split_chain_equals_jax():
    """The key chain a sampler walks (``key, sub = split(key)``)."""
    jkey, key = jax.random.PRNGKey(9), prng.prng_key(9)
    for _ in range(5):
        jkey, jsub = jax.random.split(jkey)
        key, sub = prng.split(key)
        np.testing.assert_array_equal(sub, np.asarray(jsub))
        np.testing.assert_array_equal(key, np.asarray(jkey))
