"""The port's counter RNG against the reference, bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu_torch.core import rng as trng

torch.set_num_threads(1)


def _grid():
    """(lane, sample, slot, seed) words including values >= 2^31."""
    r = np.random.default_rng(0)
    n = 4096
    big = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0x9E3779B9], np.uint64)
    cols = []
    for k in range(4):
        c = r.integers(0, 2**32, n, dtype=np.uint64)
        c[: len(big)] = np.roll(big, k)
        cols.append(c.astype(np.uint32))
    return cols


def _t(a):
    return torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64))


def test_pcg4d_bit_exact():
    lane, sample, slot, seed = _grid()
    v = np.stack([lane, sample, slot, seed], axis=-1)
    ref = np.asarray(jrng.pcg4d(jnp.asarray(v)))
    out = trng.pcg4d(_t(v)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("fn", ["rand4", "rand2", "rand1"])
def test_rand_bit_exact(fn):
    lane, sample, slot, seed = _grid()
    ref = np.asarray(getattr(jrng, fn)(
        jnp.asarray(lane), jnp.asarray(sample), jnp.asarray(slot),
        jnp.asarray(seed),
    ))
    out = getattr(trng, fn)(_t(lane), _t(sample), _t(slot), _t(seed)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_rand4_scalar_broadcast():
    """Scalar slot / seed broadcast against lane tensors as in the bounce
    loop, with per-lane slots from a depth vector."""
    lane = np.arange(1000, dtype=np.uint32) * 7919 + 2**31
    depth = (np.arange(1000) % 16).astype(np.int32)
    slot = depth * 4 + 1
    ref = np.asarray(jrng.rand4(jnp.asarray(lane), 5, jnp.asarray(slot), 3))
    out = trng.rand4(_t(lane), 5, torch.as_tensor(slot), 3).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 + 5, 2**32 - 1])
@pytest.mark.parametrize("stream", [jrng.STREAM_PATH, jrng.STREAM_CAMERA, jrng.STREAM_WEAVE])
def test_stream_seed_bit_exact(seed, stream):
    ref = int(np.asarray(jrng.stream_seed(np.uint32(seed), stream)))
    out = int(trng.stream_seed(seed, stream))
    assert out == ref
