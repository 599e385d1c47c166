"""PCG4D streams of the PyTorch port against the JAX package.

The port must draw bit-identical uniforms from the same
(seed, pixel, sample, bounce, stream) counters, including counter values
at and above 2^31 (which a signed int32 cast would corrupt)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zraytrace_tpu import rng as jrng
from zraytrace_tpu_torch import rng as trng

torch.set_num_threads(1)

STREAMS = [jrng.STREAM_CAMERA, jrng.STREAM_SCATTER, jrng.STREAM_GENERIC]


def _counters(seed, n=4096):
    r = np.random.default_rng(seed)
    u32 = lambda: r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    pixel, sample, bounce = u32(), u32(), u32()
    # the edges of the range: 0, 2^31 - 1, 2^31, 2^32 - 1
    edges = np.array([0, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    pixel[:4], sample[4:8], bounce[8:12] = edges, edges, edges
    return pixel, sample, bounce


@pytest.mark.parametrize("stream", STREAMS, ids=["camera", "scatter", "generic"])
@pytest.mark.parametrize("seed", [42, 0, 2**31 + 5, 2**32 - 1])
def test_uniform4_bit_identical(stream, seed):
    """Exact equality: the streams are the port's contract with the
    reference, not a statistical property."""
    pixel, sample, bounce = _counters(seed % 1000)
    want = np.asarray(jrng.uniform4(seed, jnp.asarray(pixel), jnp.asarray(sample),
                                    jnp.asarray(bounce), stream))
    got = trng.uniform4(seed, torch.from_numpy(pixel.astype(np.int64)),
                        torch.from_numpy(sample.astype(np.int64)),
                        torch.from_numpy(bounce.astype(np.int64)), stream)
    assert got.dtype == torch.float32 and got.shape == (pixel.shape[0], 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform4_int32_counters_and_broadcast():
    """Counters as int32 tensors (how the wavefront holds them) and a
    scalar bounce broadcast the same way as the JAX function."""
    pixel, sample, _ = _counters(7, 1024)
    p32 = pixel.view(np.int32)  # ids >= 2^31 wrap to negative int32
    want = np.asarray(jrng.uniform4(42, jnp.asarray(p32), jnp.asarray(sample.view(np.int32)),
                                    3, jrng.STREAM_SCATTER))
    got = trng.uniform4(42, torch.from_numpy(p32.copy()),
                        torch.from_numpy(sample.view(np.int32).copy()), 3,
                        jrng.STREAM_SCATTER)
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform4_range():
    u = trng.uniform4(1, torch.arange(100000), 0, 0)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01


def test_random_unit_vector_matches_jax():
    """Same formula; cos/sin differ by at most an ulp between XLA and
    torch's CPU kernels, so the bar is 1e-6 absolute."""
    r = np.random.default_rng(3)
    u1, u2 = r.random(10000, dtype=np.float32), r.random(10000, dtype=np.float32)
    want = np.asarray(jrng.random_unit_vector(jnp.asarray(u1), jnp.asarray(u2)))
    got = trng.random_unit_vector(torch.from_numpy(u1), torch.from_numpy(u2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
