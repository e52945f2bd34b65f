"""The port's QMC stream (libyafaray_tpu_torch/core/qmc.py) against the JAX
reference (libyafaray_tpu/core/qmc.py): bit-identical words and floats over
65,536 lanes with random sample indices and pixel hashes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libyafaray_tpu.core import qmc as ref
from libyafaray_tpu_torch.core import qmc


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest (and keeps parallel test workers off each other's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N_LANES = 65536


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(20240611)
    idx = rng.integers(0, 2 ** 32, N_LANES, dtype=np.uint64).astype(np.uint32)
    idx[:256] = np.arange(256)  # the small indices a render actually uses
    key = rng.integers(0, 2 ** 32, N_LANES, dtype=np.uint64).astype(np.uint32)
    return idx, key


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> the port's int32 words."""
    return qmc.u32(torch.from_numpy(a.astype(np.int64)))


def _np(x: torch.Tensor) -> np.ndarray:
    """The port's int32 words -> uint32 numpy."""
    return (x.to(torch.int64) & 0xFFFFFFFF).numpy().astype(np.uint32)


def test_hash_u32_bit_identical(lanes):
    idx, key = lanes
    for a in (idx, key):
        assert np.array_equal(_np(qmc.hash_u32(_t(a))),
                              np.asarray(ref.hash_u32(a)))


def test_hash_combine_bit_identical(lanes):
    idx, key = lanes
    assert np.array_equal(_np(qmc.hash_combine(_t(key), _t(idx))),
                          np.asarray(ref.hash_combine(key, idx)))


def test_reverse_bits_and_scramble_bit_identical(lanes):
    idx, key = lanes
    assert np.array_equal(_np(qmc.reverse_bits32(_t(idx))),
                          np.asarray(ref.reverse_bits32(idx)))
    assert np.array_equal(
        _np(qmc.nested_uniform_scramble(_t(idx), _t(key))),
        np.asarray(ref.nested_uniform_scramble(idx, key)))


@pytest.mark.parametrize("dim", [0, 2, 4, 6, 8])
def test_sample_dim_pair_bit_identical(lanes, dim):
    idx, key = lanes
    r0, r1 = ref.sample_dim_pair(jnp.asarray(idx), dim, jnp.asarray(key))
    p0, p1 = qmc.sample_dim_pair(_t(idx), dim, _t(key))
    for r, p in ((r0, p0), (r1, p1)):
        assert p.dtype == torch.float32
        assert np.array_equal(np.asarray(r), p.numpy())
        assert 0.0 <= float(p.min()) and float(p.max()) < 1.0


@pytest.mark.parametrize("dim", [0, 1, 5, 8, 11])
def test_sample_dim_bit_identical(lanes, dim):
    """One static dimension, odd or even (the photon passes' sampler), and
    the component of the pair it belongs to."""
    idx, key = lanes
    r = ref.sample_dim(jnp.asarray(idx), dim, jnp.asarray(key))
    p = qmc.sample_dim(_t(idx), dim, _t(key))
    assert p.dtype == torch.float32
    assert np.array_equal(np.asarray(r), p.numpy())
    pair = qmc.sample_dim_pair(_t(idx), dim - dim % 2, _t(key))
    assert torch.equal(p, pair[dim % 2])


def test_dynamic_sample_dim_bit_identical(lanes):
    """The deep-bounce sampler converts the full 32-bit word to float32;
    words within 128 of 2^32 round to exactly 1.0 there, and must round
    the same way in the port."""
    idx, key = lanes
    for dim in range(4, 4 + 6 * 5):
        r = ref.dynamic_sample_dim(jnp.asarray(idx), jnp.uint32(dim),
                                   jnp.asarray(key))
        p = qmc.dynamic_sample_dim(_t(idx), dim, _t(key))
        assert np.array_equal(np.asarray(r), p.numpy()), dim
    top = np.array([2 ** 32 - 1, 2 ** 32 - 128, 2 ** 32 - 129, 2 ** 31],
                   np.uint32)
    assert np.array_equal(
        qmc.u32_to_float(_t(top)).numpy(),
        np.asarray(jnp.asarray(top).astype(jnp.float32)))
