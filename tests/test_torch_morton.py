"""PyTorch port vs the JAX package, Morton codes and bitfield packing
(ops/morton.py): morton3d, morton3d_invert, packbits and unpackbits on
the same integer and float inputs (all exact: integer bit arithmetic),
and data/native.py's morton3d_cpu (the native library's
radnerf_morton3d) against the port's morton3d where the library loads,
None where it does not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnerf_tpu.ops import morton as jmo
from radnerf_tpu_torch.data import native
from radnerf_tpu_torch.ops import morton as tmo


def _coords(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 1024, (n, 3)).astype(np.int32)
    c[:4] = [[0, 0, 0], [1023, 1023, 1023], [1023, 0, 0], [0, 0, 1023]]
    return c


def test_morton3d_and_its_inverse_equal_jax():
    """Every bit of the 30-bit codes, the top one included (coords at
    1023 set bit 29: no sign bit is reached); the inverse restores the
    coords."""
    c = _coords()
    ref = np.asarray(jax.jit(jmo.morton3d)(c))
    got = tmo.morton3d(torch.from_numpy(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.max() == 2**30 - 1
    inv = tmo.morton3d_invert(got)
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(jax.jit(jmo.morton3d_invert)(ref)))
    np.testing.assert_array_equal(inv.numpy(), c)


def test_morton3d_invert_of_any_int32_equals_jax():
    """Indices over the whole int32 range, negatives too (the reference
    reads them as uint32; the inverse keeps the low 10 bits of each
    axis)."""
    rng = np.random.default_rng(1)
    idx = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    ref = np.asarray(jax.jit(jmo.morton3d_invert)(idx))
    got = tmo.morton3d_invert(torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", [(64,), (3, 512), (2, 2, 16**3)])
def test_packbits_and_unpackbits_equal_jax(shape):
    """Leading axes (cascades) kept; a threshold that sits on grid values
    (strictly greater packs)."""
    rng = np.random.default_rng(len(shape))
    grid = rng.uniform(0, 1, shape).astype(np.float32)
    grid.reshape(-1)[:5] = 0.5
    ref = np.asarray(jax.jit(lambda g: jmo.packbits(g, 0.5))(grid))
    got = tmo.packbits(torch.from_numpy(grid), 0.5)
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    bits = tmo.unpackbits(got)
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(jmo.unpackbits(jnp.asarray(ref))))
    np.testing.assert_array_equal(bits.numpy(), grid > 0.5)


def test_native_morton3d_cpu_equals_the_port():
    """The native library's radnerf_morton3d against ops/morton.py, or
    None where the library is unavailable (as in the reference)."""
    c = _coords(1024, seed=2)
    got = native.morton3d_cpu(c)
    if native.unavailable_reason() is None:
        np.testing.assert_array_equal(got, tmo.morton3d(
            torch.from_numpy(c)).numpy())
    else:
        assert got is None


def test_native_morton3d_cpu_is_none_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert native.morton3d_cpu(_coords(8)) is None
