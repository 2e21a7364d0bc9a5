"""Gadget / key-switch decomposition reconstruction exactness
(trgsw.zig:505-576 analog)."""

import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import params as P
from zig_tfhe_jax.ops.decomposition import gadget_decompose, ks_decompose


def _reference_gadget(x, p):
    """Direct transcription of the reference digit formula (trgsw.zig:207-218)."""
    u = (int(x) + p.decomposition_offset) % (1 << 32)
    mask = (1 << p.bgbit) - 1
    half = 1 << (p.bgbit - 1)
    return [((u >> (32 - (i + 1) * p.bgbit)) & mask) - half for i in range(p.L)]


@pytest.mark.parametrize("pname", ["128bit", "uint1", "uint3", "tiny"])
def test_gadget_digits_match_reference_formula(rng, pname):
    p = P.PARAMS_BY_NAME[pname]
    xs = rng.integers(-2 ** 31, 2 ** 31, 512).astype(np.int32)
    digs = np.asarray(gadget_decompose(jnp.asarray(xs), p))
    for i, x in enumerate(xs):
        assert list(digs[i]) == _reference_gadget(x, p)


@pytest.mark.parametrize("pname", ["128bit", "uint3"])
def test_gadget_reconstruction(rng, pname):
    # sum_i d_i * 2^(32-(i+1)*bgbit) reconstructs x within 2^(32-L*bgbit-1)
    p = P.PARAMS_BY_NAME[pname]
    xs = rng.integers(-2 ** 31, 2 ** 31, 512).astype(np.int32)
    digs = np.asarray(gadget_decompose(jnp.asarray(xs), p)).astype(np.int64)
    recon = sum(digs[:, i] << (32 - (i + 1) * p.bgbit) for i in range(p.L))
    err = (recon - xs.astype(np.int64)) % (1 << 32)
    err = np.where(err >= 1 << 31, err - (1 << 32), err)
    # the offset trick truncates: error is one-sided in (-2^(32-L*bgbit), 0]
    bound = 1 << (32 - p.L * p.bgbit) if p.L * p.bgbit < 32 else 1
    assert np.all(err <= 0) and np.all(err > -bound)


def test_ks_reconstruction(rng):
    p = P.SECURITY_128_BIT
    xs = rng.integers(-2 ** 31, 2 ** 31, 512).astype(np.int32)
    digs = np.asarray(ks_decompose(jnp.asarray(xs), p.basebit, p.iks_t)).astype(np.int64)
    assert digs.min() >= -(1 << (p.basebit - 1))
    assert digs.max() < (1 << (p.basebit - 1))
    recon = sum(digs[:, j] << (32 - (j + 1) * p.basebit) for j in range(p.iks_t))
    err = (recon - xs.astype(np.int64)) % (1 << 32)
    err = np.where(err >= 1 << 31, err - (1 << 32), err)
    assert np.all(np.abs(err) <= 1 << (32 - p.basebit * p.iks_t - 1))
