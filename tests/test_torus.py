"""Torus codec and int8 limb recode exactness."""

import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax.utils.torus import (
    f64_to_torus, i32_to_i8_limbs, torus_to_f64, to_i32,
)


def test_f64_to_torus_reference_values():
    # utils.zig:28-33 semantics
    assert np.uint32(f64_to_torus(0.125)) == np.uint32(1 << 29)
    assert np.uint32(f64_to_torus(-0.125)) == np.uint32(7 * (1 << 29))
    assert np.uint32(f64_to_torus(0.0)) == 0
    assert np.uint32(f64_to_torus(0.25)) == np.uint32(1 << 30)
    assert np.uint32(f64_to_torus(-0.25)) == np.uint32(3 * (1 << 30))
    assert np.uint32(f64_to_torus(1.0)) == 0  # mod 1


def test_torus_roundtrip():
    vals = [0.0, 0.125, 0.25, 0.5, 0.75, 0.9999]
    for v in vals:
        t = f64_to_torus(v)
        assert abs(torus_to_f64(t) - v) < 2 ** -31


def test_i8_limb_recode_exact(rng):
    x = rng.integers(-2 ** 31, 2 ** 31, 4096).astype(np.int32)
    limbs = np.asarray(i32_to_i8_limbs(jnp.asarray(x), 4)).astype(np.int64)
    recon = sum(limbs[:, k] << (8 * k) for k in range(4))
    assert np.array_equal(np.uint32(recon & 0xFFFFFFFF), np.uint32(x.astype(np.int64) & 0xFFFFFFFF))
    assert limbs.min() >= -128 and limbs.max() <= 127


def test_i8_limb_partial_width(rng):
    # 1-limb recode of small values is the identity
    x = rng.integers(-100, 100, 256).astype(np.int32)
    limbs = np.asarray(i32_to_i8_limbs(jnp.asarray(x), 1))
    assert np.array_equal(limbs[:, 0], x.astype(np.int8))
