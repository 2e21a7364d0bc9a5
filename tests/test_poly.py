"""Negacyclic polynomial arithmetic vs the schoolbook oracle.

Mirrors the reference's FFT-vs-naive oracle tests (fft.zig:695-714,814-846)
— except our kernel must match EXACTLY (it is integer arithmetic, not FFT).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax.ops import poly


@pytest.mark.parametrize("N", [16, 64, 256])
def test_polymul_small_exact(rng, N):
    a = rng.integers(-32, 32, N).astype(np.int32)
    b = rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32)
    ref = poly.negacyclic_polymul_naive(a, b)
    got = np.asarray(poly.negacyclic_polymul(jnp.asarray(a), jnp.asarray(b), 32))
    assert np.array_equal(ref, got)


def test_polymul_large_digits_exact(rng):
    # Uint3-style digits: bgbit=23 -> |digit| < 2^22 (3 int8 limbs)
    N = 64
    a = rng.integers(-(1 << 22), 1 << 22, N).astype(np.int32)
    b = rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32)
    ref = poly.negacyclic_polymul_naive(a, b)
    got = np.asarray(poly.negacyclic_polymul(jnp.asarray(a), jnp.asarray(b), 1 << 22))
    assert np.array_equal(ref, got)


def test_polymul_binary_exact(rng):
    N = 64
    a = rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32)
    s = rng.integers(0, 2, N).astype(np.int32)
    ref = poly.negacyclic_polymul_naive(a, s)
    got = np.asarray(poly.negacyclic_polymul_binary(jnp.asarray(a), jnp.asarray(s)))
    assert np.array_equal(ref, got)


def test_rotate_identities(rng):
    # polyMulWithXK identities k in {0, 1, N, 2N} (trgsw.zig:757-795)
    N = 64
    p = rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32)
    pj = jnp.asarray(p)
    r0 = np.asarray(poly.negacyclic_rotate(pj, jnp.int32(0)))
    assert np.array_equal(r0, p)
    r1 = np.asarray(poly.negacyclic_rotate(pj, jnp.int32(1)))
    assert r1[0] == np.int32(0) - p[N - 1]
    assert np.array_equal(r1[1:], p[:-1])
    rN = np.asarray(poly.negacyclic_rotate(pj, jnp.int32(N)))
    assert np.array_equal(rN, -p)
    r2N = np.asarray(poly.negacyclic_rotate(pj, jnp.int32(2 * N)))
    assert np.array_equal(r2N, p)


def test_rotate_matches_polymul(rng):
    # X^k rotation == negacyclic multiply by the monomial X^k
    N = 32
    p = rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32)
    for k in [0, 3, 17, 31, 32, 45, 63]:
        mono = np.zeros(N, np.int32)
        if k < N:
            mono[k] = 1
            ref = poly.negacyclic_polymul_naive(mono, p)
        else:
            mono[k - N] = 1
            ref = np.int32(np.uint32((-poly.negacyclic_polymul_naive(mono, p).astype(np.int64)) & 0xFFFFFFFF))
        got = np.asarray(poly.negacyclic_rotate(jnp.asarray(p), jnp.int32(k)))
        assert np.array_equal(ref, got), k


def test_rotate_batched(rng):
    N = 32
    p = rng.integers(-2 ** 31, 2 ** 31, (5, 2, N)).astype(np.int32)
    ks = np.array([0, 7, 31, 40, 64], np.int32)
    got = np.asarray(poly.negacyclic_rotate(jnp.asarray(p), jnp.asarray(ks)))
    for i, k in enumerate(ks):
        exp_a = np.asarray(poly.negacyclic_rotate(jnp.asarray(p[i, 0]), jnp.int32(k)))
        exp_b = np.asarray(poly.negacyclic_rotate(jnp.asarray(p[i, 1]), jnp.int32(k)))
        assert np.array_equal(got[i, 0], exp_a)
        assert np.array_equal(got[i, 1], exp_b)


def test_toeplitz_structure(rng):
    N = 16
    p = rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32)
    T = np.asarray(poly.toeplitz(jnp.asarray(p)))
    for k in range(N):
        for n in range(N):
            exp = p[n - k] if n - k >= 0 else np.int32(0) - p[n - k + N]
            assert T[k, n] == np.int32(exp)


# ---------------------------------------------------------------------------
# width-64 limb-contraction paths (ops/poly.py routes every int64
# contraction through int8 limb matmuls; these oracles pin exactness
# mod 2^64)
# ---------------------------------------------------------------------------


def _naive_matmul_mod(a, b, width):
    mask = (1 << width) - 1
    out = (a.astype(object) @ b.astype(object))
    wrap = np.vectorize(lambda v: int(v) & mask, otypes=[object])
    out = wrap(out)
    sdt = np.int32 if width == 32 else np.int64
    to_signed = np.vectorize(
        lambda v: v - (1 << width) if v >= (1 << (width - 1)) else v,
        otypes=[object])
    return to_signed(out).astype(sdt)


def test_small_matmul_torus_width64_exact(rng):
    K, M = 37, 11
    small = rng.integers(-8, 8, (3, K)).astype(np.int64)
    mat = rng.integers(-2 ** 63, 2 ** 63, (K, M)).astype(np.int64)
    got = np.asarray(poly.small_matmul_torus(
        jnp.asarray(small), jnp.asarray(mat), 8, width=64))
    assert got.dtype == np.int64
    assert np.array_equal(got, _naive_matmul_mod(small, mat, 64))


def test_polymul_binary_int64_exact(rng):
    N = 32
    a = rng.integers(-2 ** 63, 2 ** 63, (2, N)).astype(np.int64)
    s = rng.integers(0, 2, N).astype(np.int64)
    got = np.asarray(poly.negacyclic_polymul_binary(
        jnp.asarray(a), jnp.asarray(s)))
    T = np.asarray(poly.toeplitz(jnp.asarray(s)))  # {0, 1, -1} int64
    assert np.array_equal(got, _naive_matmul_mod(a, T, 64))


def test_inner_product_binary_int64_exact(rng):
    from zig_tfhe_jax.tlwe import _inner_product_binary

    n = 53
    a = rng.integers(-2 ** 63, 2 ** 63, (4, n)).astype(np.int64)
    s = rng.integers(0, 2, n).astype(np.int64)
    got = np.asarray(_inner_product_binary(jnp.asarray(a), jnp.asarray(s)))
    exp = _naive_matmul_mod(a, s[:, None], 64)[:, 0]
    assert np.array_equal(got, exp)
