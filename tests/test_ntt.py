"""Matmul-NTT engine: exactness oracles.

Mirrors the reference's FFT-vs-naive oracle pattern (fft.zig:695-714,
814-846): every transform path is checked against the schoolbook negacyclic
product, and the NTT external product is checked bit-exactly against the
independent Toeplitz-matmul engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import params as P
from zig_tfhe_jax import trgsw as T
from zig_tfhe_jax.ops import ntt
from zig_tfhe_jax.ops.blind_rotate import external_product
from zig_tfhe_jax.ops.blind_rotate_ntt import external_product_ntt
from zig_tfhe_jax.ops.poly import negacyclic_polymul_naive, negacyclic_rotate


@pytest.mark.parametrize("N,dbound", [(64, 32), (1024, 32), (1024, 128)])
def test_ntt_polymul_exact_vs_naive(N, dbound):
    bound_bits = (N.bit_length() - 1) + dbound.bit_length() + 32
    plan = ntt.make_plan(N, bound_bits)
    rng = np.random.default_rng(N + dbound)
    a = rng.integers(-dbound, dbound, (3, N)).astype(np.int32)
    b = rng.integers(-2**31, 2**31, N).astype(np.int32)
    a_hat = ntt.ntt_forward(jnp.asarray(a), plan, 1, dbound)
    b_hat = ntt.to_ntt_form(jnp.asarray(b), plan)
    prods = [ntt.barrett_reduce(a_hat[i] * b_hat[i].astype(jnp.int32), p)
             for i, p in enumerate(plan.primes)]
    c = np.asarray(ntt.ntt_inverse_to_crt(prods, plan))
    for k in range(a.shape[0]):
        assert np.array_equal(c[k], negacyclic_polymul_naive(a[k], b))


def test_rotate_diag_matches_coefficient_rotation():
    N = 64
    plan = ntt.make_plan(N, 6 + 6 + 2)
    rng = np.random.default_rng(7)
    a = rng.integers(-32, 32, (5, N)).astype(np.int32)
    t = rng.integers(0, 2 * N, 5).astype(np.int32)
    a_hat = ntt.ntt_forward(jnp.asarray(a), plan, 1, 32)
    r_hat = ntt.rotate_diag(a_hat, jnp.asarray(t), plan, minus_one=False)
    c = np.asarray(ntt.ntt_inverse_to_crt(r_hat, plan))
    ref = np.asarray(negacyclic_rotate(jnp.asarray(a), jnp.asarray(t)))
    assert np.array_equal(c, ref)


def test_external_product_ntt_matches_toeplitz(tiny):
    """drop=0 NTT extprod must agree bit-exactly with the Toeplitz engine."""
    rng = np.random.default_rng(11)
    trgsw_ct = jnp.asarray(
        rng.integers(-2**31, 2**31,
                     (2 * tiny.L, 2, tiny.N)).astype(np.int32))
    ct = jnp.asarray(
        rng.integers(-2**31, 2**31, (4, 2, tiny.N)).astype(np.int32))
    plan = ntt.plan_for_params(tiny, 0)
    t_ntt = ntt.to_ntt_form(trgsw_ct, plan)            # [P, 2L, 2, N]
    out_ntt = np.asarray(external_product_ntt(t_ntt, ct, tiny, 0))
    ext_limbs = T.to_ext_limbs(trgsw_ct, T.N_KLIMBS)
    out_toep = np.asarray(external_product(ext_limbs, ct, tiny))
    assert np.array_equal(out_ntt, out_toep)


def test_barrett_reduce_full_range():
    rng = np.random.default_rng(3)
    for p in (12289, 18433, 40961, 59393, 61441):
        v = np.concatenate([
            rng.integers(-2**31, 2**31 - 1, 4096),
            np.array([0, 1, -1, 2**31 - 1, -2**31, p, -p, p // 2, -(p // 2)]),
        ]).astype(np.int32)
        r = np.asarray(ntt.barrett_reduce(jnp.asarray(v), p)).astype(np.int64)
        assert np.all((r - v.astype(np.int64)) % p == 0)
        assert np.all(np.abs(r) <= 0.55 * p)


def test_plan_prime_products_cover_bounds():
    for name in ("128bit", "80bit", "uint4", "tiny"):
        params = P.PARAMS_BY_NAME[name]
        for drop in (0, ntt.default_drop_bits(params)):
            plan = ntt.plan_for_params(params, drop)
            prod = 1.0
            for p in plan.primes:
                prod *= p
            bound = (2 * (2 * params.L) * params.N
                     * (1 << (params.bgbit - 1)) * (1 << (31 - drop)))
            assert prod >= 4 * bound, (name, drop, plan.primes)


def test_crt_margin_at_worst_case_magnitudes(tiny):
    """Drive the external product to its integer-magnitude bound: all
    digits at -Bg/2 and keys at the centered extreme.  Any CRT m-rounding
    slip would corrupt the result by ~P (gigantic), so exact equality with
    the Toeplitz engine is a sharp probe of the P/4 margin."""
    N, L = tiny.N, tiny.L
    # TRGSW rows all at the most-negative torus value (centered extreme)
    trgsw_ct = jnp.full((2 * L, 2, N), -(2**31), jnp.int32)
    # ciphertext whose gadget digits ALL hit -Bg/2: the decomposition adds
    # decomposition_offset internally, so x = -offset makes tmp = 0 and
    # every extracted digit exactly 0 - Bg/2 (self-checked below; the old
    # probe used x = sum(-Bg/2 h) - offset = -2*offset, whose digits are
    # near zero — it never actually stressed the margin)
    val = (-tiny.decomposition_offset) % (1 << 32)
    ct = jnp.full((2, 2, N), np.int32(np.uint32(val).view(np.int32)),
                  jnp.int32)
    from zig_tfhe_jax.ops.decomposition import gadget_decompose
    digs = np.asarray(gadget_decompose(ct, tiny))
    assert np.all(digs == -(1 << (tiny.bgbit - 1))), "probe not at worst case"
    plan = ntt.plan_for_params(tiny, 0)
    t_ntt = ntt.to_ntt_form(trgsw_ct, plan)
    out_ntt = np.asarray(external_product_ntt(t_ntt, ct, tiny, 0))
    out_toep = np.asarray(external_product(
        T.to_ext_limbs(trgsw_ct, T.N_KLIMBS), ct, tiny))
    assert np.array_equal(out_ntt, out_toep)


def test_residue_limb_pairs_match_plain_inverse():
    """ntt_inverse_to_crt must give identical results whether it receives
    whole residues or (lo8, hi8) pairs from residue_limbs, and the pairs
    must reconstruct the residue exactly."""
    plan = ntt.make_plan(1024, 45)
    Pn = plan.n_primes
    rng = np.random.default_rng(21)
    B, N = 8, 1024
    mk = lambda: [jnp.asarray(rng.integers(-31000, 31000, (B, 2, N))
                              .astype(np.int16)) for _ in range(Pn)]
    u1, u2, u12 = mk(), mk(), mk()
    t1 = jnp.asarray(rng.integers(0, 2 * N, B).astype(np.int32))
    t2 = jnp.asarray(rng.integers(0, 2 * N, B).astype(np.int32))

    v = ntt.rotate_combine2(u1, u2, u12, t1, t2, plan)
    v_pairs = [ntt.residue_limbs(x) for x in v]
    for (lo, hi), x in zip(v_pairs, v):
        rec = lo.astype(np.int32) + 256 * hi.astype(np.int32)
        assert np.array_equal(np.asarray(rec), np.asarray(x, np.int32))
    assert np.array_equal(np.asarray(ntt.ntt_inverse_to_crt(v, plan)),
                          np.asarray(ntt.ntt_inverse_to_crt(v_pairs, plan)))


def test_residue_bounds_within_barrett_envelope():
    """Every residue-producing stage must stay within the barrett bound
    |r| <= p(1/2 + 2^-6) — the invariant residue_limbs and the int8 limb
    splits rely on (hi limb must fit int8 for p <= 63000).  Key residues
    are drawn within each prime's own |k| <= p/2 contract."""
    plan = ntt.make_plan(1024, 45)
    rng = np.random.default_rng(5)
    digits = jnp.asarray(rng.integers(-32, 32, (4, 6, 1024)).astype(np.int32))
    d_hat = ntt.ntt_forward(digits, plan, 1, 32)
    for r, p in zip(d_hat, plan.primes):
        assert np.abs(np.asarray(r)).max() <= p * (0.5 + 2**-6)
    key = jnp.asarray(np.stack([
        rng.integers(-(p // 2), p // 2 + 1, (6, 2, 1024))
        for p in plan.primes]).astype(np.int16))
    u = ntt.pointwise_extprod(d_hat, key, plan)
    for r, p in zip(u, plan.primes):
        assert np.abs(np.asarray(r)).max() <= p * (0.5 + 2**-6)


def test_top_limb_bound_and_split_boundaries():
    """top_limb_bound must bound the actual top limb of i32_to_i8_limbs
    for every (digit_bound, limbs) combination in use, and residue_limbs
    must reconstruct exactly up to its documented |v| <= 32639 envelope."""
    from zig_tfhe_jax.utils.torus import i32_to_i8_limbs

    for bgbit, limbs in [(6, 1), (16, 2), (22, 3), (23, 3)]:
        bound = 1 << (bgbit - 1)
        tb = ntt.top_limb_bound(bound, limbs)
        xs = jnp.asarray(np.arange(-bound, bound, max(1, bound // 4096),
                                   dtype=np.int32))
        split = np.asarray(i32_to_i8_limbs(xs, limbs))
        assert np.abs(split[..., -1]).max() <= tb, (bgbit, limbs)
        # reconstruction is exact
        rec = sum(split[..., k].astype(np.int64) * (1 << (8 * k))
                  for k in range(limbs))
        mask = (1 << (8 * limbs)) - 1
        assert np.array_equal(rec & mask, np.asarray(xs, np.int64) & mask)

    v = jnp.asarray(np.array([-32639, -1, 0, 1, 32639], np.int32))
    lo, hi = ntt.residue_limbs(v)
    rec = lo.astype(np.int32) + 256 * hi.astype(np.int32)
    assert np.array_equal(np.asarray(rec), np.asarray(v))
