"""LUT / programmable bootstrapping (lut/ package analog + real
bootstrap_lut, which the reference documents but never shipped)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import lut as L


def test_div_round():
    # generator.zig:337-356
    assert L.div_round(5, 2) == 3
    assert L.div_round(4, 2) == 2
    assert L.div_round(3, 2) == 2
    assert L.div_round(1, 2) == 1
    assert L.div_round(0, 2) == 0


def test_encoder_roundtrip():
    for m in [2, 4, 8, 32]:
        enc = L.Encoder.new(m)
        for x in range(m):
            assert enc.decode(enc.encode(x)) == x
    enc2 = L.Encoder.new(2)
    assert enc2.decode_bool(enc2.encode(1))
    assert not enc2.decode_bool(enc2.encode(0))


def test_generator_shapes(tiny):
    g = L.Generator.new(2, tiny)
    assert g.message_modulus == 2
    assert g.poly_degree == tiny.N
    assert g.lookup_table_size == tiny.N
    table = g.generate_lookup_table(lambda x: x)
    assert not table.is_empty()
    table.clear()
    assert table.is_empty()


def test_mod_switch_range(tiny):
    g = L.Generator.new(2, tiny)
    for x in [0, (1 << 31), (1 << 32) - 1]:
        assert 0 <= g.mod_switch(x) < g.lookup_table_size


@pytest.mark.parametrize("m,f", [
    (2, lambda x: x),            # identity
    (2, lambda x: 1 - x),        # NOT
    (4, lambda x: (x + 1) % 4),  # increment
    (4, lambda x: (x * 3) % 4),
    (8, lambda x: (x * x) % 8),  # square
])
def test_bootstrap_lut_exact(tiny, tiny_sk, tiny_ck, m, f):
    g = L.Generator.new(m, tiny)
    table = g.generate_lookup_table(f)
    msgs = jnp.arange(m)
    ct = tlwe.encrypt_message(jax.random.key(51), msgs, m, 0.0, tiny_sk.key_lv0)
    out = L.bootstrap_lut(ct, table, tiny_ck)
    dec = np.asarray(tlwe.decrypt_message(out, m, tiny_sk.key_lv0))
    assert np.array_equal(dec, np.array([f(x) for x in range(m)]))


def test_bootstrap_lut_per_lane_testvecs(tiny, tiny_sk, tiny_ck):
    # heterogeneous batch: lane 0 applies identity, lane 1 applies NOT
    m = 2
    g = L.Generator.new(m, tiny)
    tv = jnp.stack([g.generate_lookup_table(lambda x: x).as_jax(),
                    g.generate_lookup_table(lambda x: 1 - x).as_jax()])
    msgs = jnp.asarray([1, 1])
    ct = tlwe.encrypt_message(jax.random.key(52), msgs, m, 0.0, tiny_sk.key_lv0)
    out = L.bootstrap_lut(ct, tv, tiny_ck)
    dec = np.asarray(tlwe.decrypt_message(out, m, tiny_sk.key_lv0))
    assert list(dec) == [1, 0]


def test_generate_lookup_table_full(tiny, tiny_sk, tiny_ck):
    # full-control variant returning raw torus values (generator.zig:155-191)
    m = 2
    g = L.Generator.new(m, tiny)
    enc = L.Encoder.new(m)
    table = g.generate_lookup_table_full(lambda x: enc.encode(1 - x))
    ct = tlwe.encrypt_message(jax.random.key(53), jnp.arange(m), m, 0.0,
                              tiny_sk.key_lv0)
    out = L.bootstrap_lut(ct, table, tiny_ck)
    dec = np.asarray(tlwe.decrypt_message(out, m, tiny_sk.key_lv0))
    assert list(dec) == [1, 0]


def test_bootstrap_lut_m16_multilimb_digits():
    """m=16 LUT at TEST_TINY_UINT (bgbit=11 -> 2-limb digit path, basebit=4)."""
    import jax
    from zig_tfhe_jax import params as P, key as K
    p = P.TEST_TINY_UINT
    assert p.digit_limbs == 2
    sk = K.SecretKey.generate(jax.random.key(200), p)
    ck = K.CloudKey.generate(jax.random.key(201), sk, p)
    m = 16
    g = L.Generator.new(m, p)
    f = lambda x: (x * x + 3) % m
    table = g.generate_lookup_table(f)
    msgs = jnp.arange(m)
    ct = tlwe.encrypt_message(jax.random.key(202), msgs, m, 0.0, sk.key_lv0)
    out = L.bootstrap_lut(ct, table, ck)
    dec = np.asarray(tlwe.decrypt_message(out, m, sk.key_lv0))
    assert np.array_equal(dec, np.array([f(x) for x in range(m)]))


def test_encode_with_scale():
    # encoder.zig:83-93: per-call scale override, message still wrapped
    # by the encoder's modulus
    enc = L.Encoder.new(4)
    assert enc.encode_with_scale(1, enc.scale) == enc.encode(1)
    assert enc.encode_with_scale(5, enc.scale) == enc.encode(1)  # 5 % 4
    # double scale == encoding at half the modulus's bin width
    assert enc.encode_with_scale(1, 0.25) == L.Encoder.new(2).encode(1)


def test_lookup_table_from_poly_get_poly(tiny, tiny_sk, tiny_ck):
    # lookup_table.zig:33-48: construct a LUT from an existing TRLWE and
    # read the polynomial back
    g = L.Generator.new(2, tiny)
    base = g.generate_lookup_table(lambda x: 1 - x)
    lut = L.LookupTable.from_poly(base.get_poly())
    assert np.array_equal(lut.get_poly(), base.get_poly())
    assert not lut.is_empty()
    # from_poly copies: mutating the source must not alias
    base.clear()
    assert not lut.is_empty()
    # a from_poly LUT drives the PBS identically to its source
    msgs = jnp.arange(2)
    ct = tlwe.encrypt_message(jax.random.key(52), msgs, 2, 0.0,
                              tiny_sk.key_lv0)
    out = L.bootstrap_lut(ct, lut, tiny_ck)
    dec = np.asarray(tlwe.decrypt_message(out, 2, tiny_sk.key_lv0))
    assert np.array_equal(dec, np.array([1, 0]))
    with pytest.raises(ValueError):
        L.LookupTable.from_poly(np.zeros((3, 8), np.int32))


def test_bootstrap_strategy_protocol(tiny, tiny_sk, tiny_ck):
    # bootstrap.zig:30-52: strategy interface + default
    from zig_tfhe_jax import bootstrap as B

    strat = B.default_bootstrap()
    assert strat.name == "vanilla"
    bits = jnp.asarray(np.array([False, True]))
    ct = tlwe.encrypt_bool(jax.random.key(53), bits, 0.0, tiny_sk.key_lv0)
    out = strat.bootstrap(ct, tiny_ck)
    dec = np.asarray(tlwe.decrypt_bool(out, tiny_sk.key_lv0))
    assert list(dec) == [False, True]
    lv1 = strat.bootstrap_without_key_switch(ct, tiny_ck)
    assert lv1.shape == (2, tiny.n1 + 1)


# ---------------------------------------------------------------------------
# Multi-value bootstrapping (CIM17 factoring; no reference analog)
# ---------------------------------------------------------------------------


def test_factor_lut_reconstruction_and_norm(tiny):
    """factor_lut verifies tv == T0*q internally; spot-check sparsity and
    the centered-coefficient bound |c| < m."""
    m = 8
    g = L.Generator.new(m, tiny)
    table = g.generate_lookup_table(lambda x: (x * 3 + 1) % m)
    offsets, coeffs, norm1 = L.factor_lut(table, m)
    assert len(offsets) == len(coeffs) > 0
    assert all(0 <= o < tiny.N for o in offsets)
    assert all(abs(c) < m and c != 0 for c in coeffs)
    assert norm1 == sum(abs(c) for c in coeffs)


def test_factor_lut_rejections(tiny):
    g = L.Generator.new(8, tiny)
    table = g.generate_lookup_table(lambda x: x)
    with pytest.raises(ValueError, match="power-of-two"):
        L.factor_lut(table, 6)
    with pytest.raises(ValueError, match="trivial"):
        bad = np.array(table.get_poly(), copy=True)
        bad[0, 0] = 1
        L.factor_lut(L.LookupTable.from_poly(bad), 8)
    with pytest.raises(ValueError, match="encode grid"):
        off_grid = g.generate_lookup_table_full(lambda x: x * 12345 + 7)
        L.factor_lut(off_grid, 8)


def test_bootstrap_multi_lut_matches_individual():
    """K LUTs through ONE blind rotation decrypt exactly like K separate
    bootstrap_lut calls.

    Runs on TEST_TINY_UINT (alpha=0, bgbit=11): the factored path
    amplifies the blind rotation's gadget-truncation error by ||q||_1
    (~2m), so it needs the uint-style fine gadget — TEST_TINY's coarse
    12-bit gadget is out of margin at m=8 (the same reason the integer
    layer, multi-value's consumer, runs on the uint sets)."""
    import jax as _jax
    from zig_tfhe_jax import key as _K
    from zig_tfhe_jax import params as _P

    p = _P.TEST_TINY_UINT
    sk = _K.SecretKey.generate(_jax.random.key(71), p)
    ck = _K.CloudKey.generate(_jax.random.key(72), sk, p)
    m = 8
    g = L.Generator.new(m, p)
    fs = [lambda x: (x * 3 + 1) % m, lambda x: x // 2,
          lambda x: (x * x) % m, lambda x: 0]
    tables = [g.generate_lookup_table(f) for f in fs]
    msgs = jnp.arange(m)
    ct = tlwe.encrypt_message(jax.random.key(70), msgs, m, 0.0, sk.key_lv0)
    mv = L.bootstrap_multi_lut(ct, tables, m, ck)
    assert mv.shape == (len(fs), m, p.n0 + 1)
    for k, f in enumerate(fs):
        ref = L.bootstrap_lut(ct, tables[k], ck)
        dec_mv = np.asarray(tlwe.decrypt_message(mv[k], m, sk.key_lv0))
        dec_ref = np.asarray(tlwe.decrypt_message(ref, m, sk.key_lv0))
        assert list(dec_mv) == [f(x) for x in range(m)] == list(dec_ref), k


# ---------------------------------------------------------------------------
# Radix (carry-decomposed) PBS — the m > 32 route
# ---------------------------------------------------------------------------


def test_bootstrap_lut_radix_exact():
    """Tree PBS (mid layer -> packing key switch -> select rotation) must
    be exact at alpha=0: TEST_TINY_UINT, m=64 (m_hi=4, delta=N/4), an
    affine LUT probed across all digit-boundary cases."""
    from zig_tfhe_jax import key as K
    from zig_tfhe_jax import params as P
    from zig_tfhe_jax.ops.packing_keyswitch import gen_packing_ksk

    params = P.TEST_TINY_UINT
    sk = K.SecretKey.generate(jax.random.key(7), params)
    ck = K.CloudKey.generate(jax.random.key(8), sk, params)
    pksk = gen_packing_ksk(jax.random.key(9), sk.key_lv1, params)
    m = 64
    f = lambda x: (x * 3 + 5) % m
    msgs = np.array([0, 1, 15, 16, 31, 40, 55, 63])
    cts = L.encrypt_radix_message(jax.random.key(10), msgs, m, 0.0,
                                  sk.key_lv0)
    assert list(np.asarray(L.decrypt_radix_message(cts, m, sk.key_lv0))) \
        == list(msgs)
    out = L.bootstrap_lut_radix(*cts, f, m, ck, pksk)
    dec = np.asarray(L.decrypt_radix_message(out, m, sk.key_lv0))
    assert list(dec) == [f(int(x)) for x in msgs]
    # chaining: feed the radix outputs straight into a second evaluation
    g = lambda x: (x * x + 1) % m
    out2 = L.bootstrap_lut_radix(*out, g, m, ck, pksk)
    dec2 = np.asarray(L.decrypt_radix_message(out2, m, sk.key_lv0))
    assert list(dec2) == [g(f(int(x))) for x in msgs]


def test_packing_key_switch_phase():
    """pack_tlwes_blocks places sample k's message on the coefficient
    block centered at k*delta (exact at alpha=0)."""
    from zig_tfhe_jax import key as K
    from zig_tfhe_jax import params as P
    from zig_tfhe_jax import trlwe
    from zig_tfhe_jax.ops.packing_keyswitch import (gen_packing_ksk,
                                                    pack_tlwes_blocks)

    params = P.TEST_TINY_UINT
    N = params.N
    sk = K.SecretKey.generate(jax.random.key(20), params)
    pksk = gen_packing_ksk(jax.random.key(21), sk.key_lv1, params)
    m_hi = 4
    delta = N // m_hi
    vals = np.array([1 << 28, -(1 << 28), 3 << 27, 0], np.int32)
    # fresh TLWE lv1 encryptions of the four torus values
    mu = jnp.asarray(vals)
    ct1 = trlwe.encrypt_torus(jax.random.key(22),
                              jnp.zeros((m_hi, N), jnp.int32).at[:, 0].set(mu),
                              0.0, sk.key_lv1)
    lv1 = trlwe.sample_extract(ct1, 0)                       # [m_hi, N+1]
    packed = pack_tlwes_blocks(lv1[None], m_hi, pksk, params)  # [1, 2, N]
    ph = np.asarray(trlwe.phase(packed, sk.key_lv1))[0]
    # within each centered block the phase must equal the packed value up
    # to the key-switch truncation (2^(32 - basebit*t) = 2^20 at tiny_uint)
    tol = 1 << (32 - params.basebit * params.iks_t + 2)
    for k in range(m_hi):
        idx = [(k * delta + r) % N for r in range(-delta // 4, delta // 4)]
        sign = np.array([1 if 0 <= (k * delta + r) < N else -1
                         for r in range(-delta // 4, delta // 4)])
        got = ph[idx] * sign
        err = np.abs((got.astype(np.int64) - int(vals[k]) + 2**31)
                     % 2**32 - 2**31)
        assert err.max() <= tol * delta, (k, err.max(), tol)


def test_bootstrap_lut_radix_random_f_exact():
    """Arbitrary (pseudo-random) tables exercise the true-difference
    factoring fallback in _factor_lut_cached — steep tables whose wrap
    jumps exceed +-m are unrepresentable in the centered mod-2m
    construction and previously could not factor at all."""
    from zig_tfhe_jax import key as K
    from zig_tfhe_jax import params as P
    from zig_tfhe_jax.ops.packing_keyswitch import gen_packing_ksk

    params = P.TEST_TINY_UINT
    sk = K.SecretKey.generate(jax.random.key(30), params)
    ck = K.CloudKey.generate(jax.random.key(31), sk, params)
    pksk = gen_packing_ksk(jax.random.key(32), sk.key_lv1, params)
    m = 64
    table = np.random.default_rng(5).integers(0, m, m)
    f = lambda x: int(table[x])
    msgs = np.array([0, 7, 16, 33, 48, 63])
    cts = L.encrypt_radix_message(jax.random.key(33), msgs, m, 0.0,
                                  sk.key_lv0)
    out = L.bootstrap_lut_radix(*cts, f, m, ck, pksk)
    dec = np.asarray(L.decrypt_radix_message(out, m, sk.key_lv0))
    assert list(dec) == [f(int(x)) for x in msgs]


def test_bootstrap_lut_bivariate_exact():
    """Bivariate PBS (tfhe-rs-style): f2(x, y) on two modulus-16 inputs
    via the radix route — exact at alpha=0 for mul and a random table."""
    from zig_tfhe_jax import key as K
    from zig_tfhe_jax import params as P
    from zig_tfhe_jax.ops.packing_keyswitch import gen_packing_ksk

    params = P.TEST_TINY_UINT
    sk = K.SecretKey.generate(jax.random.key(50), params)
    ck = K.CloudKey.generate(jax.random.key(51), sk, params)
    pksk = gen_packing_ksk(jax.random.key(52), sk.key_lv1, params)
    xs = np.array([0, 3, 7, 15, 9, 12])
    ys = np.array([0, 2, 3, 1, 3, 2])
    ct_x = L.encrypt_message(jax.random.key(53), jnp.asarray(xs), 16, 0.0,
                             sk.key_lv0)
    ct_y = L.encrypt_message(jax.random.key(54), jnp.asarray(ys), 4, 0.0,
                             sk.key_lv0)
    mul = lambda x, y: (x * y) % 16
    out = L.bootstrap_lut_bivariate(ct_x, ct_y, mul, ck, pksk, y_modulus=4)
    dec = np.asarray(L.decrypt_message(out, 16, sk.key_lv0))
    assert list(dec) == [mul(int(x), int(y)) for x, y in zip(xs, ys)]
    tbl = np.random.default_rng(8).integers(0, 16, (16, 4))
    g = lambda x, y: int(tbl[x, y])
    out2 = L.bootstrap_lut_bivariate(ct_x, ct_y, g, ck, pksk, y_modulus=4)
    dec2 = np.asarray(L.decrypt_message(out2, 16, sk.key_lv0))
    assert list(dec2) == [g(int(x), int(y)) for x, y in zip(xs, ys)]


def test_radix_and_tree_pbs_input_validation():
    """Error paths fail fast with actionable messages (non-power-of-two
    moduli, hypothesis overflow, custom-gadget packing keys on the cloud
    key)."""
    from zig_tfhe_jax import key as K
    from zig_tfhe_jax import params as P
    from zig_tfhe_jax.models import integer as I
    from zig_tfhe_jax.ops.packing_keyswitch import gen_packing_ksk

    params = P.TEST_TINY_UINT
    sk = K.SecretKey.generate(jax.random.key(70), params)
    ck = K.CloudKey.generate(jax.random.key(71), sk, params)
    pksk = gen_packing_ksk(jax.random.key(72), sk.key_lv1, params)
    with pytest.raises(ValueError, match="power-of-two"):
        L.encrypt_radix_message(jax.random.key(73), 5, 48, 0.0, sk.key_lv0)
    ct = L.encrypt_message(jax.random.key(74), jnp.asarray([1]), 16, 0.0,
                           sk.key_lv0)
    with pytest.raises(ValueError, match="power-of-two"):
        L.bootstrap_lut_radix(ct, ct, lambda x: x, 48, ck, pksk)
    with pytest.raises(ValueError, match="hypotheses exceed"):
        L.tree_pbs(ct, ct, np.zeros((1, 5, 2, params.N), np.int32), 4,
                   ck, pksk)
    with pytest.raises(ValueError, match="selector modulus"):
        L.tree_pbs(ct, ct, np.zeros((1, 3, 2, params.N), np.int32), 3,
                   ck, pksk)
    # a custom-gadget packing key (t=2 != iks_t) attached to the cloud
    # key must be rejected by the digit multiplier, not decode garbage
    bad = gen_packing_ksk(jax.random.key(75), sk.key_lv1, params,
                          basebit=8, t=2)
    import dataclasses
    ck_bad = dataclasses.replace(ck, pksk=bad)
    with pytest.raises(ValueError, match="packing key has"):
        I.digit_mul(ct, ct, ck_bad)


def test_tree_pbs_interleaved_select_matches_per_family():
    """The family-interleaved select (ONE rotation lane for both output
    digits, VERDICT r3 #4) must decrypt identically to the per-family
    route at alpha=0.  TEST_TINY_UINT at m=32 (m_hi=2) sits exactly on
    the interleave guard 2*n_blocks*64 <= N."""
    import os

    from zig_tfhe_jax import key as K
    from zig_tfhe_jax import params as P
    from zig_tfhe_jax.ops.packing_keyswitch import gen_packing_ksk

    params = P.TEST_TINY_UINT
    sk = K.SecretKey.generate(jax.random.key(70), params)
    ck = K.CloudKey.generate(jax.random.key(71), sk, params)
    pksk = gen_packing_ksk(jax.random.key(72), sk.key_lv1, params)
    m = 32
    f = lambda x: (x * 7 + 3) % m                   # noqa: E731
    msgs = np.array([0, 1, 15, 16, 17, 30, 31, 24])
    cts = L.encrypt_radix_message(jax.random.key(73), msgs, m, 0.0,
                                  sk.key_lv0)
    out_i = L.bootstrap_lut_radix(*cts, f, m, ck, pksk)     # interleaved
    prev = os.environ.get("ZTFHE_NO_INTERLEAVE")
    os.environ["ZTFHE_NO_INTERLEAVE"] = "1"
    try:
        out_p = L.bootstrap_lut_radix(*cts, f, m, ck, pksk)  # per-family
    finally:
        if prev is None:
            os.environ.pop("ZTFHE_NO_INTERLEAVE", None)
        else:
            os.environ["ZTFHE_NO_INTERLEAVE"] = prev
    dec_i = list(np.asarray(L.decrypt_radix_message(out_i, m, sk.key_lv0)))
    dec_p = list(np.asarray(L.decrypt_radix_message(out_p, m, sk.key_lv0)))
    assert dec_i == dec_p == [f(int(x)) for x in msgs]
