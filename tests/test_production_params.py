"""Opt-in slow tests at PRODUCTION parameter sets with real noise.

The regular suite exercises full pipelines at TEST_TINY (alpha=0, exact)
plus statistical paths at tiny scale; these tests run the real 80-bit and
uint4 configurations end-to-end.  NOTE: tests/conftest.py pins the CPU
backend unless JAX_PLATFORMS names another, so under a plain pytest run
these take minutes; bench.py and bench_lut.py cover the same
configurations on the GPU.  Opt in with ZTFHE_SLOW_TESTS=1.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import gates as G
from zig_tfhe_jax.models import lut as L

slow = pytest.mark.skipif(
    os.environ.get("ZTFHE_SLOW_TESTS", "") in ("", "0"),
    reason="set ZTFHE_SLOW_TESTS=1 to run production-parameter tests")


@slow
def test_80bit_nand_truth_table_real_noise():
    params = P.SECURITY_80_BIT
    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)
    bits_a = jnp.asarray(np.array([0, 0, 1, 1], bool))
    bits_b = jnp.asarray(np.array([0, 1, 0, 1], bool))
    cta = tlwe.encrypt_bool(jax.random.key(2), bits_a,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(3), bits_b,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    out = G.gate("nand", cta, ctb, ck)
    dec = list(np.asarray(tlwe.decrypt_bool(out, sk.key_lv0)))
    assert dec == [True, True, True, False]


@slow
def test_uint4_lut_real_noise():
    params = P.SECURITY_UINT4
    m = 16
    f = lambda x: (x * 7 + 3) % m
    sk = K.SecretKey.generate(jax.random.key(4), params)
    ck = K.CloudKey.generate(jax.random.key(5), sk, params)
    table = L.Generator.new(m, params).generate_lookup_table(f)
    msgs = np.arange(m)
    ct = L.encrypt_message(jax.random.key(6), jnp.asarray(msgs), m,
                           params.tlwe_lv0.alpha, sk.key_lv0)
    out = L.bootstrap_lut(ct, table, ck)
    dec = [int(L.decrypt_message(out[i], m, sk.key_lv0)) for i in range(m)]
    assert dec == [f(x) for x in msgs]


@slow
@pytest.mark.parametrize("pname,min_acc", [
    ("uint1", 1.0), ("uint2", 1.0), ("uint3", 1.0),
    ("uint5", 0.70), ("uint6", 0.45),
    # uint7/uint8 are modswitch-limited to partial accuracy (NOISE.md §8):
    # measured 0.38 / 0.29 over 24 samples (seeds below), with miss
    # distances concentrated on multiples of the LUT slope (5) — i.e. the
    # INPUT phase landing in a neighboring 1/(2m) bin, exactly the
    # modswitch physics, not an implementation bug.  The floors pin
    # "partially works, noise-limited" (random guessing would be 1/m:
    # 0.008/0.004); improving beyond them needs multi-PBS carry
    # decomposition or a larger N, same as every mainstream TFHE library.
    ("uint7", 0.10), ("uint8", 0.08),
])
def test_uint_family_lut_real_noise(pname, min_acc):
    """LUT bootstrap sweep across the multi-bit family (uint4 is covered
    above; this samples the rest of the range, including the large-Bg
    sets whose digit_limbs > 1 exercise the multi-limb forward NTT).

    Expected accuracy is modswitch-limited physics, not an implementation
    property: blind rotation rounds each of the n0 LWE coefficients to the
    2N grid, giving phase noise sigma ~5e-3 of the torus at N=1024 /
    n0~1100, while the PBS decision bin half-width is 1/(2m).  m <= 8 is
    exact for all practical purposes; m = 32 fails ~2-10% per sample;
    m = 64 ~15-25%; m = 256 (uint8) mostly fails and is omitted — the
    reference's math is identical (same modswitch grid, trgsw.zig:297),
    it just never executes these sets (comptime-pinned to 128-bit,
    params.zig:386-416).  See docs/NOISE.md.
    """
    params = P.PARAMS_BY_NAME[pname]
    m = 1 << params.security_bits  # uintN: messageModulus = 2^N
    probe = np.unique(np.linspace(0, m - 1, min(m, 8), dtype=np.int64))
    f = lambda x: (x * 5 + 1) % m
    sk = K.SecretKey.generate(jax.random.key(10), params)
    ck = K.CloudKey.generate(jax.random.key(11), sk, params)
    table = L.Generator.new(m, params).generate_lookup_table(f)
    expected = np.array([f(int(x)) for x in probe])
    n_trials = 1 if min_acc == 1.0 else 3
    hits, total = 0, 0
    for trial in range(n_trials):
        ct = L.encrypt_message(jax.random.key(12 + trial), jnp.asarray(probe),
                               m, params.tlwe_lv0.alpha, sk.key_lv0)
        out = L.bootstrap_lut(ct, table, ck)
        dec = np.asarray(L.decrypt_message(out, m, sk.key_lv0))
        hits += int((dec == expected).sum())
        total += len(probe)
    assert hits / total >= min_acc, (pname, hits, total)


@slow
def test_uint4_integer_compare_real_noise():
    """NOISE.md §10: the integer layer's widest linear combinations
    (3-term borrow rounds, the eq AND-reduce) survive real uint4 noise.
    2-digit values -> sub/lt (2 rotations) + eq incl. the sqrt(2)-bit
    reduce, batched over 8 value pairs."""
    from zig_tfhe_jax.models import integer as I
    params = P.SECURITY_UINT4
    sk = K.SecretKey.generate(jax.random.key(40), params)
    ck = K.CloudKey.generate(jax.random.key(41), sk, params)
    rng = np.random.default_rng(42)
    av = rng.integers(0, 64, 8)
    bv = np.concatenate([av[:4], rng.integers(0, 64, 4)])  # 4 equal pairs
    ca = I.encrypt_radix(jax.random.key(42), av, 2,
                         params.tlwe_lv0.alpha, sk.key_lv0)
    cb = I.encrypt_radix(jax.random.key(43), bv, 2,
                         params.tlwe_lv0.alpha, sk.key_lv0)
    diff, borrow = I.radix_sub(ca, cb, ck)
    assert np.array_equal(I.decrypt_radix(diff, sk.key_lv0), (av - bv) % 64)
    got_lt = I.decrypt_radix(borrow[:, None, :], sk.key_lv0)
    assert np.array_equal(got_lt, (av < bv).astype(np.int64))
    eq = I.radix_eq(ca, cb, ck)
    got_eq = I.decrypt_radix(eq[:, None, :], sk.key_lv0)
    assert np.array_equal(got_eq, (av == bv).astype(np.int64))


@slow
def test_uint4_gates_integer_bridge_real_noise():
    """The gates<->integer bridge at real uint4 noise: digit bits emit
    at the +-1/8 gate codec (full-output LUTs) and return through
    constant-testvec sign bootstraps — a different output-noise path
    from the message-codec LUTs, pinned here end-to-end."""
    from zig_tfhe_jax import tlwe
    from zig_tfhe_jax.models import integer as I
    params = P.SECURITY_UINT4
    sk = K.SecretKey.generate(jax.random.key(50), params)
    ck = K.CloudKey.generate(jax.random.key(51), sk, params)
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 64, 8)
    ct = I.encrypt_radix(jax.random.key(52), vals, 2,
                         params.tlwe_lv0.alpha, sk.key_lv0)
    bits = I.to_bools(ct, ck)                      # [8, 6, n0+1]
    dec_bits = np.asarray(tlwe.decrypt_bool(bits, sk.key_lv0)).astype(int)
    want = np.stack([(vals >> i) & 1 for i in range(6)], axis=-1)
    assert np.array_equal(dec_bits, want)
    back = I.from_bools(bits, ck)
    assert np.array_equal(I.decrypt_radix(back, sk.key_lv0), vals)


@slow
def test_uint4_integer_mul_real_noise():
    """Full radix multiply at real uint4 noise: exercises the bit-plane
    extraction, the w = x + 8*b packing LUTs, and both carry
    normalizations (the integer layer's deepest per-digit pipeline)."""
    from zig_tfhe_jax.models import integer as I
    params = P.SECURITY_UINT4
    sk = K.SecretKey.generate(jax.random.key(70), params)
    ck = K.CloudKey.generate(jax.random.key(71), sk, params)
    a = params.tlwe_lv0.alpha
    av = np.array([23, 63, 7, 40])
    bv = np.array([45, 63, 0, 13])
    ca = I.encrypt_radix(jax.random.key(72), av, 2, a, sk.key_lv0)
    cb = I.encrypt_radix(jax.random.key(73), bv, 2, a, sk.key_lv0)
    got = I.decrypt_radix(I.radix_mul(ca, cb, ck), sk.key_lv0)
    assert np.array_equal(got, av * bv)


@slow
def test_uint4_encrypted_amount_shift_real_noise():
    """Barrel shifter at real uint4 noise: its packed mux inputs carry
    up to 3 fresh PBS outputs per level (NOISE.md §10), repeated for
    every amount bit — the deepest chain in the integer layer."""
    from zig_tfhe_jax.models import integer as I
    params = P.SECURITY_UINT4
    sk = K.SecretKey.generate(jax.random.key(60), params)
    ck = K.CloudKey.generate(jax.random.key(61), sk, params)
    a = params.tlwe_lv0.alpha
    x, y = 37, 5
    cx = I.encrypt_radix(jax.random.key(62), x, 2, a, sk.key_lv0)
    cy = I.encrypt_radix(jax.random.key(63), y, 1, a, sk.key_lv0)
    assert I.decrypt_radix(I.radix_shl_enc(cx, cy, ck),
                           sk.key_lv0) == (x << y) % 64
    assert I.decrypt_radix(I.radix_shr_enc(cx, cy, ck), sk.key_lv0) == x >> y
    sx = I.FheInt.encrypt(jax.random.key(64), -21, 2, sk, ck)
    got = I.FheInt(I.radix_asr_enc(sx.digits, cy, ck), ck).decrypt(sk)
    assert got == -21 >> y


@slow
def test_110bit_gate_truth_tables_real_noise():
    params = P.SECURITY_110_BIT
    sk = K.SecretKey.generate(jax.random.key(20), params)
    ck = K.CloudKey.generate(jax.random.key(21), sk, params)
    bits_a = jnp.asarray(np.array([0, 0, 1, 1], bool))
    bits_b = jnp.asarray(np.array([0, 1, 0, 1], bool))
    cta = tlwe.encrypt_bool(jax.random.key(22), bits_a,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(23), bits_b,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    for gname, expect in [("xor", [False, True, True, False]),
                          ("and", [False, False, False, True])]:
        out = G.gate(gname, cta, ctb, ck)
        assert list(np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))) == expect


@slow
def test_uint4_multivalue_lut_real_noise():
    """Multi-value bootstrap (mod/div pair, ONE blind rotation) at uint4
    real noise: the ||q||_1 amplitude amplification (~30x for the mod
    table) must stay inside the m=16 margin (docs/NOISE.md; the uint
    sets' tiny lv1 alpha and drop=0 leave the blind-rotation output's
    amplitude noise far below margin/norm1)."""
    params = P.SECURITY_UINT4
    m = 16
    sk = K.SecretKey.generate(jax.random.key(30), params)
    ck = K.CloudKey.generate(jax.random.key(31), sk, params)
    gen = L.Generator.new(m, params)
    tables = [gen.generate_lookup_table(lambda t: t % 8),
              gen.generate_lookup_table(lambda t: t // 8)]
    msgs = np.arange(m)
    ct = L.encrypt_message(jax.random.key(32), jnp.asarray(msgs), m,
                           params.tlwe_lv0.alpha, sk.key_lv0)
    out = L.bootstrap_multi_lut(ct, tables, m, ck)
    dec_mod = np.asarray(L.decrypt_message(out[0], m, sk.key_lv0))
    dec_div = np.asarray(L.decrypt_message(out[1], m, sk.key_lv0))
    assert list(dec_mod) == [x % 8 for x in msgs]
    assert list(dec_div) == [x // 8 for x in msgs]


@slow
def test_128bit_v2_nand_truth_table_real_noise():
    """The estimator-compliant V2 set (lv1 noise 2^-24.8, 130.4 gate
    bits — VERDICT r4 #4) through the same default pipeline: the raised
    BSK noise must still decrypt exactly."""
    params = P.SECURITY_128_BIT_V2
    sk = K.SecretKey.generate(jax.random.key(60), params)
    ck = K.CloudKey.generate(jax.random.key(61), sk, params)
    assert ck.bsk_group == 3         # same boolean defaults as 128bit
    bits_a = jnp.asarray(np.array([0, 0, 1, 1], bool))
    bits_b = jnp.asarray(np.array([0, 1, 0, 1], bool))
    cta = tlwe.encrypt_bool(jax.random.key(62), bits_a,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(63), bits_b,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    out = G.gate("xor", cta, ctb, ck)
    assert list(np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))) == \
        [False, True, True, False]


@slow
def test_128bit_nand_truth_table_real_noise():
    """The bench configuration itself (128-bit, per-set default group and
    engine gadget) at real noise on CPU: decrypts must be exact."""
    params = P.SECURITY_128_BIT
    sk = K.SecretKey.generate(jax.random.key(40), params)
    ck = K.CloudKey.generate(jax.random.key(41), sk, params)
    # boolean-set defaults: group 3 at the bg7/(2,2) engine gadget
    assert ck.bsk_group == 3
    assert ck.bsk_bgbit == 7 and ck.bsk_levels == (2, 2)  # engine gadget
    bits_a = jnp.asarray(np.array([0, 0, 1, 1], bool))
    bits_b = jnp.asarray(np.array([0, 1, 0, 1], bool))
    cta = tlwe.encrypt_bool(jax.random.key(42), bits_a,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(43), bits_b,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    out = G.gate("nand", cta, ctb, ck)
    assert list(np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))) == \
        [True, True, True, False]


@slow
@pytest.mark.parametrize("pname", ["uint5", "uint6", "uint7", "uint8"])
def test_uint_radix_lut_real_noise(pname):
    """The COMPOSED (carry-decomposed) route at the modswitch-limited
    sets: radix tree-PBS (models/lut.py:bootstrap_lut_radix) must deliver
    >= 0.95 LUT accuracy where single-shot PBS measures ~0.9/0.75/0.38/
    0.29 (envelope pinned above) — with this route every reference
    parameter set is production-usable.  Measured at these seeds: 1.000
    for all four."""
    from zig_tfhe_jax.ops.packing_keyswitch import gen_packing_ksk

    params = P.PARAMS_BY_NAME[pname]
    m = 1 << params.security_bits
    f = lambda x: (x * 5 + 1) % m
    sk = K.SecretKey.generate(jax.random.key(10), params)
    ck = K.CloudKey.generate(jax.random.key(11), sk, params)
    pksk = gen_packing_ksk(jax.random.key(12), sk.key_lv1, params)
    probe = np.unique(np.linspace(0, m - 1, 8, dtype=np.int64))
    cts = L.encrypt_radix_message(jax.random.key(13), probe, m,
                                  params.tlwe_lv0.alpha, sk.key_lv0)
    out = L.bootstrap_lut_radix(*cts, f, m, ck, pksk)
    dec = np.asarray(L.decrypt_radix_message(out, m, sk.key_lv0))
    expected = np.array([f(int(x)) for x in probe])
    acc = float((dec == expected).mean())
    assert acc >= 0.95, (pname, dec.tolist(), expected.tolist())


@slow
def test_uint4_digit_mul_tree_real_noise():
    """The bivariate tree-PBS digit multiplier at real uint4 noise: all
    64 digit pairs exact (the select rotation consumes a NOISY packed
    testvec — mid-layer PBS noise x sqrt(delta) spread — so this pins
    the tree path's real-noise budget end-to-end)."""
    from zig_tfhe_jax.models import integer as I
    params = P.SECURITY_UINT4
    sk = K.SecretKey.generate(jax.random.key(80), params)
    ck = K.CloudKey.generate(jax.random.key(81), sk, params,
                             packing_key=True)
    xs, ys = np.meshgrid(np.arange(8), np.arange(8))
    xs, ys = xs.ravel(), ys.ravel()
    a = params.tlwe_lv0.alpha
    cx = I.encrypt_radix(jax.random.key(82), xs, 1, a, sk.key_lv0)[..., 0, :]
    cy = I.encrypt_radix(jax.random.key(83), ys, 1, a, sk.key_lv0)[..., 0, :]
    lo, hi = I.digit_mul(cx, cy, ck)
    got = (np.asarray(I.decrypt_radix(lo[..., None, :], sk.key_lv0))
           + 8 * np.asarray(I.decrypt_radix(hi[..., None, :], sk.key_lv0)))
    assert np.array_equal(got, xs * ys)
