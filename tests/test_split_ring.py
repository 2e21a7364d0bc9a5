"""Even/odd split-ring engine (TEST_TINY_SPLIT): N=2048 on the N=1024 plan.

The reference pins Torus=u32/N=1024 at comptime (params.zig:21-30,
386-416); a direct N=2048 NTT is prime-density-impossible in the matmul
engine (docs/TORUS64.md §3).  This suite drives the unblocking design —
Z[X]/(X^2048+1) ≅ pairs over Y=X^2 on the shipped five-prime N=1024 pool
(ops/split_ring.py) — to decrypt-exactness at alpha=0: the split external
product against an exact big-int oracle, the parity-select rotation
against the coefficient-domain gather, and full gate truth tables at
TEST_TINY_SPLIT.  Requires jax_enable_x64 (set in conftest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import gates as G
from zig_tfhe_jax.ops import ntt as NTT
from zig_tfhe_jax.ops import split_ring as SR
from zig_tfhe_jax.ops.poly import negacyclic_rotate

pytestmark = pytest.mark.skipif(
    jnp.zeros((), jnp.int64).dtype != jnp.int64,
    reason="jax_enable_x64 is off (conftest normally enables it)")

PS = P.TEST_TINY_SPLIT


@pytest.fixture(scope="module")
def plan():
    return NTT.plan_for_params(PS, 12, 1, (2, 2), bgbit=8,
                               pseudorandom_key=True)


@pytest.fixture(scope="module")
def sk():
    return K.SecretKey.generate(jax.random.key(7), PS)


@pytest.fixture(scope="module")
def ck(sk):
    return K.CloudKey.generate(jax.random.key(8), sk, PS)


def test_params_split_flags():
    assert PS.split_ring and PS.N == 2048 and PS.torus_bits == 64
    assert not P.TEST_TINY.split_ring
    assert not P.TEST_TINY64.split_ring
    assert P.DRAFT_SECURITY_128_BIT_T64.split_ring
    # the split plan transforms at N/2 on the full five-prime pool
    plan = NTT.plan_for_params(PS, 12, 1, (2, 2), bgbit=8,
                               pseudorandom_key=True)
    assert plan.N == PS.N // 2
    assert len(plan.primes) == 5


def test_split_unsplit_roundtrip():
    x = jnp.arange(3 * 2048, dtype=jnp.int64).reshape(3, 2048)
    assert (SR.unsplit(SR.split(x)) == x).all()
    s = SR.split(x)
    # even/odd semantics: a(X) = a_e(X^2) + X a_o(X^2)
    assert (s[..., 0, :] == x[..., 0::2]).all()
    assert (s[..., 1, :] == x[..., 1::2]).all()


def _negacyclic_conv_obj(d, k):
    """Exact negacyclic conv of int rows (numpy object bigints), length N."""
    N = d.shape[-1]
    out = np.zeros(N, dtype=object)
    for i in range(N):
        di = int(d[i])
        if di == 0:
            continue
        for j in range(N):
            idx = i + j
            sgn = 1 if idx < N else -1
            out[idx % N] += sgn * di * int(k[j])
    return out


def test_split_external_product_exact_vs_bigint_oracle(plan):
    """fold_key_split + pointwise_extprod + inverse == the true mod-2^64
    negacyclic product of digit rows against the (drop-rounded) key."""
    drop = 12
    N = PS.N
    Nh = N // 2
    rng = np.random.default_rng(0)
    R = 4
    d = rng.integers(-128, 128, size=(R, N)).astype(np.int64)
    k = rng.integers(-2**63, 2**63, size=(R, 2, N)).astype(np.int64)

    kh = SR.split(jnp.asarray(k))                            # [R, 2, 2, Nh]
    res_e = NTT.to_ntt_form(kh[..., 0, :], plan, drop, width=64)
    res_o = NTT.to_ntt_form(kh[..., 1, :], plan, drop, width=64)
    folded = SR.fold_key_split(res_e, res_o, plan)           # [P, 2R, 4, Nh]
    assert folded.shape == (len(plan.primes), 2 * R, 4, Nh)

    rows = SR.split(jnp.asarray(d)).reshape(1, 2 * R, Nh)
    d_hat = NTT.ntt_forward(rows, plan, 1, 128)
    u = NTT.pointwise_extprod(d_hat, folded, plan)
    v = [x.reshape(1, 2, 2, Nh) for x in u]
    out = NTT.ntt_inverse_to_crt(v, plan, 64)
    eng = np.asarray(SR.unsplit(out[0])).astype(object) << drop

    kr = (k.astype(object) + (1 << (drop - 1))) >> drop
    for c in range(2):
        acc = np.zeros(N, dtype=object)
        for r in range(R):
            acc += _negacyclic_conv_obj(d[r], kr[r, c])
        want = (acc << drop) % (1 << 64)
        got = eng[c] % (1 << 64)
        np.testing.assert_array_equal(got, want)


def test_split_rotation_vs_coefficient_gather(plan):
    """(X^t - 1) u via rotate_minus1_split == coefficient-domain gather,
    for every parity of t and wrap-around cases."""
    N = PS.N
    Nh = N // 2
    rng = np.random.default_rng(1)
    B = 8
    u = rng.integers(-2**40, 2**40, size=(B, N)).astype(np.int64)
    ts = np.array([0, 1, 2, 2047, 2048, 2049, 4095, 1234], np.int32)

    h = NTT.ntt_forward(SR.split(jnp.asarray(u)), plan, 8, 128)
    us4 = [jnp.stack([x[:, 0, :], x[:, 1, :], x[:, 0, :], x[:, 1, :]],
                     axis=1) for x in h]
    v = SR.rotate_minus1_split(us4, jnp.asarray(ts), plan)
    out = NTT.ntt_inverse_to_crt(v, plan, 64)
    got = np.asarray(SR.unsplit(out[:, 0]))
    want = np.asarray(negacyclic_rotate(jnp.asarray(u), jnp.asarray(ts))) - u
    np.testing.assert_array_equal(got, want)


def test_cloud_key_split_shapes(ck):
    # split default: group 2 (the pair-representation subset combiner,
    # ops/ntt.py:default_group) — [G, 2^g-1, P, 2R, 4, Nh].  drop=32
    # (the hi-plane scan threshold) puts the Hoeffding plan at FOUR CRT
    # primes (ops/ntt.py:default_drop_bits derivation).
    assert ck.bsk_group == 2
    assert ck.bsk_ntt_drop == 32
    n0, Nh = PS.n0, PS.N // 2
    assert ck.bsk_ntt.shape == (n0 // 2, 3, 4, 8, 4, Nh)
    assert ck.bsk_ntt.dtype == jnp.int16


def test_multibit_combiner_vs_coefficient_oracle(plan):
    """rotate_combine_multi_split == sum over nonempty subsets of
    prod (X^ti - 1) u_S computed in the coefficient domain."""
    N = PS.N
    rng = np.random.default_rng(3)
    B = 6
    u = {m: rng.integers(-2**40, 2**40, size=(B, N)).astype(np.int64)
         for m in (1, 2, 3)}
    t1 = np.array([0, 1, 4094, 2048, 17, 100], np.int32)
    t2 = np.array([1, 3, 1, 4095, 2, 2049], np.int32)

    def to4(x):
        h = NTT.ntt_forward(SR.split(jnp.asarray(x)), plan, 8, 128)
        return [jnp.stack([r[:, 0, :], r[:, 1, :], r[:, 0, :], r[:, 1, :]],
                          axis=1) for r in h]

    us = [to4(u[1]), to4(u[2]), to4(u[3])]
    v = SR.rotate_combine_multi_split(
        us, [jnp.asarray(t1), jnp.asarray(t2)], plan)
    out = NTT.ntt_inverse_to_crt(v, plan, 64)
    got = np.asarray(SR.unsplit(out[:, 0]))

    def rotm1(x, t):
        return (np.asarray(negacyclic_rotate(jnp.asarray(x),
                                             jnp.asarray(t))) - x)

    want = rotm1(u[1], t1) + rotm1(u[2], t2) + rotm1(rotm1(u[3], t1), t2)
    np.testing.assert_array_equal(got, want)


def test_gate_truth_tables_split(sk, ck):
    """NAND/XOR/AND/OR exact at alpha=0 through the full split pipeline
    (group-2 blind rotate -> sample extract -> 64-bit key switch)."""
    a = jnp.array([0, 0, 1, 1], bool)
    b = jnp.array([0, 1, 0, 1], bool)
    ca = tlwe.encrypt_bool(jax.random.key(1), a, 0.0, sk.key_lv0, width=64)
    cb = tlwe.encrypt_bool(jax.random.key(2), b, 0.0, sk.key_lv0, width=64)
    for gate, want in [
        (G.nand, [True, True, True, False]),
        (G.xor, [False, True, True, False]),
        (G.and_, [False, False, False, True]),
        (G.or_, [False, True, True, True]),
    ]:
        out = gate(ca, cb, ck)
        dec = np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))
        np.testing.assert_array_equal(dec, want), gate


@pytest.mark.parametrize("group,shape", [
    (3, (3, 7)),       # ragged n0=8 -> G=3 with one zero pad bit
    (4, (2, 15)),      # 15-subset DP
])
def test_gate_truth_tables_split_multibit(sk, group, shape):
    """Higher multi-bit groups stay exact — the pair-representation
    combiner is generic in g (the subset DP and the Hoeffding plan bound
    both scale; groups 3/4 ride the same four-prime plan at drop 32)."""
    ckg = K.CloudKey.generate(jax.random.key(12 + group), sk, PS,
                              group=group)
    assert ckg.bsk_group == group
    assert ckg.bsk_ntt.shape == shape + (4, 8, 4, PS.N // 2)
    a = jnp.array([0, 1], bool)
    b = jnp.array([1, 1], bool)
    ca = tlwe.encrypt_bool(jax.random.key(1), a, 0.0, sk.key_lv0, width=64)
    cb = tlwe.encrypt_bool(jax.random.key(2), b, 0.0, sk.key_lv0, width=64)
    dec = np.asarray(tlwe.decrypt_bool(G.nand(ca, cb, ckg), sk.key_lv0))
    np.testing.assert_array_equal(dec, [True, False])


def test_kogge_stone_adder_split(sk, ck):
    """Encrypted 16-bit addition end-to-end on the 64-bit N=2048 set
    (regression: encrypt_bits once ignored params.torus_bits and the
    adder silently decrypted garbage)."""
    from zig_tfhe_jax.models import circuits

    a = circuits.encrypt_bits(jax.random.key(2), 402, 16, sk, PS)
    assert a.dtype == jnp.int64
    b = circuits.encrypt_bits(jax.random.key(3), 304, 16, sk, PS)
    s, _ = circuits.kogge_stone_add(a, b, ck)
    assert circuits.decrypt_bits(s, sk) == 706


def test_width_mismatch_raises(ck):
    """int32 ciphertexts into a 64-bit pipeline fail loudly."""
    from zig_tfhe_jax.ops.blind_rotate import blind_rotate

    bad = jnp.zeros((2, PS.n0 + 1), jnp.int32)
    with pytest.raises(TypeError, match="torus carrier"):
        blind_rotate(bad, ck.testvec, ck, PS)


def test_single_shot_lut_m64_split(sk, ck):
    """Single-shot m=64 programmable bootstrap on the 64-bit N=2048 set —
    the capability the radix route exists to work around at N=1024
    (uint6's m=64 needs 3 rotation lanes there; here it is ONE).

    Also the regression guard for the decomposition-remainder centering
    (ops/decomposition.py center=True): with the biased floor-form
    remainder the a-key convolution shifts phases by ~2^-7 of the torus
    and 48/64 of these bins decode wrong."""
    from zig_tfhe_jax.models import lut as L

    m = 64
    gen = L.Generator.new(m, PS)
    assert gen.encoder.width == 64
    table = gen.generate_lookup_table(lambda x: (x * x + 3) % m)
    assert table.poly.dtype == np.int64
    msgs = np.arange(m)
    ct = tlwe.encrypt_message(jax.random.key(3), jnp.asarray(msgs), m, 0.0,
                              sk.key_lv0, width=64)
    out = L.bootstrap_lut(ct, table, ck)
    dec = np.asarray(tlwe.decrypt_message(out, m, sk.key_lv0, width=64))
    np.testing.assert_array_equal(dec, (msgs * msgs + 3) % m)


def test_integer_layer_split(sk, ck):
    """The radix integer layer (multi-value bootstraps included) runs on
    the 64-bit split set: FheUint add/mul/compare exact at alpha=0."""
    from zig_tfhe_jax.models.integer import FheUint, decrypt_radix

    x = FheUint.encrypt(jax.random.key(1), 45, 2, sk, ck)
    assert x.digits.dtype == jnp.int64
    y = FheUint.encrypt(jax.random.key(2), 23, 2, sk, ck)
    assert decrypt_radix((x + y).digits, sk.key_lv0) == 68
    assert decrypt_radix((x * y).digits, sk.key_lv0) == 45 * 23
    assert decrypt_radix((x < y).digits, sk.key_lv0) == 0
    assert decrypt_radix((x ^ y).digits, sk.key_lv0) == 45 ^ 23


def test_signed_integer_layer_split(sk, ck):
    """FheInt (signed radix) on the 64-bit split set: add/compare/abs
    exact at alpha=0 — the signed layer rides the same width-general
    radix machinery as FheUint, but its sign handling (top-digit LUTs)
    has its own tables worth pinning at this width."""
    from zig_tfhe_jax.models.integer import FheInt

    x = FheInt.encrypt(jax.random.key(71), -13, 2, sk, ck, alpha=0.0)
    y = FheInt.encrypt(jax.random.key(72), 9, 2, sk, ck, alpha=0.0)
    assert x.digits.dtype == jnp.int64
    assert (x + y).decrypt(sk) == -4
    assert (x - y).decrypt(sk) == -22
    assert (x < y).decrypt(sk) == 1
    assert x.abs().decrypt(sk) == 13


def test_seeded_ciphertext_64bit(sk, ck):
    """Seeded (compressed) ciphertexts at the 64-bit width: the expanded
    form must equal a direct encryption from the same key bit-for-bit,
    and decrypt through the split gate pipeline."""
    bits = jnp.asarray([True, False, True])
    kk = jax.random.key(44)
    seed, b = tlwe.encrypt_bool_seeded(kk, bits, 0.0, sk.key_lv0, width=64)
    assert b.dtype == jnp.int64
    full = tlwe.expand_seeded(seed, b, PS.n0, width=64)
    direct = tlwe.encrypt_bool(kk, bits, 0.0, sk.key_lv0, width=64)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(direct))
    other = tlwe.encrypt_bool(jax.random.key(45), jnp.ones(3, bool), 0.0,
                              sk.key_lv0, width=64)
    dec = np.asarray(tlwe.decrypt_bool(G.and_(full, other, ck), sk.key_lv0))
    np.testing.assert_array_equal(dec, [True, False, True])


def test_split_cloud_key_serialization_roundtrip(tmp_path, sk, ck):
    """The 6-axis multi-bit split BSK and 64-bit KSK survive save/load
    and the loaded key still evaluates gates exactly."""
    from zig_tfhe_jax.utils import serialization as S

    p = tmp_path / "ck_split.npz"
    S.save_cloud_key(p, ck)
    ck2 = S.load_cloud_key(p)
    assert ck2.params is PS
    assert ck2.bsk_group == ck.bsk_group
    assert ck2.bsk_ntt.shape == ck.bsk_ntt.shape
    np.testing.assert_array_equal(np.asarray(ck2.bsk_ntt),
                                  np.asarray(ck.bsk_ntt))
    # the int64 packing key + its (8, 3) width-64 gadget contract must
    # survive the roundtrip (a wrong-gadget load decodes garbage)
    assert ck2.pksk.dtype == jnp.int64
    np.testing.assert_array_equal(np.asarray(ck2.pksk), np.asarray(ck.pksk))
    assert tuple(ck2.pksk_gadget) == (8, 3)
    a = tlwe.encrypt_bool(jax.random.key(90), jnp.asarray([True, False]),
                          0.0, sk.key_lv0, width=64)
    b = tlwe.encrypt_bool(jax.random.key(91), jnp.asarray([True, True]),
                          0.0, sk.key_lv0, width=64)
    out = G.and_(a, b, ck2)
    np.testing.assert_array_equal(
        np.asarray(tlwe.decrypt_bool(out, sk.key_lv0)), [True, False])


def test_gate_truth_tables_split_group1(sk):
    """group=1 (classic per-bit BSK) stays exact through the same path."""
    ck1 = K.CloudKey.generate(jax.random.key(11), sk, PS, group=1)
    assert ck1.bsk_group == 1
    assert ck1.bsk_ntt.shape == (PS.n0, 4, 8, 4, PS.N // 2)
    a = jnp.array([0, 1], bool)
    b = jnp.array([1, 1], bool)
    ca = tlwe.encrypt_bool(jax.random.key(1), a, 0.0, sk.key_lv0, width=64)
    cb = tlwe.encrypt_bool(jax.random.key(2), b, 0.0, sk.key_lv0, width=64)
    dec = np.asarray(tlwe.decrypt_bool(G.nand(ca, cb, ck1), sk.key_lv0))
    np.testing.assert_array_equal(dec, [True, False])


def test_gates_integer_bridge_split(sk, ck):
    """to_bools/from_bools on the 64-bit split set: the boolbit LUT bank
    must emit +-1/8 at the 64-BIT codec (the bank builds its raw-torus
    tables via torus_constant_w; the 32-bit torus_constant would encode
    2^29-scale constants into int64 tables — a latent width bug fixed in
    the radix-spec refactor)."""
    from zig_tfhe_jax.models.integer import (decrypt_radix, encrypt_radix,
                                             from_bools, to_bools)

    vals = np.array([45, 7, 63])
    cts = encrypt_radix(jax.random.key(5), vals, 2, 0.0, sk.key_lv0,
                        width=64)
    bits = to_bools(cts, ck)                        # [3, 6, n0+1] +-1/8
    dec_bits = np.asarray(tlwe.decrypt_bool(
        jnp.moveaxis(bits, -2, 0).reshape(-1, bits.shape[-1]),
        sk.key_lv0)).reshape(6, 3)
    for j, v in enumerate(vals):
        got = sum(int(dec_bits[k, j]) << k for k in range(6))
        assert got == v, (j, got, v)
    back = from_bools(bits, ck)
    assert (np.asarray(decrypt_radix(back, sk.key_lv0)) == vals).all()


def test_hi32_scan_bit_exact_vs_generic(sk, ck):
    """The pure-int32 hi-plane scan (drop >= 32) is an algebraic rewrite:
    its output must match the generic int64 scan BIT-exactly at equal
    drop (ZTFHE_SPLIT_HI32=0 forces the generic path)."""
    import os

    from zig_tfhe_jax.ops.split_ring import _hi32_viable, blind_rotate_split

    assert _hi32_viable(PS, ck.bsk_ntt_drop, ck.bsk_bgbit, ck.bsk_levels)
    ct = tlwe.encrypt_message(jax.random.key(21), jnp.arange(8), 16, 0.0,
                              sk.key_lv0, width=64)
    args = (ct, jnp.asarray(ck.testvec), ck.bsk_ntt, PS, ck.bsk_ntt_drop)
    kw = dict(group=ck.bsk_group, levels=ck.bsk_levels, bgbit=ck.bsk_bgbit)
    a1 = blind_rotate_split(*args, **kw)
    os.environ["ZTFHE_SPLIT_HI32"] = "0"
    try:
        a2 = blind_rotate_split(*args, **kw)
    finally:
        del os.environ["ZTFHE_SPLIT_HI32"]
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))


def test_tv_lo_zero_fast_start_bit_exact(sk, ck):
    """The gate path's tv_lo_zero fast start (int32 hi-plane initial
    rotation, ops/split_ring.py) must be BIT-exact vs the generic start
    whenever the testvec's low words are zero — true for the +-1/8 gate
    testvec (2^61 at the 64-bit torus, key.py:gen_testvec)."""
    from zig_tfhe_jax.ops.split_ring import blind_rotate_split

    tv = jnp.asarray(ck.testvec)
    assert not np.any(np.asarray(tv) & 0xFFFFFFFF)
    ct = tlwe.encrypt_message(jax.random.key(33), jnp.arange(6), 16, 0.0,
                              sk.key_lv0, width=64)
    kw = dict(group=ck.bsk_group, levels=ck.bsk_levels, bgbit=ck.bsk_bgbit)
    a1 = blind_rotate_split(ct, tv, ck.bsk_ntt, PS, ck.bsk_ntt_drop,
                            tv_lo_zero=True, **kw)
    a2 = blind_rotate_split(ct, tv, ck.bsk_ntt, PS, ck.bsk_ntt_drop, **kw)
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))


def test_packing_key_built_on_64bit_sets(sk, ck):
    """Round 4 REJECTED packing-key builds on 64-bit sets; round 5 ships
    the width-64 packing key switch (the exact m >= 64 radix door,
    VERDICT r4 #1).  The default cloud key now carries an int64 packing
    key at the (8, 3) width-64 gadget."""
    from zig_tfhe_jax.ops.packing_keyswitch import default_packing_gadget

    assert default_packing_gadget(PS) == (8, 3)
    assert ck.pksk is not None
    assert ck.pksk.dtype == jnp.int64
    assert ck.pksk.shape == (PS.n1 * 3, 2, PS.N)
    assert ck.pksk_gadget == (8, 3)


def test_radix_lut_m64_m256_split(sk, ck):
    """Exact m=64 and m=256 LUTs via the width-64 radix tree-PBS — the
    capability docs/TORUS64.md §8 promises beyond the m<=32 single-shot
    envelope.  Steep tables exceed the CIM17 ||q||_1 budget on this
    set's gadget and take dedicated mid lanes (models/lut.py:
    mid_norm1_budget); identity-grade tables ride the shared factored
    rotation — both must land exactly at alpha=0."""
    from zig_tfhe_jax.models import lut as L

    for m, f in ((64, lambda x: (3 * x + 7) % 64),
                 (256, lambda x: (57 * x + 19) % 256)):
        vals = (np.arange(16) * (m // 16 * 4 + 1) + 3) % m
        ct_lo, ct_hi = L.encrypt_radix_message(
            jax.random.key(m), jnp.asarray(vals), m, 0.0, sk.key_lv0,
            width=64)
        out = L.bootstrap_lut_radix(ct_lo, ct_hi, f, m, ck, ck.pksk)
        dec = np.asarray(L.decrypt_radix_message(out, m, sk.key_lv0,
                                                 width=64))
        want = np.array([f(int(v)) for v in vals])
        np.testing.assert_array_equal(dec, want), m
