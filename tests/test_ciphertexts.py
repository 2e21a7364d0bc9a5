"""TLWE/TRLWE/TRGSW encrypt/decrypt, sample extraction, external product,
CMux — exact at TEST_TINY (alpha=0) and statistical at real parameters.

Mirrors: tlwe.zig:300-404, trlwe.zig:184-318, trgsw.zig:505-692.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import params as P, tlwe, trlwe, trgsw, key as K
from zig_tfhe_jax.ops.blind_rotate import cmux, external_product
from zig_tfhe_jax.ops import poly


def test_tlwe_roundtrip_exact(tiny, tiny_sk, rng):
    bits = jnp.asarray(rng.integers(0, 2, 64).astype(bool))
    ct = tlwe.encrypt_bool(jax.random.key(1), bits, tiny.tlwe_lv0.alpha, tiny_sk.key_lv0)
    assert np.array_equal(np.asarray(tlwe.decrypt_bool(ct, tiny_sk.key_lv0)),
                          np.asarray(bits))


def test_tlwe_statistical_128bit(rng):
    # >=95% over many trials at real noise (tlwe.zig:300-330)
    p = P.SECURITY_128_BIT
    sk = K.SecretKey.generate(jax.random.key(0), p)
    bits = jnp.asarray(rng.integers(0, 2, 1000).astype(bool))
    ct = tlwe.encrypt_bool(jax.random.key(1), bits, p.tlwe_lv0.alpha, sk.key_lv0)
    dec = np.asarray(tlwe.decrypt_bool(ct, sk.key_lv0))
    assert (dec == np.asarray(bits)).mean() > 0.95


def test_tlwe_linear_ops(tiny, tiny_sk):
    a = tlwe.encrypt_bool(jax.random.key(1), jnp.asarray([True]), 0.0, tiny_sk.key_lv0)
    b = tlwe.encrypt_bool(jax.random.key(2), jnp.asarray([False]), 0.0, tiny_sk.key_lv0)
    # phases are exact with alpha=0: +-1/8 == +-2^29
    pa = int(tlwe.phase(a, tiny_sk.key_lv0)[0])
    pb = int(tlwe.phase(b, tiny_sk.key_lv0)[0])
    assert pa == (1 << 29) and pb == -(1 << 29)
    assert int(tlwe.phase(tlwe.add(a, b), tiny_sk.key_lv0)[0]) == 0
    assert int(tlwe.phase(tlwe.sub(a, b), tiny_sk.key_lv0)[0]) == (1 << 30)
    assert int(tlwe.phase(tlwe.neg(a), tiny_sk.key_lv0)[0]) == -(1 << 29)
    assert int(tlwe.phase(tlwe.add_mul(a, b, 2), tiny_sk.key_lv0)[0]) == -(1 << 29)
    assert int(tlwe.phase(tlwe.sub_mul(a, b, 2), tiny_sk.key_lv0)[0]) == 3 * (1 << 29)


def test_message_codec_roundtrip(tiny, tiny_sk):
    for m in [2, 4, 8, 16]:
        msgs = jnp.arange(m)
        ct = tlwe.encrypt_message(jax.random.key(3), msgs, m, 0.0, tiny_sk.key_lv0)
        dec = np.asarray(tlwe.decrypt_message(ct, m, tiny_sk.key_lv0))
        assert np.array_equal(dec, np.arange(m))


def test_trlwe_roundtrip_exact(tiny, tiny_sk, rng):
    bits = jnp.asarray(rng.integers(0, 2, (4, tiny.N)).astype(bool))
    ct = trlwe.encrypt_bool(jax.random.key(2), bits, 0.0, tiny_sk.key_lv1)
    assert np.array_equal(np.asarray(trlwe.decrypt_bool(ct, tiny_sk.key_lv1)),
                          np.asarray(bits))


def test_sample_extract_all_indices(tiny, tiny_sk, rng):
    bits = jnp.asarray(rng.integers(0, 2, (2, tiny.N)).astype(bool))
    ct = trlwe.encrypt_bool(jax.random.key(2), bits, 0.0, tiny_sk.key_lv1)
    for k in [0, 1, tiny.N // 2, tiny.N - 1]:
        ext = trlwe.sample_extract(ct, k)
        dec = np.asarray(tlwe.decrypt_bool(ext, tiny_sk.key_lv1))
        assert np.array_equal(dec, np.asarray(bits)[:, k]), k


def test_sample_extract_trivial(tiny):
    # deterministic check (trlwe.zig:296-318): a=0, b known
    ct = np.zeros((2, tiny.N), np.int32)
    ct[1, 0] = 1 << 29
    ct[1, 1] = 0
    ct[1, 2] = 1 << 30
    for k, expect in [(0, 1 << 29), (1, 0), (2, 1 << 30)]:
        ext = trlwe.sample_extract(jnp.asarray(ct), k)
        assert int(ext[tiny.N]) == expect


def test_trgsw_external_product_identity(tiny, tiny_sk, rng):
    # ExtProd(TRGSW(1), ct) decrypts to ct's plaintext (trgsw.zig:578-635)
    bits = jnp.asarray(rng.integers(0, 2, (3, tiny.N)).astype(bool))
    ct = trlwe.encrypt_bool(jax.random.key(5), bits, 0.0, tiny_sk.key_lv1)
    g1 = trgsw.encrypt_torus(jax.random.key(6), jnp.int32(1), 0.0,
                             tiny_sk.key_lv1, tiny)
    ext = trgsw.to_ext_limbs(g1)
    out = external_product(ext, ct, tiny)
    assert np.array_equal(np.asarray(trlwe.decrypt_bool(out, tiny_sk.key_lv1)),
                          np.asarray(bits))


def test_trgsw_cmux(tiny, tiny_sk, rng):
    # cond=0 -> first, cond=1 -> second (trgsw.zig:637-692)
    b1 = jnp.asarray(rng.integers(0, 2, (2, tiny.N)).astype(bool))
    b2 = jnp.asarray(rng.integers(0, 2, (2, tiny.N)).astype(bool))
    c1 = trlwe.encrypt_bool(jax.random.key(5), b1, 0.0, tiny_sk.key_lv1)
    c2 = trlwe.encrypt_bool(jax.random.key(6), b2, 0.0, tiny_sk.key_lv1)
    for cond, expect in [(0, b1), (1, b2)]:
        g = trgsw.encrypt_torus(jax.random.key(7), jnp.int32(cond), 0.0,
                                tiny_sk.key_lv1, tiny)
        out = cmux(trgsw.to_ext_limbs(g), c1, c2, tiny)
        assert np.array_equal(np.asarray(trlwe.decrypt_bool(out, tiny_sk.key_lv1)),
                              np.asarray(expect)), cond


def test_trgsw_decomposition_reconstruct(tiny, tiny_sk, rng):
    # decompose then recombine with gadget values h_i: decrypts unchanged
    # (trgsw.zig:505-576)
    from zig_tfhe_jax.ops.blind_rotate import _decompose_to_rows
    bits = jnp.asarray(rng.integers(0, 2, (1, tiny.N)).astype(bool))
    ct = trlwe.encrypt_bool(jax.random.key(9), bits, 0.0, tiny_sk.key_lv1)
    rows = np.asarray(_decompose_to_rows(ct, tiny)).astype(np.int64)  # [1, 2L, N]
    h = trgsw.gadget_values(tiny).astype(np.int64)
    rec_a = sum(rows[:, i] * h[i] for i in range(tiny.L))
    rec_b = sum(rows[:, i + tiny.L] * h[i] for i in range(tiny.L))
    rec = np.stack([rec_a, rec_b], 1).astype(np.int64)
    rec = np.int32(np.uint32(rec & 0xFFFFFFFF))
    dec = np.asarray(trlwe.decrypt_bool(jnp.asarray(rec), tiny_sk.key_lv1))
    assert np.array_equal(dec, np.asarray(bits))
