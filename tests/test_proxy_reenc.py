"""Proxy re-encryption: public keys, symmetric/asymmetric re-enc keys,
multi-hop chains (proxy_reenc.zig:310-455 analog)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import key as K, params as P, tlwe
from zig_tfhe_jax.models import proxy_reenc as PR


@pytest.fixture(scope="module")
def keys(tiny):
    ks = jax.random.split(jax.random.key(60), 3)
    return [K.SecretKey.generate(k, tiny) for k in ks]


def test_public_key_encryption_exact(tiny, keys):
    alice = keys[0]
    pk = PR.PublicKeyLv0.generate(jax.random.key(61), alice.key_lv0, tiny)
    bits = jnp.asarray([True, False, True, True, False])
    ct = pk.encrypt_bool(jax.random.key(62), bits, tiny.tlwe_lv0.alpha)
    dec = np.asarray(tlwe.decrypt_bool(ct, alice.key_lv0))
    assert np.array_equal(dec, np.asarray(bits))


def test_public_key_statistical_128bit(rng):
    p = P.SECURITY_128_BIT
    sk = K.SecretKey.generate(jax.random.key(63), p)
    pk = PR.PublicKeyLv0.generate(jax.random.key(64), sk.key_lv0, p)
    bits = jnp.asarray(rng.integers(0, 2, 100).astype(bool))
    ct = pk.encrypt_bool(jax.random.key(65), bits, p.tlwe_lv0.alpha)
    dec = np.asarray(tlwe.decrypt_bool(ct, sk.key_lv0))
    assert (dec == np.asarray(bits)).mean() > 0.95


def test_reencrypt_symmetric(tiny, keys):
    alice, bob = keys[0], keys[1]
    rk = PR.ProxyReencryptionKey.new_symmetric(
        jax.random.key(66), alice.key_lv0, bob.key_lv0, tiny)
    bits = jnp.asarray([True, False, False, True])
    ct_a = tlwe.encrypt_bool(jax.random.key(67), bits, 0.0, alice.key_lv0)
    ct_b = PR.reencrypt(ct_a, rk)
    assert np.array_equal(np.asarray(tlwe.decrypt_bool(ct_b, bob.key_lv0)),
                          np.asarray(bits))


def test_reencrypt_asymmetric(tiny, keys):
    alice, bob = keys[0], keys[1]
    bob_pk = PR.PublicKeyLv0.generate(jax.random.key(68), bob.key_lv0, tiny)
    rk = PR.ProxyReencryptionKey.new_asymmetric(
        jax.random.key(69), alice.key_lv0, bob_pk, tiny)
    bits = jnp.asarray([True, False])
    ct_a = tlwe.encrypt_bool(jax.random.key(70), bits, 0.0, alice.key_lv0)
    ct_b = PR.reencrypt(ct_a, rk)
    assert np.array_equal(np.asarray(tlwe.decrypt_bool(ct_b, bob.key_lv0)),
                          np.asarray(bits))


def test_reencrypt_chain_alice_bob_carol(tiny, keys):
    # 3-hop chain (proxy_reenc.zig:429-455)
    alice, bob, carol = keys
    bob_pk = PR.PublicKeyLv0.generate(jax.random.key(71), bob.key_lv0, tiny)
    carol_pk = PR.PublicKeyLv0.generate(jax.random.key(72), carol.key_lv0, tiny)
    rk_ab = PR.ProxyReencryptionKey.new_asymmetric(
        jax.random.key(73), alice.key_lv0, bob_pk, tiny)
    rk_bc = PR.ProxyReencryptionKey.new_asymmetric(
        jax.random.key(74), bob.key_lv0, carol_pk, tiny)
    bits = jnp.asarray([True, False, True])
    ct_a = tlwe.encrypt_bool(jax.random.key(75), bits, 0.0, alice.key_lv0)
    ct_b = PR.reencrypt(ct_a, rk_ab)
    assert np.array_equal(np.asarray(tlwe.decrypt_bool(ct_b, bob.key_lv0)),
                          np.asarray(bits))
    ct_c = PR.reencrypt(ct_b, rk_bc)
    assert np.array_equal(np.asarray(tlwe.decrypt_bool(ct_c, carol.key_lv0)),
                          np.asarray(bits))


def test_reencrypt_statistical_128bit(rng):
    # >=90% over many messages at real noise (proxy_reenc.zig:401-427)
    p = P.SECURITY_128_BIT
    alice = K.SecretKey.generate(jax.random.key(76), p)
    bob = K.SecretKey.generate(jax.random.key(77), p)
    rk = PR.ProxyReencryptionKey.new_symmetric(
        jax.random.key(78), alice.key_lv0, bob.key_lv0, p)
    bits = jnp.asarray(rng.integers(0, 2, 100).astype(bool))
    ct_a = tlwe.encrypt_bool(jax.random.key(79), bits, p.tlwe_lv0.alpha,
                             alice.key_lv0)
    ct_b = PR.reencrypt(ct_a, rk)
    dec = np.asarray(tlwe.decrypt_bool(ct_b, bob.key_lv0))
    assert (dec == np.asarray(bits)).mean() > 0.90
