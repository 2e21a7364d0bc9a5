"""Key/ciphertext serialization round-trips (feature-add; reference has none)."""

import jax
import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import key as K, tlwe
from zig_tfhe_jax.models import proxy_reenc as PR
from zig_tfhe_jax.utils import serialization as S


def test_secret_key_roundtrip(tmp_path, tiny, tiny_sk):
    p = tmp_path / "sk.npz"
    S.save_secret_key(p, tiny_sk, tiny)
    sk2, params2 = S.load_secret_key(p)
    assert params2 is tiny
    assert np.array_equal(np.asarray(sk2.key_lv0), np.asarray(tiny_sk.key_lv0))
    assert np.array_equal(np.asarray(sk2.key_lv1), np.asarray(tiny_sk.key_lv1))


def test_cloud_key_roundtrip_and_use(tmp_path, tiny, tiny_sk, tiny_ck):
    p = tmp_path / "ck.npz"
    S.save_cloud_key(p, tiny_ck)
    ck2 = S.load_cloud_key(p)
    assert ck2.params is tiny
    assert np.array_equal(np.asarray(ck2.ksk1), np.asarray(tiny_ck.ksk1))
    # loaded key still evaluates gates correctly
    from zig_tfhe_jax.models import gates as G
    a = tlwe.encrypt_bool(jax.random.key(90), jnp.asarray([True, False]), 0.0,
                          tiny_sk.key_lv0)
    b = tlwe.encrypt_bool(jax.random.key(91), jnp.asarray([True, True]), 0.0,
                          tiny_sk.key_lv0)
    out = G.gate("and", a, b, ck2)
    assert list(np.asarray(tlwe.decrypt_bool(out, tiny_sk.key_lv0))) == [True, False]


def test_ciphertext_roundtrip(tmp_path, tiny, tiny_sk):
    ct = tlwe.encrypt_bool(jax.random.key(92), jnp.asarray([True, False]), 0.0,
                           tiny_sk.key_lv0)
    p = tmp_path / "ct.npz"
    S.save_ciphertext(p, ct, tiny)
    ct2, params2 = S.load_ciphertext(p)
    assert params2 is tiny
    assert np.array_equal(np.asarray(ct2), np.asarray(ct))


def test_public_and_reenc_key_roundtrip(tmp_path, tiny, tiny_sk):
    pk = PR.PublicKeyLv0.generate(jax.random.key(93), tiny_sk.key_lv0, tiny)
    S.save_public_key(tmp_path / "pk.npz", pk, tiny)
    pk2, _ = S.load_public_key(tmp_path / "pk.npz")
    assert np.array_equal(np.asarray(pk2.encryptions), np.asarray(pk.encryptions))

    sk2 = K.SecretKey.generate(jax.random.key(94), tiny)
    rk = PR.ProxyReencryptionKey.new_symmetric(
        jax.random.key(95), tiny_sk.key_lv0, sk2.key_lv0, tiny)
    S.save_reenc_key(tmp_path / "rk.npz", rk, tiny)
    rk2, _ = S.load_reenc_key(tmp_path / "rk.npz")
    assert rk2.basebit == rk.basebit and rk2.t == rk.t
    assert np.array_equal(np.asarray(rk2.key_encryptions),
                          np.asarray(rk.key_encryptions))


def test_custom_params_roundtrip(tmp_path, tiny, tiny_sk):
    """Tweaked (non-stock) SecurityParams must round-trip field-for-field
    via the embedded manifest, not by stock-name lookup."""
    import dataclasses

    from zig_tfhe_jax import params as P

    custom = dataclasses.replace(
        tiny, tlwe_lv0=P.TlweParams(n=tiny.n0, alpha=1e-9),
        description="tweaked tiny")
    p = tmp_path / "sk_custom.npz"
    S.save_secret_key(p, tiny_sk, custom)
    _, params2 = S.load_secret_key(p)
    assert params2 == custom
    assert params2 is not tiny
    assert params2.tlwe_lv0.alpha == 1e-9


def test_extensionless_path_roundtrip(tmp_path, tiny, tiny_sk):
    """np.savez appends '.npz'; load must mirror that."""
    p = tmp_path / "sk_noext"
    S.save_secret_key(p, tiny_sk, tiny)
    sk2, _ = S.load_secret_key(p)
    assert np.array_equal(np.asarray(sk2.key_lv0), np.asarray(tiny_sk.key_lv0))


def test_wrong_kind_raises(tmp_path, tiny, tiny_sk):
    import pytest

    p = tmp_path / "sk2.npz"
    S.save_secret_key(p, tiny_sk, tiny)
    with pytest.raises(ValueError, match="expected a 'cloud_key'"):
        S.load_cloud_key(p)


def test_seeded_ciphertext_roundtrip(tmp_path, tiny, tiny_sk):
    """Seeded (compressed) ciphertexts: (key, b) expands to EXACTLY the
    full encryption; save/load round-trips in both forms."""
    import pytest

    kk = jax.random.key(5)
    bits = jnp.asarray(np.array([0, 1, 1, 0], bool))
    full = tlwe.encrypt_bool(kk, bits, 0.0, tiny_sk.key_lv0)
    seed, b = tlwe.encrypt_bool_seeded(kk, bits, 0.0, tiny_sk.key_lv0)
    assert b.shape == (4,)                      # (n0+1)x smaller
    # the published mask seed is NOT the encryption key (which also
    # derives the noise and must stay secret)
    assert not np.array_equal(np.asarray(jax.random.key_data(seed)),
                              np.asarray(jax.random.key_data(kk)))
    assert np.array_equal(np.asarray(full),
                          np.asarray(tlwe.expand_seeded(seed, b, tiny.n0)))
    path = tmp_path / "ct_seeded.npz"
    S.save_seeded_ciphertext(path, seed, b, tiny)
    ct2, p2 = S.load_seeded_ciphertext(path)
    assert p2 == tiny
    assert np.array_equal(np.asarray(full), np.asarray(ct2))
    (k3, b3), _ = S.load_seeded_ciphertext(path, expand=False)
    assert np.array_equal(np.asarray(b3), np.asarray(b))
    # wrong-kind guard
    with pytest.raises(ValueError, match="expected"):
        S.load_ciphertext(path)


def test_packing_ksk_roundtrip(tmp_path):
    """Packing key round-trips with its basebit/t contract, and the loaded
    key drives the radix tree-PBS to the same exact result."""
    import numpy as np

    from zig_tfhe_jax import key as K
    from zig_tfhe_jax import params as P
    from zig_tfhe_jax.models import lut as L
    from zig_tfhe_jax.ops.packing_keyswitch import gen_packing_ksk

    params = P.TEST_TINY_UINT
    sk = K.SecretKey.generate(jax.random.key(7), params)
    ck = K.CloudKey.generate(jax.random.key(8), sk, params)
    pksk = gen_packing_ksk(jax.random.key(9), sk.key_lv1, params)
    S.save_packing_ksk(tmp_path / "pksk", pksk, params)
    pksk2, p2, basebit, t = S.load_packing_ksk(tmp_path / "pksk")
    assert p2 == params and (basebit, t) == (params.basebit, params.iks_t)
    assert np.array_equal(np.asarray(pksk), np.asarray(pksk2))
    m, f = 64, (lambda x: (x * 3 + 5) % 64)
    cts = L.encrypt_radix_message(jax.random.key(10), np.array([9, 40]), m,
                                  0.0, sk.key_lv0)
    out = L.bootstrap_lut_radix(*cts, f, m, ck, pksk2)
    assert list(np.asarray(L.decrypt_radix_message(out, m, sk.key_lv0))) \
        == [f(9), f(40)]


def test_cloud_key_with_packing_key_roundtrip(tmp_path, tiny, tiny_sk):
    ck = K.CloudKey.generate(jax.random.key(9), tiny_sk, tiny,
                             packing_key=True)
    S.save_cloud_key(tmp_path / "ckpk", ck)
    ck2 = S.load_cloud_key(tmp_path / "ckpk")
    assert ck2.pksk is not None
    assert np.array_equal(np.asarray(ck.pksk), np.asarray(ck2.pksk))
    # a key saved without one loads with pksk None
    S.save_cloud_key(tmp_path / "cknopk", K.CloudKey.generate(
        jax.random.key(10), tiny_sk, tiny))
    assert S.load_cloud_key(tmp_path / "cknopk").pksk is None
