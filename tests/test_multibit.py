"""Multi-bit (group-2) blind rotation: decrypt-level equivalence with the
single-bit path, odd-n0 padding, and CloudKey serialization with group."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import gates as G
from zig_tfhe_jax.utils import serialization as S


def _gate_roundtrip(params, group, seed=0):
    sk = K.SecretKey.generate(jax.random.key(seed), params)
    ck = K.CloudKey.generate(jax.random.key(seed + 1), sk, params, group=group)
    bits_a = jnp.asarray(np.array([0, 0, 1, 1], bool))
    bits_b = jnp.asarray(np.array([0, 1, 0, 1], bool))
    cta = tlwe.encrypt_bool(jax.random.key(seed + 2), bits_a,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(seed + 3), bits_b,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    out = G.gate("nand", cta, ctb, ck)
    return list(np.asarray(tlwe.decrypt_bool(out, sk.key_lv0)))


def test_group2_matches_group1_truth_table(tiny):
    expected = [True, True, True, False]
    assert _gate_roundtrip(tiny, group=1) == expected
    assert _gate_roundtrip(tiny, group=2) == expected


def test_group2_odd_n0():
    """Odd LWE dimension pads the last pair with a zero key bit."""
    base = P.TEST_TINY
    import dataclasses
    odd = dataclasses.replace(
        base, name="tiny_odd",
        tlwe_lv0=dataclasses.replace(base.tlwe_lv0, n=base.tlwe_lv0.n - 1))
    assert odd.n0 % 2 == 1
    expected = [True, True, True, False]
    assert _gate_roundtrip(odd, group=2, seed=10) == expected


def test_cloud_key_serialization_group2(tmp_path, tiny, tiny_sk):
    ck = K.CloudKey.generate(jax.random.key(3), tiny_sk, tiny, group=2)
    path = tmp_path / "ck.npz"
    S.save_cloud_key(path, ck)
    ck2 = S.load_cloud_key(path)
    assert ck2.bsk_group == 2
    assert ck2.bsk_ntt_drop == ck.bsk_ntt_drop
    assert np.array_equal(np.asarray(ck.bsk_ntt), np.asarray(ck2.bsk_ntt))
    assert np.array_equal(np.asarray(ck.ksk1), np.asarray(ck2.ksk1))


def test_toeplitz_only_cloud_key_falls_back(tiny, tiny_sk):
    """A cloud key holding only the Toeplitz BSK (e.g. saved by an older
    version) must still evaluate gates: the 'ntt' default falls back."""
    ck = K.CloudKey.generate(jax.random.key(7), tiny_sk, tiny,
                             engines=("toeplitz",))
    assert ck.bsk_ntt is None and ck.bsk_ext_limbs is not None
    bits_a = jnp.asarray(np.array([0, 1], bool))
    bits_b = jnp.asarray(np.array([1, 1], bool))
    cta = tlwe.encrypt_bool(jax.random.key(8), bits_a, 0.0, tiny_sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(9), bits_b, 0.0, tiny_sk.key_lv0)
    out = G.gate("and", cta, ctb, ck)
    assert list(np.asarray(tlwe.decrypt_bool(out, tiny_sk.key_lv0))) == [False, True]


def test_keygen_deterministic(tiny):
    """Same PRNG key -> identical CloudKey (golden-vector property the
    reference lacks; utils.zig:16-22 reseeds from wall clock)."""
    sk = K.SecretKey.generate(jax.random.key(11), tiny)
    ck1 = K.CloudKey.generate(jax.random.key(12), sk, tiny)
    ck2 = K.CloudKey.generate(jax.random.key(12), sk, tiny)
    for a, b in zip(jax.tree_util.tree_leaves(ck1),
                    jax.tree_util.tree_leaves(ck2)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


from tests.conftest import TRUTH_TABLES as _TT


@pytest.mark.parametrize("group", [1, 2, 3, 4])
def test_all_gates_truth_tables_by_group(tiny, tiny_sk, group):
    """Every two-input gate, all four input combinations, both blind-rotate
    groupings — exact decrypts (gates.zig:374-544 parity)."""
    ck = K.CloudKey.generate(jax.random.key(20 + group), tiny_sk, tiny,
                             group=group)
    bits_a = jnp.asarray(np.array([0, 0, 1, 1], bool))
    bits_b = jnp.asarray(np.array([0, 1, 0, 1], bool))
    cta = tlwe.encrypt_bool(jax.random.key(30), bits_a, 0.0, tiny_sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(31), bits_b, 0.0, tiny_sk.key_lv0)
    ids = jnp.arange(len(G.GATE_NAMES), dtype=jnp.int32)
    # heterogeneous batch: every gate on every input combo in one call
    ids_full = jnp.repeat(ids, 4)
    a_full = jnp.tile(cta, (len(G.GATE_NAMES), 1))
    b_full = jnp.tile(ctb, (len(G.GATE_NAMES), 1))
    out = G.apply_gates(ids_full, a_full, b_full, ck)
    dec = np.asarray(tlwe.decrypt_bool(out, tiny_sk.key_lv0))
    k = 0
    for name in G.GATE_NAMES:
        for x, y in [(0, 0), (0, 1), (1, 0), (1, 1)]:
            assert bool(dec[k]) == bool(_TT[name](bool(x), bool(y))), \
                (name, x, y, group)
            k += 1


def test_group4_matches_group1_truth_table(tiny):
    """Group-4 multi-bit rotation (one decompose/fwd/inv per FOUR LWE
    coefficients; BSK encrypts all 15 subset products) decrypts exactly
    like the single-bit path.  tiny has n0=8 -> exactly 2 groups."""
    expected = _gate_roundtrip(tiny, group=1)
    assert _gate_roundtrip(tiny, group=4) == expected


def test_group3_ragged_n0():
    """n0=8 with group=3 -> G=3 with one zero-padded key bit."""
    from zig_tfhe_jax import params as P
    expected = _gate_roundtrip(P.TEST_TINY, group=1, seed=30)
    assert _gate_roundtrip(P.TEST_TINY, group=3, seed=30) == expected


@pytest.mark.parametrize("levels", [(2, 1), (1, 2)])
def test_asymmetric_gadget_truth_table(levels):
    """Asymmetric decomposition levels (la a-rows, lb b-rows — the
    a-component keeps more precision because its truncation error is
    key-convolution-amplified in the phase, ops/ntt.py:norm_levels).
    TEST_TINY margins absorb the truncation; truth table stays exact."""
    params = P.TEST_TINY
    sk = K.SecretKey.generate(jax.random.key(40), params)
    ck = K.CloudKey.generate(jax.random.key(41), sk, params,
                             decomp_levels=levels)
    assert ck.bsk_levels == levels
    assert ck.bsk_ntt.shape[3] == levels[0] + levels[1]
    bits_a = jnp.asarray(np.array([0, 0, 1, 1], bool))
    bits_b = jnp.asarray(np.array([0, 1, 0, 1], bool))
    cta = tlwe.encrypt_bool(jax.random.key(42), bits_a,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(43), bits_b,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    out = G.gate("nand", cta, ctb, ck)
    assert list(np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))) == \
        [True, True, True, False]


def test_asymmetric_key_serialization_roundtrip(tmp_path, tiny, tiny_sk):
    ck = K.CloudKey.generate(jax.random.key(44), tiny_sk, tiny,
                             decomp_levels=(2, 1))
    path = tmp_path / "ck_asym.npz"
    S.save_cloud_key(path, ck)
    ck2 = S.load_cloud_key(path)
    assert ck2.bsk_levels == (2, 1)
    assert np.array_equal(np.asarray(ck.bsk_ntt), np.asarray(ck2.bsk_ntt))


def test_rotate_combine_wide_matches_narrow():
    """The pointwise/rotate barrett FOLD (unreduced pointwise sums +
    per-term combine reduction) must agree with the reduced/pairwise
    path exactly mod every plan prime, including at the bound-stressing
    extremes (residues at +-(p/2 + 384), the barrett output envelope)."""
    from zig_tfhe_jax.ops import ntt as NTT

    plan = NTT.make_plan(1024, 45)          # the production 3-prime plan
    rng = np.random.default_rng(0)
    B, g = 4, 3
    ts = [jnp.asarray(rng.integers(0, 2048, B).astype(np.int32))
          for _ in range(g)]
    us_wide, us_narrow = [], []
    for m in range((1 << g) - 1):
        per_prime_w, per_prime_n = [], []
        for p in plan.primes:
            hi = p + 768                     # the documented wide bound
            v = rng.integers(-hi, hi + 1, (B, 2, 1024)).astype(np.int32)
            per_prime_w.append(jnp.asarray(v))
            # narrow variant: the same values centered into [-p/2, p/2]
            per_prime_n.append(jnp.asarray(
                ((v + p // 2) % p) - p // 2))
        us_wide.append(per_prime_w)
        us_narrow.append(per_prime_n)
    out_w = NTT.rotate_combine_multi(us_wide, ts, plan, u_wide=True)
    out_n = NTT.rotate_combine_multi(us_narrow, ts, plan, u_wide=False)
    for i, p in enumerate(plan.primes):
        a = np.asarray(out_w[i]).astype(np.int64)
        b = np.asarray(out_n[i]).astype(np.int64)
        assert ((a - b) % p == 0).all(), p
        assert np.abs(a).max() <= 0.55 * p
