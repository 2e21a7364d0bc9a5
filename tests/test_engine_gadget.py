"""ENGINE gadget: the NTT BSK's own decomposition base, decoupled from the
parameter set's (Bg, L) (ops/ntt.py:default_engine_gadget; no reference
analog — the reference's gadget base is comptime-pinned, params.zig:386-416).

Covers: default selection per parameter family, digit/reconstruction
exactness at a non-parameter base, gadget-row key encryption phases,
end-to-end truth tables, the Hoeffding 3-prime plan (docs/NOISE.md §2b),
and CloudKey serialization of the engine base.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax import tlwe, trgsw, trlwe
from zig_tfhe_jax.ops import ntt as NTT
from zig_tfhe_jax.ops.decomposition import gadget_decompose, gadget_offset
from zig_tfhe_jax.utils import serialization as S


def test_default_engine_gadget_selection():
    """Boolean sets (bgbit=6, L=3, N>=1024) get Bg_e=2^8 with (2,2) rows
    at group<=2 and Bg_e=2^7 at group>=3 (the per-set default group for
    those sets IS 3); Uint sets and TEST_TINY keep the parameter base."""
    for p in (P.SECURITY_80_BIT, P.SECURITY_110_BIT, P.SECURITY_128_BIT):
        assert NTT.default_engine_gadget(p) == (8, (2, 2))
        assert NTT.default_engine_gadget(p, group=3) == (7, (2, 2))
        assert NTT.default_group(p) == 3
    for p in (P.SECURITY_UINT2, P.SECURITY_UINT4, P.SECURITY_UINT8,
              P.TEST_TINY, P.TEST_TINY_UINT):
        bg, lv = NTT.default_engine_gadget(p)
        assert bg == p.bgbit
        assert lv == NTT.default_decomp_levels(p)
        assert NTT.default_group(p) == 2


def test_gadget_offset_matches_reference_at_parameter_base():
    """gadget_offset(bgbit, L) reproduces the reference offset
    (key.zig:121-131) for every parameter set."""
    for p in P.ALL_PARAMS + (P.TEST_TINY, P.TEST_TINY_UINT):
        assert gadget_offset(p.bgbit, p.L) == p.decomposition_offset


def test_engine_base_digits_bounded_and_exact(rng):
    """bgbit=8 with all 32/8=4 levels: digits in [-128, 128) and the
    reconstruction is EXACT (the offset covers every level, so the
    truncation remainder is zero)."""
    p = P.SECURITY_128_BIT
    xs = rng.integers(-2 ** 31, 2 ** 31, 1024).astype(np.int32)
    digs = np.asarray(
        gadget_decompose(jnp.asarray(xs), p, levels=4, bgbit=8)
    ).astype(np.int64)
    assert digs.min() >= -128 and digs.max() < 128
    recon = sum(digs[:, i] << (32 - (i + 1) * 8) for i in range(4))
    assert np.all((recon - xs.astype(np.int64)) % (1 << 32) == 0)


def test_engine_base_truncated_remainder_centered(rng):
    """Keeping only the top 2 of 4 levels: the remainder is CENTERED —
    recon - x = 2^15 + 2^7 - (tmp mod 2^16) ∈ (-2^15+2^7, 2^15+2^7],
    where the 2^7 is the offset's own sub-level-2 half terms — unlike the
    parameter-gadget one-sided remainder (test_decomposition.py)."""
    p = P.SECURITY_128_BIT
    xs = rng.integers(-2 ** 31, 2 ** 31, 4096).astype(np.int32)
    digs = np.asarray(
        gadget_decompose(jnp.asarray(xs), p, levels=2, bgbit=8)
    ).astype(np.int64)
    recon = sum(digs[:, i] << (32 - (i + 1) * 8) for i in range(2))
    err = (recon - xs.astype(np.int64)) % (1 << 32)
    err = np.where(err >= 1 << 31, err - (1 << 32), err)
    assert np.all(err > -(1 << 15) + (1 << 7))
    assert np.all(err <= (1 << 15) + (1 << 7))
    # two-sided: both signs actually occur
    assert err.min() < 0 < err.max()


def test_encrypt_gadget_rows_phases(tiny, tiny_sk):
    """Row i of encrypt_gadget_rows decrypts (alpha=0) to p*Bg_e^-(i+1):
    a-rows carry it in the a-component's phase contribution, b-rows in b
    (trgsw.zig:16-72 generalized to an engine base)."""
    bgbit, (la, lb) = 8, (2, 2)
    vals = jnp.asarray([1, -1, 3], jnp.int32)
    ct = trgsw.encrypt_gadget_rows(
        jax.random.key(0), vals, 0.0, tiny_sk.key_lv1, tiny, bgbit, la, lb)
    assert ct.shape == (3, la + lb, 2, tiny.N)
    for r in range(la + lb):
        lvl = r if r < la else r - la
        h = 1 << (32 - (lvl + 1) * bgbit)
        ph = np.asarray(trlwe.phase(ct[:, r], tiny_sk.key_lv1))
        expect = np.zeros((3, tiny.N), np.int64)
        if r < la:
            # a-row: phase = b - a*s picks up -(p*h)*s; check by adding
            # back a*s: the planted coefficient sits in a[0]
            a0 = np.asarray(ct[:, r, 0, 0]).astype(np.int64)
            zr = trgsw.encrypt_gadget_rows(
                jax.random.key(0), jnp.zeros(3, jnp.int32), 0.0,
                tiny_sk.key_lv1, tiny, bgbit, la, lb)
            a0z = np.asarray(zr[:, r, 0, 0]).astype(np.int64)
            assert np.all((a0 - a0z - np.asarray(vals, np.int64) * h)
                          % (1 << 32) == 0)
            continue
        expect[:, 0] = (np.asarray(vals, np.int64) * h) % (1 << 32)
        assert np.all((ph.astype(np.int64) - expect) % (1 << 32) == 0)


def test_engine_gadget_truth_table(tiny):
    """End-to-end gates at an explicit engine base (tiny margins absorb
    the ±2^15 truncation; alpha=0 keeps decrypts exact)."""
    from zig_tfhe_jax.models import gates as G

    sk = K.SecretKey.generate(jax.random.key(50), tiny)
    ck = K.CloudKey.generate(jax.random.key(51), sk, tiny,
                             engine_bgbit=8, decomp_levels=(2, 2))
    assert ck.bsk_bgbit == 8 and ck.bsk_levels == (2, 2)
    bits_a = jnp.asarray(np.array([0, 0, 1, 1], bool))
    bits_b = jnp.asarray(np.array([0, 1, 0, 1], bool))
    cta = tlwe.encrypt_bool(jax.random.key(52), bits_a, 0.0, sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(53), bits_b, 0.0, sk.key_lv0)
    out = G.gate("nand", cta, ctb, ck)
    assert list(np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))) == \
        [True, True, True, False]
    out = G.gate("xor", cta, ctb, ck)
    assert list(np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))) == \
        [False, True, True, False]


def test_hoeffding_plan_stays_three_primes(monkeypatch):
    """The engine gadget's raison d'être: at 128-bit, Bg_e=2^8/(2,2)/
    group=2/drop=5 the worst-case bound needs a 4th prime but the
    Hoeffding tail bound (docs/NOISE.md §2b) keeps the 3-prime plan.
    ZTFHE_WORSTCASE_BOUND=1 restores the worst-case plan."""
    p = P.SECURITY_128_BIT
    drop = NTT.default_drop_bits(p, group=2, bgbit=8)
    assert drop == 5  # 128*2^5 == 32*2^7: same rounding amplitude
    monkeypatch.delenv("ZTFHE_WORSTCASE_BOUND", raising=False)
    plan = NTT.plan_for_params(p, drop, group=2, levels=(2, 2), bgbit=8)
    assert plan.n_primes == 3
    monkeypatch.setenv("ZTFHE_WORSTCASE_BOUND", "1")
    plan_wc = NTT.plan_for_params(p, drop, group=2, levels=(2, 2), bgbit=8)
    assert plan_wc.n_primes == 4
    # direct oracle plans (no pseudorandom_key) keep the worst-case bound
    plan_ref = NTT.plan_for_params(p, 7, group=2, levels=(3, 2))
    assert plan_ref.n_primes == 3
    # BSK paths get the tail bound at the PARAMETER base too: group-3 at
    # bg6/(3,2)/drop=5 is 3 primes pseudorandom, 4 worst-case
    monkeypatch.delenv("ZTFHE_WORSTCASE_BOUND", raising=False)
    g3 = NTT.plan_for_params(p, 5, group=3, levels=(3, 2), bgbit=6,
                             pseudorandom_key=True)
    assert g3.n_primes == 3
    g3_oracle = NTT.plan_for_params(p, 5, group=3, levels=(3, 2), bgbit=6)
    assert g3_oracle.n_primes == 4


def test_stale_key_prime_count_raises(tiny, tiny_ck):
    """A BSK whose CRT prime-plane count disagrees with the current plan
    (e.g. serialized under a different plan-bound version) must fail
    loudly, not decrypt to noise."""
    import dataclasses
    import jax.numpy as jnp
    import pytest
    from zig_tfhe_jax.ops.blind_rotate import blind_rotate

    bad = dataclasses.replace(
        tiny_ck, bsk_ntt=jnp.concatenate(
            [tiny_ck.bsk_ntt, tiny_ck.bsk_ntt[:, :, :1]], axis=2))
    ct = jnp.zeros((2, tiny.n0 + 1), jnp.int32)
    with pytest.raises(ValueError, match="prime planes"):
        blind_rotate(ct, bad.testvec, bad, tiny)


def test_cloud_key_serialization_engine_gadget(tmp_path, tiny, tiny_sk):
    ck = K.CloudKey.generate(jax.random.key(60), tiny_sk, tiny,
                             engine_bgbit=8, decomp_levels=(2, 2))
    path = tmp_path / "ck_engine.npz"
    S.save_cloud_key(path, ck)
    ck2 = S.load_cloud_key(path)
    assert ck2.bsk_bgbit == 8 and ck2.bsk_levels == (2, 2)
    assert np.array_equal(np.asarray(ck.bsk_ntt), np.asarray(ck2.bsk_ntt))


def test_default_keygen_picks_engine_gadget(tiny):
    """CloudKey.generate with no gadget args follows default_engine_gadget
    (tiny -> parameter base; fixture keys elsewhere rely on this)."""
    ck = K.CloudKey.generate_no_ksk(tiny)
    bg, lv = NTT.default_engine_gadget(tiny)
    assert ck.bsk_bgbit == bg and ck.bsk_levels == lv
