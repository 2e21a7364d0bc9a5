"""64-bit-torus pipeline (TEST_TINY64): width-generalized exactness.

The reference pins Torus=u32 at comptime (params.zig:21-30).  This suite
drives the width-generalized pipeline — 64-bit codecs, the widened NTT
plan (6 prime planes vs 3), int64 carriers through encrypt / gadget
decompose / blind rotate / key switch — to decrypt-exactness at alpha=0,
the round-4 Torus64 spike gate (docs/TORUS64.md has the N=2048 go/no-go
memo this enables).  Requires jax_enable_x64 (set in conftest).
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
from zig_tfhe_jax.utils.torus import (require_width, to_carrier,
                                      torus_constant_w)

pytestmark = pytest.mark.skipif(
    jnp.zeros((), jnp.int64).dtype != jnp.int64,
    reason="jax_enable_x64 is off (conftest normally enables it)")


@pytest.fixture(scope="module")
def p64():
    return P.TEST_TINY64


@pytest.fixture(scope="module")
def sk64(p64):
    return K.SecretKey.generate(jax.random.key(7), p64)


@pytest.fixture(scope="module")
def ck64(p64, sk64):
    return K.CloudKey.generate(jax.random.key(8), sk64, p64)


def test_params_width(p64):
    assert p64.torus_bits == 64 and p64.torus_mod == 1 << 64
    require_width(64)  # x64 on in the suite: must not raise
    # offsets live mod 2^64 (key.zig:121-131 at width 64)
    assert 0 <= p64.decomposition_offset < 1 << 64
    assert p64.ks_prec_offset == 1 << (64 - (1 + p64.basebit * p64.iks_t))


def test_codec_constants():
    # dyadic constants encode exactly at width 64
    assert torus_constant_w(0.125, 64) == 1 << 61
    assert torus_constant_w(-0.125, 64) == 7 << 61
    assert int(to_carrier(1 << 63, 64)) == -(1 << 63)  # wraps to int64 min


def test_ntt64_roundtrip_and_binary_polymul_oracle(p64):
    rng = np.random.default_rng(0)
    N = p64.N
    a = rng.integers(-2**63, 2**63, (2, N)).astype(np.int64)
    plan = NTT.make_plan(N, 63 + 7)
    hat = NTT.ntt_forward(jnp.asarray(a), plan, digit_limbs=8,
                          digit_bound=128)
    back = NTT.ntt_inverse_to_crt(hat, plan, 64)
    assert np.array_equal(np.asarray(back), a)

    # negacyclic a*s mod 2^64 vs big-int schoolbook (fft.zig:695-714 style)
    s = rng.integers(0, 2, N).astype(np.int64)
    from zig_tfhe_jax.ops.poly import negacyclic_polymul_binary
    got = np.asarray(negacyclic_polymul_binary(jnp.asarray(a),
                                               jnp.asarray(s)))
    ref = np.zeros((2, N), dtype=object)
    for b_ in range(2):
        for k in range(N):
            if s[k]:
                for j in range(N):
                    idx = k + j
                    if idx < N:
                        ref[b_, idx] += int(a[b_, j])
                    else:
                        ref[b_, idx - N] -= int(a[b_, j])
    ref = np.array([[int(v) & (2**64 - 1) for v in row] for row in ref],
                   dtype=np.uint64).astype(np.int64)
    assert np.array_equal(got, ref)


def test_tlwe64_roundtrips(p64, sk64):
    rng = np.random.default_rng(1)
    bits = jnp.asarray(rng.integers(0, 2, 16).astype(bool))
    ct = tlwe.encrypt_bool(jax.random.key(1), bits, 0.0, sk64.key_lv0,
                           width=64)
    assert ct.dtype == jnp.int64
    assert (np.asarray(tlwe.decrypt_bool(ct, sk64.key_lv0))
            == np.asarray(bits)).all()

    msg = jnp.asarray(rng.integers(0, 16, 32))
    ctm = tlwe.encrypt_message(jax.random.key(2), msg, 16, 0.0,
                               sk64.key_lv0, width=64)
    assert (np.asarray(tlwe.decrypt_message(ctm, 16, sk64.key_lv0, width=64))
            == np.asarray(msg)).all()


def test_gate_truth_tables_64(p64, sk64, ck64, request):
    assert ck64.bsk_ntt.dtype == jnp.int16        # residues stay 16-bit
    assert ck64.ksk1.dtype == jnp.int64
    # widened plan: the 64-bit key bound needs ~2x the prime planes
    assert ck64.bsk_ntt.shape[2] >= 5
    from tests.conftest import TRUTH_TABLES
    xs = jnp.asarray([False, False, True, True])
    ys = jnp.asarray([False, True, False, True])
    ca = tlwe.encrypt_bool(jax.random.key(3), xs, 0.0, sk64.key_lv0, width=64)
    cb = tlwe.encrypt_bool(jax.random.key(4), ys, 0.0, sk64.key_lv0, width=64)
    for name, fn in TRUTH_TABLES.items():
        out = G.gate(name, ca, cb, ck64)
        dec = np.asarray(tlwe.decrypt_bool(out, sk64.key_lv0))
        exp = np.asarray([bool(fn(bool(x), bool(y)))
                          for x, y in zip(np.asarray(xs), np.asarray(ys))])
        assert (dec == exp).all(), (name, dec.tolist(), exp.tolist())


def test_heterogeneous_gates_and_mux_64(p64, sk64, ck64):
    rng = np.random.default_rng(5)
    B = 12
    ids = jnp.asarray(rng.integers(0, len(G.GATE_NAMES), B), jnp.int32)
    xa = rng.integers(0, 2, B).astype(bool)
    xb = rng.integers(0, 2, B).astype(bool)
    ca = tlwe.encrypt_bool(jax.random.key(5), jnp.asarray(xa), 0.0,
                           sk64.key_lv0, width=64)
    cb = tlwe.encrypt_bool(jax.random.key(6), jnp.asarray(xb), 0.0,
                           sk64.key_lv0, width=64)
    out = G.apply_gates(ids, ca, cb, ck64)
    dec = np.asarray(tlwe.decrypt_bool(out, sk64.key_lv0))
    from tests.conftest import TRUTH_TABLES
    exp = np.asarray([bool(TRUTH_TABLES[G.GATE_NAMES[i]](bool(a), bool(b)))
                      for i, a, b in zip(np.asarray(ids), xa, xb)])
    assert (dec == exp).all()

    sel = rng.integers(0, 2, B).astype(bool)
    cs = tlwe.encrypt_bool(jax.random.key(9), jnp.asarray(sel), 0.0,
                           sk64.key_lv0, width=64)
    mx = G.mux(cs, ca, cb, ck64)
    dec = np.asarray(tlwe.decrypt_bool(mx, sk64.key_lv0))
    exp = np.where(sel, xa, xb)
    assert (dec == exp).all()


def test_ciphertext_serialization_64(tmp_path, p64, sk64):
    from zig_tfhe_jax.utils import serialization as S
    bits = jnp.asarray([True, False, True])
    ct = tlwe.encrypt_bool(jax.random.key(11), bits, 0.0, sk64.key_lv0,
                           width=64)
    S.save_ciphertext(tmp_path / "c64", ct, p64)
    ct2, p2 = S.load_ciphertext(tmp_path / "c64")
    assert p2.torus_bits == 64 and ct2.dtype == jnp.int64
    assert np.array_equal(np.asarray(ct), np.asarray(ct2))


def test_toeplitz_engine_rejected_at_64(p64, sk64):
    with pytest.raises(ValueError, match="Toeplitz"):
        K.CloudKey.generate(jax.random.key(1), sk64, p64,
                            engines=("ntt", "toeplitz"))
