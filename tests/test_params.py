"""Parameter-set sanity (params.zig:431-466 analog)."""

import numpy as np

from zig_tfhe_jax import params as P


def test_all_sets_sane():
    for p in P.ALL_PARAMS:
        assert p.tlwe_lv0.n > 0
        assert p.tlwe_lv1.n > 0
        assert p.tlwe_lv0.alpha > 0.0
        assert p.tlwe_lv1.alpha > 0.0
        assert p.trgsw_lv1.l > 0
        assert p.trgsw_lv1.bgbit > 0
        assert p.trgsw_lv1.bg == 1 << p.trgsw_lv1.bgbit
        assert p.N == 1 << p.nbit
        assert p.basebit * p.iks_t < 32
        assert p.bgbit * p.L <= 32


def test_constants_match_reference():
    assert P.SECURITY_80_BIT.security_bits == 80
    assert P.SECURITY_110_BIT.security_bits == 110
    assert P.SECURITY_128_BIT.security_bits == 128
    assert P.SECURITY_UINT1.security_bits == 1
    assert P.SECURITY_UINT5.security_bits == 5
    assert P.SECURITY_UINT8.security_bits == 8
    # 128-bit set values (params.zig:350-378)
    p = P.SECURITY_128_BIT
    assert (p.n0, p.N, p.bgbit, p.L, p.basebit, p.iks_t) == (700, 1024, 6, 3, 2, 9)
    assert p.tlwe_lv0.alpha == 2.0e-5 and p.tlwe_lv1.alpha == 2.0e-8
    assert P.DEFAULT_SECURITY is P.SECURITY_128_BIT


def test_decomposition_offset_128bit():
    # offset = sum_i 32 * 2^(32-6(i+1)) for L=3 (key.zig:121-131)
    p = P.SECURITY_128_BIT
    expected = (32 * (1 << 26) + 32 * (1 << 20) + 32 * (1 << 14)) % (1 << 32)
    assert p.decomposition_offset == expected


def test_digit_limbs():
    assert P.SECURITY_128_BIT.digit_limbs == 1   # bgbit=6
    assert P.SECURITY_UINT1.digit_limbs == 2     # bgbit=10
    assert P.SECURITY_UINT3.digit_limbs == 3     # bgbit=23


def test_security_info():
    assert "128" in P.security_info(P.SECURITY_128_BIT)


def test_t64_set_measurement_tuned_constants():
    """SECURITY_128_BIT_T64's precision gadgets are MEASUREMENT-tuned
    (docs/TORUS64.md §8-9): basebit4/iks_t6 KS put sigma_KS exactly on
    the m=64 half-bin (measured 0.52), and the L=2/(2,2) engine gadget's
    key-amplified a-truncation alone was sigma 2^-8.2 (measured 0.72).
    The pinned constants deliver the measured m=4..32 all-exact
    single-shot envelope — guard them."""
    from zig_tfhe_jax.ops import ntt as N

    p = P.SECURITY_128_BIT_T64
    assert (p.n0, p.N, p.torus_bits) == (768, 2048, 64)
    assert (p.bgbit, p.L) == (8, 3)
    assert (p.basebit, p.iks_t) == (2, 12)          # sigma_KS = 2^-9.4
    assert N.default_engine_gadget(p, 2) == (8, (3, 2))  # a-side 24 bits
    assert N.default_group(p) == 2
    assert p.split_ring
    # the spike-era alias still resolves
    assert P.PARAMS_BY_NAME["draft128_t64"] is p
