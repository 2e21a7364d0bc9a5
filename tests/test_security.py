"""Tests for the in-tree LWE security estimator (utils/security.py).

Pure host-side math — no JAX device work.  Anchors:
  * Kyber512 primal beta ~403 (NIST round-3 core-SVP analysis) validates
    the uSVP success condition at nu=1;
  * the tfhe-rs Q=2^64 GLWE corpus point (k=1, N=2048, std 2^-51.5)
    reproduces its public 128-bit claim under the gate model (~130);
  * the reference's Uint2-8 lv1 alphas (params.zig:126-347) are flagged
    noiseless-after-discretization on the u32 torus (docs/SECURITY.md).
"""

import math

import pytest

from zig_tfhe_jax import params as P
from zig_tfhe_jax.utils.security import (LweEstimate, estimate_lwe,
                                         estimate_params, log2_delta)


def test_log2_delta_known_values():
    # delta(beta) decreases in beta; classic reference point
    # delta(380) ~ 1.0041 (log2 ~ 0.0059)
    assert 0.0055 < log2_delta(380) < 0.0065
    assert log2_delta(400) < log2_delta(300) < log2_delta(200)


def test_kyber512_anchor():
    # n=512, q=3329, sigma~1.1, secret ~ error distribution: known primal
    # core-SVP beta ~403.  The m-optimized estimate lands within ~15.
    e = estimate_lwe(512, round(math.log2(3329)), 1.1 / 3329,
                     secret_std=1.1)
    assert 380 <= e.beta <= 420, e


def test_tfhe_rs_corpus_anchor_gate_model():
    # k=1/N=2048 glwe at std 2^-51.5, q=2^64 (binary secret): the public
    # claim is 128-bit under the lattice-estimator gate model.
    e = estimate_lwe(2048, 64, 2 ** -51.5)
    assert 125.0 <= e.gate_bits <= 136.0, e
    # core-SVP is the conservative bound, well below
    assert e.classical_bits < e.gate_bits - 25


def test_monotonicity():
    base = estimate_lwe(700, 32, 2e-5)
    more_noise = estimate_lwe(700, 32, 2e-4)
    bigger_n = estimate_lwe(900, 32, 2e-5)
    assert more_noise.classical_bits > base.classical_bits
    assert bigger_n.classical_bits > base.classical_bits
    assert base.quantum_bits < base.classical_bits < base.gate_bits


def test_noiseless_discretization_flagged():
    # sigma_abs < 0.5: the rounded gaussian is zero a.s. -> 0 security.
    e = estimate_lwe(1024, 32, 2.22e-16)  # the reference's Uint3+ lv1 alpha
    assert e.noiseless_discretized and e.classical_bits == 0.0
    # just above the rounding threshold: not flagged
    ok = estimate_lwe(1024, 32, 2.0 / 2 ** 32)
    assert not ok.noiseless_discretized and ok.classical_bits > 0


def test_insecure_test_sets_report_zero():
    for p in (P.TEST_TINY, P.TEST_TINY64, P.TEST_TINY_SPLIT):
        ep = estimate_params(p)
        assert ep.classical_bits == 0.0


@pytest.mark.parametrize("p", P.ALL_PARAMS, ids=lambda p: p.name)
def test_reference_sets_audit(p):
    """The audit documented in docs/SECURITY.md, asserted."""
    ep = estimate_params(p)
    if p.name in ("80bit", "110bit", "128bit", "uint1"):
        # boolean-family sets: ~87-100 core-SVP classical, 116-131 gates
        assert 80.0 <= ep.classical_bits <= 110.0, ep
        assert min(ep.lv0.gate_bits, ep.lv1.gate_bits) >= 110.0, ep
    else:
        # Uint2-8: lv1 noise rounds to zero on the u32 torus
        assert ep.lv1.noiseless_discretized, ep
        assert ep.classical_bits == 0.0
        # ... while their lv0 instances are fine (>= 100 core-SVP)
        assert ep.lv0.classical_bits >= 100.0, ep


def test_t64_set_clears_128_gate_bits():
    ep = estimate_params(P.SECURITY_128_BIT_T64)
    assert ep.lv0.gate_bits >= 128.0 and ep.lv1.gate_bits >= 128.0, ep
    # and dominates the public corpus point on both levels
    assert P.SECURITY_128_BIT_T64.n0 >= 742
    assert P.SECURITY_128_BIT_T64.tlwe_lv0.alpha >= 2 ** -17.1
    assert P.SECURITY_128_BIT_T64.trlwe_lv1.alpha >= 2 ** -51.5


def test_estimate_is_deterministic_and_printable():
    a = estimate_params(P.SECURITY_128_BIT)
    b = estimate_params(P.SECURITY_128_BIT)
    assert a == b
    assert "core-SVP" in str(a) and "lv0" in str(a)
    assert isinstance(a.lv0, LweEstimate)


def test_dual_cross_check_within_one_bit_of_primal():
    """The distinguishing-dual cross-check (estimate_dual_lwe) must land
    within ~1 bit of primal on every in-tree instance family — the
    quantified version of the module's scope claim."""
    from zig_tfhe_jax.utils.security import estimate_dual_lwe

    for n, q, s in [(1024, 32, 2e-8), (700, 32, 2e-5),
                    (2048, 64, 2 ** -49), (768, 64, 2 ** -17)]:
        p = estimate_lwe(n, q, s)
        d = estimate_dual_lwe(n, q, s)
        assert abs(p.classical_bits - d.classical_bits) <= 2.0, (n, p, d)
    # noiseless flag propagates to the dual too
    nl = estimate_dual_lwe(1024, 32, 2.22e-16)
    assert nl.noiseless_discretized


def test_v2_boolean_set_clears_128_gate_bits():
    """SECURITY_128_BIT_V2 (VERDICT r4 #4): the estimator-pinned 32-bit
    boolean set must clear 128 gate bits on BOTH levels, under primal
    AND the dual cross-check, with >= 2 bits of margin; the reference-
    parity 128bit set stays bit-identical to params.zig:350-378 (its
    documented 126.4-bit lv1 shortfall is the reason V2 exists)."""
    from zig_tfhe_jax.utils.security import estimate_dual_lwe

    v2 = P.SECURITY_128_BIT_V2
    assert v2.tlwe_lv0.n == P.SECURITY_128_BIT.tlwe_lv0.n
    assert v2.tlwe_lv0.alpha == P.SECURITY_128_BIT.tlwe_lv0.alpha
    assert v2.N == P.SECURITY_128_BIT.N and v2.torus_bits == 32
    est = estimate_params(v2)
    assert est.lv0.gate_bits >= 130.0, est.lv0
    assert est.lv1.gate_bits >= 130.0, est.lv1
    for n, s in ((v2.tlwe_lv0.n, v2.tlwe_lv0.alpha),
                 (v2.n1, v2.tlwe_lv1.alpha)):
        assert estimate_dual_lwe(n, 32, s).gate_bits >= 130.0
    # the parity set is untouched
    assert P.SECURITY_128_BIT.tlwe_lv1.alpha == 2.0e-8
