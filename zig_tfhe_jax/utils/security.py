"""In-tree LWE concrete-security estimator (core-SVP primal-uSVP model).

Why this exists: the N=2048 / 64-bit-torus candidate set
(``params.DRAFT_SECURITY_128_BIT_T64``, docs/TORUS64.md §6) shipped with
its security claim *deferred* because this environment has no network
egress to run the public lattice estimator.  This module implements the
standard closed-form estimate in-tree so every parameter set — the 11
reference sets (params.zig:70-378 claim 80/110/128-bit without showing
work) and the draft 64-bit set — carries a reproducible number.

Model (the "2016 estimate" used by the Homomorphic Encryption Security
Standard and the usvp model of the Albrecht–Player–Scott estimator):

* Primal uSVP attack via BKZ-beta on the Bai–Galbraith embedding of m
  LWE samples: dimension d = n + m + 1, volume q^m * nu^n with the
  secret columns rescaled by nu = sigma / sigma_s (binary secret:
  sigma_s = 1/2).  The attack succeeds when the projected shortest
  vector is found:

      sigma * sqrt(beta)  <=  delta(beta)^(2*beta - d - 1) * Vol^(1/d)

  with the BKZ root-Hermite factor
  delta(beta) = ((beta / (2*pi*e)) * (pi*beta)^(1/beta))^(1 / (2*(beta-1))).

* Cost, three standard models:
  - core-SVP classical 2^(0.292*beta) and quantum 2^(0.265*beta)
    (Becker–Ducas–Gama–Laarhoven sieve exponents) — the conservative
    lower bounds;
  - ``gate_bits`` = 0.292*beta + 16.4 + log2(8*d): the sieve *gate
    count* (the 2^(0.292 beta + 16.4) BDGL gate fit, plus the ~8d sieve
    calls of a BKZ tour).  This is the accounting public "128-bit"
    claims are calibrated against — the lattice-estimator's default gate
    model reproduces the tfhe-rs Q=2^64 corpus claims with this formula
    (e.g. k=1/N=2048/glwe_std 2^-51.5 -> beta ~338 -> ~130 gate bits),
    while its core-SVP number is ~99.  Calibration anchor checked in
    tests: Kyber512 -> beta ~400 (NIST round-3 analysis: 403).

Scope and honesty: the headline is the *primal-uSVP* estimate;
``estimate_dual_lwe`` is the classic distinguishing-dual cross-check,
which lands within 1 bit of primal on every in-tree shape (asserted in
tests/test_security.py — e.g. 128bit lv1: primal 96.1 / dual 95.8).
Refined duals (MATZOV-style FFT + modulus switching) and hybrid
(combinatorial + lattice) attacks on very sparse secrets are NOT
modeled; treat the output as the standard headline number, not a
replacement for a full estimator pass before production deployment.
When this package states a security level it names the model; "128-bit"
parameter targets use ``gate_bits`` >= 128 (ecosystem practice), with
the core-SVP number published alongside (docs/SECURITY.md).

Reference anchor: the reference hard-codes its claims in set names/docs
(params.zig:70-378); it contains no estimator.
"""

from __future__ import annotations

import dataclasses
import math

from zig_tfhe_jax.params import SecurityParams

_LOG2E = math.log2(math.e)


def log2_delta(beta: float) -> float:
    """log2 of the BKZ-beta root-Hermite factor (Chen thesis model).

    delta = ((beta / (2 pi e)) * (pi beta)^(1/beta))^(1 / (2 (beta-1))),
    valid for beta >= 50 (below that lattice reduction is essentially
    free and the estimate is meaningless — callers clamp).
    """
    lg = (math.log2(beta / (2 * math.pi * math.e))
          + math.log2(math.pi * beta) / beta)
    return lg / (2 * (beta - 1))


@dataclasses.dataclass(frozen=True)
class LweEstimate:
    """Result of a primal-uSVP estimate for one LWE instance."""

    n: int
    q_bits: int
    sigma_rel: float           # noise stddev as a fraction of q
    beta: int                  # minimal successful BKZ block size
    m: int                     # optimal sample count
    d: int                     # embedding dimension n + m + 1
    classical_bits: float      # 0.292 * beta           (core-SVP)
    quantum_bits: float        # 0.265 * beta           (core-SVP)
    gate_bits: float           # 0.292 * beta + 16.4 + log2(8 d)  (gates)
    noiseless_discretized: bool = False
    # True when sigma * 2^q_bits < 0.5: the rounded-gaussian noise the
    # scheme actually adds (utils/rng.py, mirroring utils.zig:85-92) is
    # the ZERO integer almost surely, so the discretized instance is a
    # noiseless linear system solvable by Gaussian elimination mod 2^q —
    # no lattice reduction needed, security is 0 regardless of beta.
    # The reference's Uint2-8 sets hit this: their lv1 alphas are f64
    # machine-epsilon-scale (params.zig:126-347), which on a u32 torus is
    # ~2^-6 of one ulp.  See docs/SECURITY.md.

    def __str__(self):
        return (f"LWE(n={self.n}, q=2^{self.q_bits}, "
                f"sigma=2^{math.log2(self.sigma_rel):.1f}) -> "
                f"beta={self.beta} (m={self.m}): "
                f"{self.classical_bits:.1f}-bit classical / "
                f"{self.quantum_bits:.1f}-bit quantum core-SVP")


def _usvp_succeeds(beta: int, n: int, m: int, lg_sigma_abs: float,
                   q_bits: float, lg_nu: float) -> bool:
    """2016-estimate success condition, all in log2 domain."""
    d = n + m + 1
    lg_vol = m * q_bits + n * lg_nu
    lhs = lg_sigma_abs + 0.5 * math.log2(beta)
    rhs = (2 * beta - d - 1) * log2_delta(beta) + lg_vol / d
    return lhs <= rhs


def _min_beta_for_m(n: int, m: int, lg_sigma_abs: float, q_bits: float,
                    lg_nu: float, beta_max: int) -> int | None:
    """Smallest successful beta for fixed m (binary search; the success
    predicate is monotone in beta for beta >= 50 in this regime)."""
    lo, hi = 50, beta_max
    if not _usvp_succeeds(hi, n, m, lg_sigma_abs, q_bits, lg_nu):
        return None
    while lo < hi:
        mid = (lo + hi) // 2
        if _usvp_succeeds(mid, n, m, lg_sigma_abs, q_bits, lg_nu):
            hi = mid
        else:
            lo = mid + 1
    return lo


def estimate_lwe(n: int, q_bits: int, sigma_rel: float,
                 secret_std: float = 0.5, beta_max: int = 2000) -> LweEstimate:
    """Primal-uSVP estimate for LWE(n, q=2^q_bits, sigma = sigma_rel * q).

    secret_std: stddev of a secret coordinate — 0.5 for the uniform
    binary keys used throughout (tlwe.zig/key.zig and this framework).
    sigma_rel=0 (the insecure test sets) returns a zero-security marker.
    Optimizes the sample count m over [n/2, 3n] (coarse-to-fine scan —
    the optimum is flat to +-1 beta over wide m ranges).
    """
    if sigma_rel <= 0 or n < 16:
        return LweEstimate(n, q_bits, max(sigma_rel, 0.0), 0, 0, 0,
                           0.0, 0.0, 0.0)
    lg_sigma_abs = math.log2(sigma_rel) + q_bits
    if lg_sigma_abs < -1.0:      # sigma_abs < 0.5: rounds to zero noise
        return LweEstimate(n, q_bits, sigma_rel, 0, 0, 0, 0.0, 0.0, 0.0,
                           noiseless_discretized=True)
    # Bai-Galbraith rescale: secret columns weighted to error size
    # (never below 1 — shrinking the lattice can only help the attacker).
    lg_nu = max(0.0, lg_sigma_abs - math.log2(secret_std))

    def scan(ms):
        best = None
        for m in ms:
            b = _min_beta_for_m(n, m, lg_sigma_abs, q_bits, lg_nu, beta_max)
            if b is not None and (best is None or b < best[0]):
                best = (b, m)
        return best

    best = scan(range(max(64, n // 2), 3 * n + 1, max(1, n // 16)))
    if best is None:
        # even beta_max fails everywhere -> report the cap
        d = 2 * n + 1
        return LweEstimate(n, q_bits, sigma_rel, beta_max, n, d,
                           0.292 * beta_max, 0.265 * beta_max,
                           0.292 * beta_max + 16.4 + math.log2(8 * d))
    step = max(1, n // 16)
    refined = scan(range(max(64, best[1] - step), best[1] + step + 1))
    beta, m = refined if refined is not None else best
    d = n + m + 1
    return LweEstimate(
        n=n, q_bits=q_bits, sigma_rel=sigma_rel, beta=beta, m=m, d=d,
        classical_bits=0.292 * beta,
        quantum_bits=0.265 * beta,
        gate_bits=0.292 * beta + 16.4 + math.log2(8 * d),
    )


def estimate_dual_lwe(n: int, q_bits: int, sigma_rel: float,
                      secret_std: float = 0.5,
                      beta_max: int = 2000) -> LweEstimate:
    """Dual-attack core-SVP cross-check (NOT the headline number).

    Classic distinguishing dual on the scaled lattice
    {(w, v) : A^T w = c v (mod q)} with the Bai–Galbraith balance
    c = sigma/sigma_s: dim d = m + n, vol (q/c)^n, shortest output
    length l = delta(beta)^(d-1) * vol^(1/d), per-vector advantage
    eps = exp(-2 pi^2 (l * sigma_abs / q)^2), amortized over the
    ~2^(0.2075 beta) vectors one sieve call yields:

        cost_bits = 0.292 beta + max(0, 2 log2(1/eps) - 0.2075 beta)

    This is the simple estimator-style dual (no FFT/modulus-switching
    refinements a la MATZOV, which shave a few bits); its role here is
    the documented sanity check that dual lands within a few bits of
    primal on these shapes (tests/test_security.py asserts it).
    """
    if sigma_rel <= 0 or n < 16:
        return LweEstimate(n, q_bits, max(sigma_rel, 0.0), 0, 0, 0,
                           0.0, 0.0, 0.0)
    lg_sigma_abs = math.log2(sigma_rel) + q_bits
    if lg_sigma_abs < -1.0:
        return LweEstimate(n, q_bits, sigma_rel, 0, 0, 0, 0.0, 0.0, 0.0,
                           noiseless_discretized=True)
    lg_c = max(0.0, lg_sigma_abs - math.log2(secret_std))

    def cost_bits(beta, m):
        d = m + n
        lg_vol = n * (q_bits - lg_c)
        lg_l = (d - 1) * log2_delta(beta) + lg_vol / d
        lg_tau = lg_l + lg_sigma_abs - q_bits        # l * sigma / q
        if lg_tau > 3.0:                              # eps ~ 0: hopeless
            return None
        # log2(1/eps) = 2 pi^2 tau^2 * log2(e)
        lg_inv_eps = (2 * math.pi ** 2) * (2.0 ** (2 * lg_tau)) * _LOG2E
        return 0.292 * beta + max(0.0, 2 * lg_inv_eps - 0.2075 * beta)

    best = None   # (bits, beta, m)
    for m in range(max(64, n // 2), 3 * n + 1, max(1, n // 16)):
        lo, hi = 50, beta_max
        # cost is unimodal-ish in beta; ternary search on integers
        while hi - lo > 2:
            m1 = lo + (hi - lo) // 3
            m2 = hi - (hi - lo) // 3
            c1, c2 = cost_bits(m1, m), cost_bits(m2, m)
            if c1 is None:
                lo = m1 + 1
                continue
            if c2 is None or c1 <= c2:
                hi = m2 - 1
            else:
                lo = m1 + 1
        for beta in range(lo, hi + 1):
            c = cost_bits(beta, m)
            if c is not None and (best is None or c < best[0]):
                best = (c, beta, m)
    if best is None:
        d = 2 * n
        return LweEstimate(n, q_bits, sigma_rel, beta_max, n, d,
                           0.292 * beta_max, 0.265 * beta_max,
                           0.292 * beta_max + 16.4 + math.log2(8 * d))
    bits, beta, m = best
    d = m + n
    return LweEstimate(
        n=n, q_bits=q_bits, sigma_rel=sigma_rel, beta=beta, m=m, d=d,
        classical_bits=bits,
        quantum_bits=bits - 0.027 * beta,     # 0.265 vs 0.292 sieve term
        gate_bits=bits + 16.4 + math.log2(8 * d),
    )


@dataclasses.dataclass(frozen=True)
class ParamsEstimate:
    """Security of a full parameter set = min over its two LWE instances
    (lv0 mask and the RLWE lv1 ring, treated as LWE of dimension k*N —
    the standard reduction direction for estimates)."""

    name: str
    lv0: LweEstimate
    lv1: LweEstimate
    claimed_bits: int

    @property
    def classical_bits(self) -> float:
        return min(self.lv0.classical_bits, self.lv1.classical_bits)

    @property
    def limiting_level(self) -> str:
        return "lv0" if self.lv0.classical_bits <= self.lv1.classical_bits \
            else "lv1"

    def __str__(self):
        return (f"{self.name}: {self.classical_bits:.1f}-bit classical "
                f"core-SVP (limited by {self.limiting_level}; "
                f"claimed {self.claimed_bits})\n  lv0 {self.lv0}\n"
                f"  lv1 {self.lv1}")


def estimate_params(params: SecurityParams) -> ParamsEstimate:
    """Estimate both LWE instances of a parameter set.

    Both levels live on the same discretized torus (q = 2^torus_bits);
    alphas in the set are already torus-relative (params.zig:36-43
    semantics, kept by params.py).
    """
    w = params.torus_bits
    return ParamsEstimate(
        name=params.name,
        lv0=estimate_lwe(params.n0, w, params.tlwe_lv0.alpha),
        lv1=estimate_lwe(params.trlwe_lv1.n, w, params.trlwe_lv1.alpha),
        claimed_bits=params.security_bits,
    )
