"""Matmul-form negacyclic NTT engine — the batched external product.

Why this exists.  The Toeplitz engine (ops/poly.py, ops/blind_rotate.py)
is exact but must *construct* a [2L*N, 2N] int8 circulant operand from the
streamed bootstrapping-key row on every blind-rotate step; those
byte-granular roll/concat doublings are data movement, not arithmetic.
This engine replaces the per-step operand construction with
matrix multiplication against STATIC [N, N] matrices:

  * negacyclic convolution is diagonalized by the psi-twisted NTT over
    primes p ≡ 1 (mod 2N):  fwd[j,k] = psi^{j(2k+1)},
    inv[k,n] = N^{-1} psi^{-n(2k+1)}  (both fixed matrices — the twist is
    folded into the matmul for free);
  * the bootstrapping key is stored pre-transformed (NTT residue form),
    so a blind-rotate step is:  decompose -> forward NTT (int8-limb
    matmuls) -> pointwise modmul vs the key residues (elementwise) -> X^t
    rotation as a *diagonal* multiply (one row-gather from a psi-power
    table — no coefficient-domain gather at all) -> inverse NTT ->
    CRT-combine to int32 mod 2^32;
  * everything is EXACT: int32 intermediates never exceed 2^31 (bounds
    in comments), modular reduction is float-assisted Barrett whose f32
    error (< 2^-6) is provably below the rounding margin, and the final
    CRT lift is exact because the truw convolution magnitude is < P/4.

Replaces the role of the reference's Klemsa f64 FFT (fft.zig:79-670) and
frequency-domain MACs (trgsw.zig:157-189) with integer-exact semantics.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax.params import SecurityParams
from zig_tfhe_jax.utils.torus import i32_to_i8_limbs


# ---------------------------------------------------------------------------
# Prime / root machinery (host-side, exact Python ints)
# ---------------------------------------------------------------------------


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for q in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % q == 0:
            return n == q
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def ntt_primes(two_n: int, max_p: int = 63000) -> tuple:
    """All primes p ≡ 1 (mod 2N) with p <= max_p, ascending.

    max_p = 63000 guarantees the residue int8 limb split stays in range:
    barrett outputs satisfy |r| <= p/2 + 384 (see barrett_reduce), and the
    limb split needs |r| <= 32639, i.e. p/2 <= 32255 -> p <= 64510; 63000
    leaves margin.  (It also keeps centered residues within int16 and
    pointwise products within int32.)
    """
    return tuple(p for p in range(two_n + 1, max_p + 1, two_n) if _is_prime(p))


def _primitive_2n_root(p: int, two_n: int) -> int:
    """psi with psi^(2N) = 1 and psi^N = -1 mod p."""
    for g in range(2, p):
        psi = pow(g, (p - 1) // two_n, p)
        if pow(psi, two_n // 2, p) == p - 1:
            return psi
    raise ValueError(f"no primitive {two_n}-th root mod {p}")


def _center(a: np.ndarray, p: int) -> np.ndarray:
    """Centered representative in [-p//2, p//2]."""
    return ((a % p) + p // 2) % p - p // 2


def _i8_split(a: np.ndarray):
    """int array (|a| <= 32639) -> (lo, hi) int8 with a == lo + 256*hi
    (at |a| = 32640 the hi limb would be 128, overflowing int8 — the
    assert below fails fast)."""
    lo = ((a + 128) % 256 - 128).astype(np.int64)
    hi = (a - lo) >> 8
    assert np.all(np.abs(hi) <= 127), np.abs(hi).max()
    return lo.astype(np.int8), hi.astype(np.int8)


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NTTPlan:
    """Static per-(N, bound) transform data.

    All arrays are numpy (host); they enter jit graphs as constants.
      fwd_lo/hi[i]: int8 [N, N]   psi-twisted forward NTT matrix limbs
      inv_lo/hi[i]: int8 [N, N]   inverse (incl. N^-1 and untwist)
      rot[i]:       int16 [2N, N] centered psi^{t(2k+1)} rotation diagonals
      rot_merged:   int16 [2N, n_primes*N] — the per-prime tables
                    concatenated on the lane axis, so the rotate stages
                    gather rotation rows for ALL primes in one take
      crt_e[i]:     int32          e_p mod 2^32 (CRT idempotent)
      crt_theta[i]: float32        e_p / P
      p_mod:        int32          P mod 2^32
    """

    N: int
    primes: tuple
    fwd_lo: tuple
    fwd_hi: tuple
    inv_lo: tuple
    inv_hi: tuple
    inv_cat_lo: tuple   # int8 [2N, N]: limb-lo of [Minv ; 256*Minv mod p]
    inv_cat_hi: tuple   # int8 [2N, N]: limb-hi of the same stack
    inv_ilv_lo: tuple   # int8 [2N, N]: inv_cat with rows interleaved
    inv_ilv_hi: tuple   #   (2k <- k, 2k+1 <- N+k) for the i16-bitcast operand
    inv_pk_lo: tuple    # int8 [2N, N]: rows ordered for the pack32 operand
    inv_pk_hi: tuple    #   (4q+r <- {q, N+q, N/2+q, 3N/2+q}[r])
    inv_corr: tuple     # int32 [N]: centered 128*colsum(Minv + 256Minv) mod p
    rot: tuple
    rot_merged: np.ndarray
    rot_merged_half: np.ndarray  # int16 [2N, P*(N/2)]: lanes k < N/2 only;
                                 # rot[t, k+N/2] == (-1)^t * rot[t, k]
                                 # (psi^N = -1), so the upper half is a
                                 # per-row sign flip — half the gather bytes
    crt_e: tuple
    crt_theta: tuple
    p_mod: int
    # 64-bit-torus CRT constants (e_p / P mod 2^64 as int64 bit patterns);
    # same lift, wider wrap — used when the carrier width is 64
    crt_e64: tuple = ()
    p_mod64: int = 0

    def __hash__(self):
        return hash((self.N, self.primes))

    def __eq__(self, other):
        if not isinstance(other, NTTPlan):
            return NotImplemented
        return (self.N, self.primes) == (other.N, other.primes)

    @property
    def n_primes(self) -> int:
        return len(self.primes)

    def row_group(self, p: int) -> int:
        """Rows safely accumulated unreduced: group * (0.55p * p/2) < 2^31.

        0.55p is the safe envelope for barrett outputs (|r| <= p/2 + 384,
        and 0.55p >= p/2 + 384 for every p >= 7680 — all plan primes
        qualify since p ≡ 1 mod 2N with the largest-first selection)."""
        return max(1, (2**31 - 1) // (math.ceil(0.55 * p) * (p // 2) + 1))


@functools.lru_cache(maxsize=None)
def make_plan(N: int, bound_bits: int) -> NTTPlan:
    """Plan whose prime product P > 2^(bound_bits + 2).

    bound_bits must satisfy |true convolution| < 2^bound_bits; the +2 keeps
    the CRT f32 rounding margin >= 1/4 (see crt_combine).
    """
    two_n = 2 * N
    # Largest primes first: fewest primes for the required product (every
    # prime costs matmul passes).  ntt_primes caps p at 63000 so the
    # runtime int8 hi-limb split of barrett outputs cannot overflow (see
    # its docstring) — that cap, not int16 storage, is binding.
    avail = ntt_primes(two_n)[::-1]
    primes, logp = [], 0.0
    for p in avail:
        primes.append(p)
        logp += math.log2(p)
        if logp > bound_bits + 2:
            break
    else:
        raise ValueError(
            f"not enough NTT primes for N={N}, bound 2^{bound_bits}")
    primes.sort()
    # row_group / rotate_combine2 bounds use the 0.55p barrett envelope,
    # valid only for p >= 7680 (NOISE.md §3); enforce rather than rely on
    # largest-first selection happening to pick large primes
    if primes[0] < 7680:
        raise ValueError(
            f"plan prime {primes[0]} < 7680 breaks the 0.55p barrett "
            f"envelope (N={N}, bound 2^{bound_bits})")

    fwd_lo, fwd_hi, inv_lo, inv_hi, rot = [], [], [], [], []
    inv_cat_lo, inv_cat_hi = [], []
    inv_ilv_lo, inv_ilv_hi = [], []
    inv_pk_lo, inv_pk_hi, inv_corr = [], [], []
    crt_e, crt_e64, crt_theta = [], [], []
    P = 1
    for p in primes:
        P *= p
    for p in primes:
        psi = _primitive_2n_root(p, two_n)
        # power tables via cumulative products (exact Python ints)
        psi_pow = np.ones(two_n, dtype=object)
        for i in range(1, two_n):
            psi_pow[i] = psi_pow[i - 1] * psi % p
        j = np.arange(N)
        k = np.arange(N)
        fwd = psi_pow[(j[:, None] * (2 * k[None, :] + 1)) % two_n].astype(np.int64)
        n_inv = pow(N, p - 2, p)
        # inv[k, n] = N^-1 * psi^{-n(2k+1)}  (rows k frequency, cols n time)
        inv = (psi_pow[(-(j[None, :] * (2 * k[:, None] + 1)))
                       % two_n].astype(np.int64) * n_inv) % p
        t = np.arange(two_n)
        rot_t = psi_pow[(t[:, None] * (2 * k[None, :] + 1)) % two_n].astype(np.int64)

        flo, fhi = _i8_split(_center(fwd, p))
        ilo, ihi = _i8_split(_center(inv, p))
        fwd_lo.append(flo)
        fwd_hi.append(fhi)
        inv_lo.append(ilo)
        inv_hi.append(ihi)
        # concatenated-contraction form: residue v = lo + 256*hi multiplies
        # [Minv ; (256*Minv) mod p] so both limbs contract in one matmul
        inv_cat = np.concatenate([_center(inv, p), _center(inv * 256, p)], 0)
        clo, chi = _i8_split(inv_cat)
        inv_cat_lo.append(clo)
        inv_cat_hi.append(chi)
        # byte-bitcast operand variants (see ntt_inverse_to_crt): residues
        # are canonicalized to [0,p), their little-endian bytes XOR 0x80
        # become signed (byte-128) operands, and the missing 128*colsum
        # term is restored by inv_corr after the matmul.
        #   i16cast row order: (lo_0, hi_0, lo_1, hi_1, ...)
        perm = np.empty(2 * N, np.int64)
        perm[0::2] = np.arange(N)
        perm[1::2] = np.arange(N) + N
        inv_ilv_lo.append(np.ascontiguousarray(clo[perm]))
        inv_ilv_hi.append(np.ascontiguousarray(chi[perm]))
        #   pack32 row order: bytes of (v_q | v_{q+N/2} << 16), q < N/2:
        #   (lo_q, hi_q, lo_{q+N/2}, hi_{q+N/2})
        perm4 = np.empty(2 * N, np.int64)
        q = np.arange(N // 2)
        perm4[0::4] = q
        perm4[1::4] = N + q
        perm4[2::4] = N // 2 + q
        perm4[3::4] = N + N // 2 + q
        inv_pk_lo.append(np.ascontiguousarray(clo[perm4]))
        inv_pk_hi.append(np.ascontiguousarray(chi[perm4]))
        corr = _center((128 * inv_cat.sum(axis=0)) % p, p).astype(np.int32)
        inv_corr.append(corr)
        rot.append(_center(rot_t, p).astype(np.int16))

        pp = P // p
        e = pp * pow(pp, p - 2, p)  # e ≡ 1 mod p, ≡ 0 mod others
        crt_e.append(np.int32(np.uint32(e % (1 << 32)).view(np.int32)))
        crt_e64.append(np.int64(np.uint64(e % (1 << 64)).view(np.int64)))
        crt_theta.append(np.float32(e / P))

    return NTTPlan(
        N=N, primes=tuple(primes),
        fwd_lo=tuple(fwd_lo), fwd_hi=tuple(fwd_hi),
        inv_lo=tuple(inv_lo), inv_hi=tuple(inv_hi),
        inv_cat_lo=tuple(inv_cat_lo), inv_cat_hi=tuple(inv_cat_hi),
        inv_ilv_lo=tuple(inv_ilv_lo), inv_ilv_hi=tuple(inv_ilv_hi),
        inv_pk_lo=tuple(inv_pk_lo), inv_pk_hi=tuple(inv_pk_hi),
        inv_corr=tuple(inv_corr),
        rot=tuple(rot),
        rot_merged=np.concatenate(rot, axis=1),
        rot_merged_half=np.concatenate([r[:, : N // 2] for r in rot], axis=1),
        crt_e=tuple(crt_e), crt_theta=tuple(crt_theta),
        p_mod=int(np.uint32(P % (1 << 32)).view(np.int32)),
        crt_e64=tuple(crt_e64),
        p_mod64=int(np.uint64(P % (1 << 64)).view(np.int64)),
    )


def plan_for_params(params: SecurityParams, drop_bits: int = 0,
                    group: int = 1, levels: int | None = None,
                    bgbit: int | None = None,
                    pseudorandom_key: bool = False) -> NTTPlan:
    """Plan covering one external product + NTT-domain rotation.

    group=1: true integer magnitude <= 2 (X^t - 1) * 2L rows * N terms
    * Bg/2 digit * 2^(31-drop) key.  group=g (multi-bit step) combines
    sum over nonempty subsets S of {1..g} of prod_{i in S}(X^ai - 1) u_S:
    each |S|=k term contributes 2^k, so the multiplier is
    sum_k C(g,k) 2^k = 3^g - 1 (2, 8, 26, 80 for g = 1..4).
    The CRT prime product must exceed 4x the bound.  levels < L
    (approximate gadget) shrinks the row count, tightening the bound.

    bgbit selects an ENGINE gadget base (default_engine_gadget).  When it
    differs from the parameter set's base, the bound switches from
    worst-case to a Hoeffding tail bound (docs/NOISE.md §2b): the
    convolution is a sum of T = (3^g-1)*(la+lb)*N products of digits
    (|d| <= Bg_e/2) against the BSK's uniformly pseudorandom residues
    (|K| <= 2^(31-drop)), so P(|conv| >= tau) <= 2 exp(-tau^2 / (2 S))
    with S = T * (Bg_e/2)^2 * 2^(2(31-drop)); tau is set for failure
    < 2^-128 PER COEFFICIENT (tau = sqrt(2 ln(2^129) S) ~ 13.4 sqrt(S)).
    This keeps the Bg_e = 2^8 gadget on the 3-prime plan where the
    worst-case bound would force a 4th prime — the entire point of the
    engine gadget.  The pseudorandomness argument holds for EVERY
    freshly generated BSK (the residues are NTTs of encryptions the
    engine itself produced), not just engine-base ones, so the blind
    rotation/keygen paths pass pseudorandom_key=True and get the
    Hoeffding bound at the parameter base too (group=3 at bg6/(3,2)
    rides the 3-prime plan this way).  ZTFHE_WORSTCASE_BOUND=1 forces
    the worst-case bound (paranoia/debug; plans then differ from
    generated keys' plans, so set it for keygen too).  Paths with
    caller-controlled adversarial inputs (the standalone external
    products taking arbitrary TRGSW ciphertexts) keep the worst-case
    bound — plans there are unchanged.
    """
    e = params.bgbit if bgbit is None else bgbit
    la, lb = norm_levels(params, levels, bgbit=e)
    digit_bound = 1 << (e - 1)
    mult = 3 ** group - 1
    key_bound = 1 << (params.torus_bits - 1 - drop_bits)
    bound = mult * (la + lb) * params.N * digit_bound * key_bound
    bits = bound.bit_length()
    if (pseudorandom_key or e != params.bgbit) and os.environ.get(
            "ZTFHE_WORSTCASE_BOUND", "") not in ("1", "true"):
        # Hoeffding: tau = sqrt(2 * ln(2^129) * T) * d_max * K_max
        tau = (math.sqrt(2 * math.log(2) * 129
                         * mult * (la + lb) * params.N)
               * digit_bound * key_bound)
        bits = min(bits, math.ceil(math.log2(tau)))
    # Split-ring sets (N > 1024) transform on the N/2 plan: each output
    # coefficient of a half-product pair still sums params.N true products
    # (two N/2 negacyclic convolutions — ops/split_ring.py), so the bound
    # above is unchanged; only the transform size halves.
    return make_plan(params.N // 2 if params.split_ring else params.N, bits)


def norm_levels(params: SecurityParams, levels,
                bgbit: int | None = None) -> tuple[int, int]:
    """Normalize a decomposition-level spec to (a_levels, b_levels).

    int -> symmetric; None -> exact (L, L).  Asymmetric levels exist
    because the two components' truncation errors are NOT symmetric in
    the phase: the a-component remainder rho_a enters as s * rho_a (a
    negacyclic convolution with the N-coefficient binary lv1 key — an
    ~sqrt(N/2) = 22x amplitude amplification), while rho_b enters bare.
    (a=L exact, b approximate) therefore buys almost the full row saving
    at a tiny noise cost (docs/NOISE.md §6, measured).

    With an ENGINE gadget base bgbit != params.bgbit the level ceiling is
    floor(torus_bits/bgbit) (the engine gadget has no reference-L tie).
    """
    l_max = (params.L if bgbit in (None, params.bgbit)
             else params.torus_bits // bgbit)
    if levels is None:
        return l_max, l_max
    if isinstance(levels, tuple):
        la, lb = levels
    else:
        la = lb = int(levels)
    assert 1 <= la <= l_max and 1 <= lb <= l_max, (la, lb, l_max)
    return la, lb


def default_group(params: SecurityParams) -> int:
    """Default multi-bit blind-rotation group for CloudKey.generate.

    Boolean sets: group 3 (234 steps at bg7/(2,2)/drop5; its speed
    against group 2 is not yet measured on the GPU), whose noise margin
    is BETTER
    than group 2's: sigma_out 2^25.77 / margin 6.59 vs 2^25.85 / 6.22
    (tools/noise_probe).
    Uint sets: group 2 — their parameter-base gadgets (Bg up to 2^22)
    already sit on wide multi-prime plans where the (3^g - 1) pointwise
    multiplier grows faster than the step count shrinks.
    """
    if params.split_ring:
        # Split engine (ops/split_ring.py): group 2 halves the n0-step
        # scan via the pair-representation subset combiner
        # (rotate_combine_multi_split).  Same BMMP16 subset-product key
        # assumption note as below; group=1 restores the per-bit BSK.
        return 2
    if params.bgbit == 6 and params.L == 3 and params.N >= 1024:
        return 3
    return 2


def default_engine_gadget(params: SecurityParams,
                          group: int = 2) -> tuple[int, tuple[int, int]]:
    """(bgbit_e, (la, lb)) — the gadget the NTT blind rotation actually runs.

    The gadget inside the bootstrap's external products is an
    IMPLEMENTATION DETAIL: the BSK freshly encrypts the lv0 key bits with
    whatever gadget the engine picks; reference parity is at the decrypt
    level (SURVEY.md §4), and only the noise budget constrains the choice.
    The reference's boolean sets use (bgbit=6, L=3) = 18-bit precision
    asymmetric-truncated to (3, 2) rows = 5 rows.  The engine default for
    those sets is Bg_e = 2^8 with (2, 2) levels: 16-bit precision on BOTH
    components in 4 rows — fewer rows through forward NTT + pointwise at
    a STRICTLY SMALLER a-truncation (rho_a +-2^15 vs the exact path's 0
    but far under budget, rho_b +-2^15 vs +-2^19; docs/NOISE.md §6), with
    digits still one int8 limb.  Uint sets keep the parameter gadget
    (their Bg is already tuned to the message precision).

    The base is GROUP-aware: at group >= 3 the (3^g - 1) Hoeffding plan
    bound no longer fits Bg_e = 2^8 on the 3-prime plan at a safe drop
    (bg8 needs drop >= 6, whose rounding amplitude 2^13 is 8.7x the
    validated budget — past the measured cliff), so multi-bit groups >= 3
    run Bg_e = 2^7 with (2, 2) levels: 14-bit precision, 4 rows, drop 5
    (amplitude 2^11, 0.54x the shipped group-2 variance; docs/NOISE.md
    §6).
    """
    if params.bgbit == 6 and params.L == 3 and params.N >= 1024:
        return (7 if group >= 3 else 8), (2, 2)
    return params.bgbit, default_decomp_levels(params)


def engine_digit_limbs(bgbit: int) -> int:
    """int8 limbs per engine-gadget digit (digits in [-2^(b-1), 2^(b-1)),
    so b <= 8 fits one signed byte)."""
    return -(-bgbit // 8)


def default_decomp_levels(params: SecurityParams) -> tuple[int, int]:
    """Decomposition levels for the NTT blind rotation (approximate gadget).

    Returns (a_levels, b_levels).  The two components' truncation errors
    are NOT symmetric in the phase: the a-remainder rho_a enters as
    s * rho_a — a negacyclic convolution with the N-coefficient binary
    lv1 key, an ~sqrt(N/2) = 22x amplitude amplification — while rho_b
    enters bare.  Truncating `a` below the full L measurably fails
    (symmetric levels=2 at 128-bit: ~1e-3 gate errors on-device, a
    ~3.5-sigma tail); truncating `b` to 12 bits of precision adds only
    sigma ~ 2^22.6 against the 2^28 margin (docs/NOISE.md §6).  The
    boolean 128-bit set (L=3, bgbit=6) therefore gets (3, 2) — 5 rows
    instead of 6 through forward NTT + pointwise; every uint set already
    satisfies the b-precision floor at its full L and is unchanged.
    """
    return (params.L, min(params.L, max(1, -(-12 // params.bgbit))))


def default_drop_bits(params: SecurityParams, group: int = 1,
                      bgbit: int | None = None) -> int:
    """BSK rounding (bits) for the NTT engine.

    At N=1024 the fewest-pass plan is the THREE largest sub-2^16 primes
    (40961*59393*61441 = 2^47.09): group=1 fits at drop<=6, group=2 (bound
    x4) at drop<=7.  Noise (rounding-error variance over the whole blind
    rotation, relative to group=1/drop=8 which decrypts exactly at batch
    4096 while drop=9 fails ~0.5%): group=1/drop=6 is 1/16x, group=2/drop=7
    is 1/2x — both safely inside the cliff.  Test sets with alpha=0 stay
    exact (drop=0).
    """
    if params.N < 1024:
        return 0
    if params.split_ring:
        # 64-bit torus: drop = 32 so the whole scan body runs on int32
        # hi planes (ops/split_ring.py hi-plane scan — every per-step
        # delta is then a multiple of 2^32 and the accumulator's low
        # word is scan-invariant, so the scan body needs no int64
        # elementwise work).
        # Plan: the key bound 2^31 puts the Hoeffding tau at ~2^50
        # (group 2, bg8/(3,2)) -> a FOUR-prime plan vs five at the old
        # drop=12 (~20% fewer matmul passes).  Noise: key-rounding
        # residuals sum to sigma ~ sqrt(T)*(Bg/2)*2^31/sqrt(3) per step,
        # ~2^-15 of the torus over the 384-step t64 scan — negligible
        # against its 2^-9.4 key-switch floor; the deterministic worst
        # case stays ~2^-8 even on the alpha=0 tiny split set, inside
        # every margin (gates stay decrypt-exact, asserted in tests).
        return 32
    # The rounding error per external product scales with the digit
    # magnitude Bg/2 = 2^(bgbit-1): keep (Bg/2 * 2^drop) at the validated
    # boolean-set level (bgbit=6 -> drop 6/7).  Uint sets with large Bg
    # (e.g. uint4: bgbit=22, L=1) must keep the key exact.  Larger groups
    # amplify the drop error by (3^g - 1)*(steps = n0/g); the bases below
    # hold total drop variance at or below the group=2/drop=7 level that
    # sits 2x inside the measured cliff (docs/NOISE.md §6).  With the
    # default asymmetric (L, 2) gadget the 5-row plan bound at drop=7 is
    # 2^44.3 — still 3 primes (P = 2^47.09).  An ENGINE gadget base
    # (bgbit argument) scales the same way: Bg_e = 2^8 at group 2 gives
    # drop 5, the identical 128*2^5 = 32*2^7 rounding amplitude.
    # group=3's base 12 puts the default engine gadget bg7/(2,2) at
    # drop 5: amplitude 2^6*2^5 = 2^11, terms x2.17 vs group-2 ->
    # 0.54x the shipped group-2 drop variance, and the Hoeffding plan
    # bound (tau = 2^44.09, bits 45) stays 3-prime (docs/NOISE.md §6).
    # group=4 at bg7/(2,2) likewise needs drop 5 for the 3-prime plan
    # (tau = 2^44.9); amplitude 2^11 at 5x the group-2 term count =
    # 1.25x the shipped group-2 drop variance (a latency-tuned config —
    # 175 scan steps; the 15-subset combine costs throughput).
    base = {1: 12, 2: 13, 3: 12, 4: 12}[group]
    return max(0, base - (params.bgbit if bgbit is None else bgbit))


# ---------------------------------------------------------------------------
# Device-side modular primitives (all int32/f32, elementwise)
# ---------------------------------------------------------------------------


def barrett_reduce(v, p: int):
    """r ≡ v (mod p) with |r| <= p/2 + 3*2^-24*|v|, for any int32 v.

    Float-assisted: q = round(f32(v) * f32(1/p)).  The two f32 roundings
    (v and the product) each contribute <= 2^-24 relative error, and the
    stored 1/p a third, so |q - v/p| <= 1/2 + 3*2^-24*|v|/p and
    |r| <= p/2 + 3*2^-24*|v| — i.e. p/2 + 384 at |v| ~ 2^31 (worst
    observed 0.5205p at p=12289), NOT a fixed multiple of p.  Downstream
    bounds use the safe envelope 0.55p (valid for p >= 7680, which every
    plan prime satisfies) or the absolute form p/2 + 384.  The
    subtraction wraps safely (the true r is small).
    """
    q = jnp.round(v.astype(jnp.float32) * np.float32(1.0 / p)).astype(jnp.int32)
    return v - q * jnp.int32(p)


def _limb_pair_combine(lo, hi, p: int, N: int, in_bound: int):
    """Exact (lo_dot + 256*hi_dot) mod p with int32-safe intermediates.

    lo/hi are int32 matmul outputs of int8-limb operands against the lo/hi
    matrix limbs; |lo| <= N*in_bound*128, |hi| <= N*in_bound*hi_max.
    Fast path (single add) when 256*|hi| provably fits int32.
    """
    hi_max = p // 512 + 1
    # the reduced value is lo + (hi << 8); the guard must bound BOTH terms
    # (|lo| <= N*in_bound*128), not just the shifted hi term
    if N * in_bound * (128 + 256 * hi_max) < 2**31:
        return barrett_reduce(lo + jax.lax.shift_left(hi, jnp.int32(8)), p)
    # safe path: reduce limbs separately, then combine (<= 0.55p*257 < 2^24)
    return barrett_reduce(
        barrett_reduce(lo, p) + barrett_reduce(hi, p) * jnp.int32(256), p)


def top_limb_bound(digit_bound: int, digit_limbs: int) -> int:
    """ntt_forward's digit_bound argument is the TOP-LIMB magnitude bound;
    for multi-limb digits with |digit| <= digit_bound the top limb is only
    digit_bound / 2^(8*(limbs-1)) (+1 centered-remainder carry).  Passing
    the tight value lets _limb_pair_combine take its single-add fast path
    on the top-limb pass (one fewer barrett per prime for the large-Bg
    uint sets)."""
    if digit_limbs == 1:
        return digit_bound
    return min(128, (digit_bound >> (8 * (digit_limbs - 1))) + 1)


def ntt_forward(digits, plan: NTTPlan, digit_limbs: int = 1,
                digit_bound: int = 128):
    """Forward NTT of small signed polys.

    digits: int32/int8 [..., N] with |digits| < 2^(8*digit_limbs - 1); the
    top limb is bounded by digit_bound (used only for overflow-path
    selection).  Returns list per prime of int32 [..., N] centered residues
    (|.| <= p(1/2 + 2^-6)).

    NOTE on storage width: residues fit int16 losslessly; inter-stage
    residues stay int32 so that no narrowing convert sits between the
    matmul and its consumer.  int16 storage is not yet measured on the
    GPU.
    """
    if digit_limbs == 1:
        d8 = [digits.astype(jnp.int8)]
        bounds = [digit_bound]
    else:
        limbs = i32_to_i8_limbs(digits, digit_limbs)  # [..., N, n_dl]
        d8 = [limbs[..., i] for i in range(digit_limbs)]
        bounds = [128] * (digit_limbs - 1) + [digit_bound]
    # NOTE: a single s8@s16 whole-matrix dot is algebraically available here
    # (true products fit int32 for the boolean sets); the explicit limb
    # matmuls keep every dot s8 x s8 -> s32 (the mixed-dtype form is not
    # yet measured on the GPU).
    out = []
    for i, p in enumerate(plan.primes):
        flo = jnp.asarray(plan.fwd_lo[i])
        fhi = jnp.asarray(plan.fwd_hi[i])
        r = None
        for dl in reversed(range(digit_limbs)):
            lo = _dot_i8(d8[dl], flo)
            hi = _dot_i8(d8[dl], fhi)
            yr = _limb_pair_combine(lo, hi, p, plan.N, bounds[dl])
            r = yr if r is None else barrett_reduce(r * jnp.int32(256) + yr, p)
        out.append(r)
    return out


def _dot_i8(a_i8, b_i8):
    return jax.lax.dot_general(
        a_i8, b_i8,
        dimension_numbers=(((a_i8.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def residue_limbs(v):
    """Centered residue -> (lo, hi) int8 limb planes with v == lo + 256*hi.

    Elementwise, so it fuses into the producer of v (the rotate stage).
    Requires |v| <= 32639 (at v = 32640 the hi limb
    would be 128, overflowing int8); barrett outputs satisfy this for
    p <= 63000 (|r| <= p/2 + 384 <= 31884).
    """
    v = v.astype(jnp.int32)
    lo = ((v + 128) & 255) - 128
    hi = jax.lax.shift_right_arithmetic(v - lo, jnp.int32(8))
    return lo.astype(jnp.int8), hi.astype(jnp.int8)


def _inverse_operand_mode() -> str:
    """How the inverse matmul's int8 operand is produced from residues.

    'concat' (default): residue_limbs + a concatenate along the
    coefficient axis.
    'i16cast': canonicalize + XOR-bias + s32->s16 convert + BITCAST to
    byte pairs against interleaved matrices.
    'pack32': pure-int32 packing of residue pairs + s32->s8[4] bitcast
    (no width-changing convert at all).
    The three are not yet measured on the GPU.  All are bit-exact (tests run all modes); override with
    ZTFHE_INV=concat|i16cast|pack32.
    """
    return os.environ.get("ZTFHE_INV") or "concat"


def _canonical_mod_p(v, p: int):
    """Centered residue (|v| <= 0.55p) -> canonical [0, p) int32."""
    v = v.astype(jnp.int32)
    return v + jnp.int32(p) * (v < 0).astype(jnp.int32)


def residue_bytes_interleaved(v, p: int):
    """Residues int32 [..., N] -> int8 [..., 2N] biased byte pairs.

    Canonicalize to [0, p) (< 2^16), XOR each byte with 0x80 (== subtract
    128 per byte, carry-free), truncate to int16 and bitcast: element 2k
    is (low_byte - 128), 2k+1 is (high_byte - 128) of residue k, so
    v_k == b_{2k} + 256*b_{2k+1} + 0x8080 exactly.  The constant 0x8080
    term becomes plan.inv_corr after the matmul.  Pure elementwise int ops
    + bitcast + minor-dim merge — no concatenate, and the only width
    change is s32->s16.
    """
    w = (_canonical_mod_p(v, p) ^ jnp.int32(0x8080)).astype(jnp.int16)
    b = jax.lax.bitcast_convert_type(w, jnp.int8)     # [..., N, 2]
    return b.reshape(b.shape[:-2] + (2 * b.shape[-2],))


def residue_bytes_pack32(v, p: int):
    """Residues int32 [..., N] -> int8 [..., 2N] biased bytes, packed form.

    Packs residue pairs (q, q+N/2) into one int32 word entirely with
    int32 arithmetic (NO width-changing convert at all), then bitcasts
    the words to bytes: order (lo_q, hi_q, lo_{q+N/2}, hi_{q+N/2}),
    each byte biased by -128 (XOR 0x80).  Matches plan.inv_pk_* rows +
    inv_corr.
    """
    vc = _canonical_mod_p(v, p)
    n = vc.shape[-1]
    a = vc[..., : n // 2]
    bb = vc[..., n // 2:]
    w = (a | jax.lax.shift_left(bb, jnp.int32(16))) ^ jnp.int32(
        np.uint32(0x80808080).view(np.int32))
    b = jax.lax.bitcast_convert_type(w, jnp.int8)     # [..., N/2, 4]
    return b.reshape(b.shape[:-2] + (4 * b.shape[-2],))


def ntt_inverse_to_crt(res_list, plan: NTTPlan, width: int = 32):
    """Inverse NTT per prime + exact CRT lift to int32 mod 2^32 (or int64
    mod 2^64 with width=64).

    res_list: per prime, EITHER int16/int32 [..., N] centered residues
    (|.| <= 0.52p) OR an (lo8, hi8) limb pair from residue_limbs.
    Returns carrier [..., N] == centered-exact convolution mod 2^width,
    provided the true integer convolution magnitude is < P/4.

    The [limbs] @ [Minv ; 256*Minv mod p] concatenated contraction is one
    2N-deep matmul per output-limb matrix (the 4-matmul split form, with
    contraction N, is the 'split4' mode).  The operand layout is picked by _inverse_operand_mode().
    """
    mode = _inverse_operand_mode()
    xs = []
    for i, p in enumerate(plan.primes):
        item = res_list[i]
        corr = None
        if isinstance(item, tuple):
            lo8, hi8 = item
            limbs = jnp.concatenate([lo8, hi8], axis=-1)        # [.., 2N]
            m_lo, m_hi = plan.inv_cat_lo[i], plan.inv_cat_hi[i]
        elif mode == "i16cast":
            limbs = residue_bytes_interleaved(item, p)          # [.., 2N]
            m_lo, m_hi = plan.inv_ilv_lo[i], plan.inv_ilv_hi[i]
            corr = plan.inv_corr[i]
        elif mode == "pack32":
            limbs = residue_bytes_pack32(item, p)               # [.., 2N]
            m_lo, m_hi = plan.inv_pk_lo[i], plan.inv_pk_hi[i]
            corr = plan.inv_corr[i]
        elif mode == "split4":
            # 4-dot form: lo/hi limbs as SEPARATE [., N] contractions —
            # two s8 converts but NO lane-axis concatenate
            lo8, hi8 = residue_limbs(item)
            ilo = jnp.asarray(plan.inv_lo[i])
            ihi = jnp.asarray(plan.inv_hi[i])
            i2lo = jnp.asarray(plan.inv_cat_lo[i][plan.N:])   # (256*Minv)_lo
            i2hi = jnp.asarray(plan.inv_cat_hi[i][plan.N:])
            z_lo = _dot_i8(lo8, ilo) + _dot_i8(hi8, i2lo)     # <= 2^25
            z_hi = _dot_i8(lo8, ihi) + _dot_i8(hi8, i2hi)
            y = z_lo + barrett_reduce(z_hi, p) * jnp.int32(256)
            xs.append(barrett_reduce(y, p))
            continue
        else:
            lo8, hi8 = residue_limbs(item)
            limbs = jnp.concatenate([lo8, hi8], axis=-1)        # [.., 2N]
            m_lo, m_hi = plan.inv_cat_lo[i], plan.inv_cat_hi[i]
        z_lo = _dot_i8(limbs, jnp.asarray(m_lo))                # <= 2^25
        z_hi = _dot_i8(limbs, jnp.asarray(m_hi))
        y = z_lo + barrett_reduce(z_hi, p) * jnp.int32(256)     # <= 2^25.1
        if corr is not None:
            y = y + jnp.asarray(corr)                           # +p/2: safe
        xs.append(barrett_reduce(y, p))
    return crt_combine(xs, plan, width)


def crt_combine(xs, plan: NTTPlan, width: int = 32):
    """Centered-exact CRT: x mod 2^width from centered residues.

    m = round(sum x_p * e_p / P) recovers the integer multiple of P in
    sum x_p*e_p; valid because |x| < P/4 and the f32 error is < 2^-6
    (frac terms |x_p * theta_p| <= 0.55p <= 2^15.1, so even a 14-prime
    64-bit plan's summed rounding error stays ~2^-5.7 < 1/4).
    """
    frac = sum(x.astype(jnp.float32) * np.float32(t)
               for x, t in zip(xs, plan.crt_theta))
    m = jnp.round(frac).astype(jnp.int32)
    if width == 64:
        out = sum(x.astype(jnp.int64) * jnp.int64(e)
                  for x, e in zip(xs, plan.crt_e64))
        return out - m.astype(jnp.int64) * jnp.int64(plan.p_mod64)
    out = sum(x * jnp.int32(e) for x, e in zip(xs, plan.crt_e))
    return out - m * jnp.int32(plan.p_mod)


# ---------------------------------------------------------------------------
# Key material in NTT residue form
# ---------------------------------------------------------------------------


def to_ntt_form(polys, plan: NTTPlan, drop_bits: int = 0, width: int = 32):
    """Torus polys [..., N] (carrier at ``width``) -> int16
    [n_primes, ..., N] residues.

    drop_bits > 0 rounds the polys to their top (width - drop_bits) bits
    first (noise/performance trade, same role as bsk_limbs in the Toeplitz
    engine); callers must scale the convolution back by 2^drop_bits.
    """
    dtype = jnp.int32 if width == 32 else jnp.int64
    x = jnp.asarray(polys, dtype)
    if drop_bits:
        half = jnp.asarray(1 << (drop_bits - 1), dtype)
        x = jax.lax.shift_right_arithmetic(
            x + half, jnp.asarray(drop_bits, dtype))
    res = ntt_forward(x, plan, digit_limbs=width // 8, digit_bound=128)
    out = []
    for r, p in zip(res, plan.primes):
        # final centered reduce to |.| <= p/2 so int16 storage is canonical
        r = r - jnp.int32(p) * (r > jnp.int32(p // 2)).astype(jnp.int32)
        r = r + jnp.int32(p) * (r < -jnp.int32(p // 2)).astype(jnp.int32)
        out.append(r.astype(jnp.int16))
    return jnp.stack(out)


def pointwise_extprod(d_hat, key_hat, plan: NTTPlan, reduce_output: bool = True):
    """sum over rows of d_hat[..., R, N] * key_hat[prime][R, C, N] -> per-prime
    int32 [..., C, N] residues, exact mod p.

    d_hat: list per prime, int16/int32 [..., R, N] centered (<= 0.52p)
    key_hat: int16 [n_primes, R, C, N] centered (|.| <= p/2)

    Output bound: |u| <= 0.55p when reduced; ``reduce_output=False`` (the
    rotate-combine FOLD: the consumer is a combiner that reduces anyway)
    skips the final barrett, returning |u| <= p + 768 (<= 2 group-partials
    of p/2 + 384 each; primes needing > 2 row groups are reduced down to
    that bound here so the contract is uniform).  The n_groups == 1 final
    barrett is skipped unconditionally — a single group-partial is already
    inside the 0.55p envelope, so that barrett would be wasted work.
    """
    outs = []
    R = key_hat.shape[1]
    for i, p in enumerate(plan.primes):
        g = plan.row_group(p)
        kh = key_hat[i].astype(jnp.int32)               # [R, C, N]
        d = d_hat[i].astype(jnp.int32)[..., :, None, :]  # [..., R, 1, N]
        parts = []
        for r0 in range(0, R, g):
            part = sum(d[..., r, :, :] * kh[r] for r in range(r0, min(r0 + g, R)))
            parts.append(barrett_reduce(part, p))        # each <= p/2 + 384
        while len(parts) > 2:                            # rare (small primes)
            parts = [barrett_reduce(parts[0] + parts[1], p)] + parts[2:]
        acc = parts[0] if len(parts) == 1 else parts[0] + parts[1]
        if reduce_output and len(parts) > 1:
            acc = barrett_reduce(acc, p)
        outs.append(acc)
    return outs


def _rot_mode() -> str:
    """'full' (default) gathers full psi rows; 'half' gathers N/2-wide
    rows and reconstructs the upper half by the (-1)^t sign, saving
    gather bytes at the cost of re-joining the halves with a
    concatenate.  Neither is yet measured on the GPU.  Both bit-exact; override with ZTFHE_ROT=half|full."""
    return os.environ.get("ZTFHE_ROT") or "full"


def _rot_rows(t_cat, plan: NTTPlan):
    """Gather psi rows for a batch of rotation amounts.

    Returns (rows_all int32 [T, P*W], signs int32 [T] or None, W) where
    W == N (full mode, signs None) or N/2 (half mode; row k + N/2 ==
    sign * row k)."""
    if _rot_mode() == "half":
        merged = jnp.asarray(plan.rot_merged_half)          # [2N, P*N/2]
        rows = jnp.take(merged, t_cat, axis=0).astype(jnp.int32)
        signs = 1 - 2 * (t_cat & 1)                          # (-1)^t
        return rows, signs, plan.N // 2
    merged = jnp.asarray(plan.rot_merged)                   # [2N, P*N]
    return jnp.take(merged, t_cat, axis=0).astype(jnp.int32), None, plan.N


def rotate_combine2(u1, u2, u12, t1, t2, plan: NTTPlan, u_wide: bool = False):
    """(psi^t1 - 1) u1 + (psi^t2 - 1) u2 + (psi^t1 - 1)(psi^t2 - 1) u12.

    The multi-bit blind-rotate combiner (group=2).  u*: per-prime int16/int32
    [B, ..., N] residues (|.| <= 0.52p, or <= p + 768 with u_wide=True —
    the pointwise FOLD, see rotate_combine_multi); t1/t2: int32 [B] in
    [0, 2N].  Returns per-prime int32 residues (|.| <= 0.52p).
    Overflow proof, narrow u (worst case p = 63000, barrett bound
    0.5157p = 32484): |d1|,|d2| <= p/2 + 1 = 31501 and |u| <= 32484, so
    |d1*v1 + d2*v2| <= 2 * 31501 * 32484 = 2.047e9 < 2^31; d12 is itself a
    barrett output (<= 32484), so |d12*v12 + r1| <= 32484^2 + 32484
    = 1.056e9 < 2^31 — one reduction per column is saved by the fold.
    Wide u: each single product <= 31884 * 63768 = 2.033e9 < 2^31, and a
    barrett output (<= 31884) rides along as the additive carry, so the
    chain barrett(d12*w12 + barrett(d2*w2 + barrett(d1*w1))) is exact —
    3 barretts here vs 3 skipped pointwise ones per COLUMN (net win: the
    pointwise ones act on [B, 2, N], these on [B, N] halves).
    """
    mask = jnp.int32(2 * plan.N - 1)
    t1 = jnp.asarray(t1) & mask
    t2 = jnp.asarray(t2) & mask
    B = t1.shape[0]
    N = plan.N
    t_cat = jnp.concatenate([t1, t2])
    # ONE gather for all primes: per-prime rows are slices of the
    # precomputed merged table; 'half' mode additionally halves the
    # gathered bytes via the psi^N = -1 row symmetry (see _rot_rows).
    rows_all, signs, W = _rot_rows(t_cat, plan)             # [2B, P*W]
    n_half = N // W
    outs = []
    for i, p in enumerate(plan.primes):
        raw = rows_all[:, i * W:(i + 1) * W]            # [2B, W]
        r1raw, r2raw = raw[:B], raw[B:]
        v1 = u1[i].astype(jnp.int32)
        v2 = u2[i].astype(jnp.int32)
        v12 = u12[i].astype(jnp.int32)
        halves = []
        for h in range(n_half):
            if h and signs is not None:
                s1 = signs[:B, None]
                s2 = signs[B:, None]
                d1 = s1 * r1raw - 1                     # |.| <= p/2 + 1
                d2 = s2 * r2raw - 1
            else:
                d1 = r1raw - 1
                d2 = r2raw - 1
            d12 = barrett_reduce(d1 * d2, p)            # <= 0.52p
            w1, w2, w12 = (v[..., h * W:(h + 1) * W] for v in (v1, v2, v12))
            e1, e2, e12 = d1, d2, d12
            while e1.ndim < w1.ndim:
                e1, e2, e12 = e1[:, None], e2[:, None], e12[:, None]
            if u_wide:
                r1 = barrett_reduce(e1 * w1, p)
                r2 = barrett_reduce(e2 * w2 + r1, p)
                halves.append(barrett_reduce(e12 * w12 + r2, p))
            else:
                r1 = barrett_reduce(e1 * w1 + e2 * w2, p)
                halves.append(barrett_reduce(e12 * w12 + r1, p))
        outs.append(halves[0] if n_half == 1
                    else jnp.concatenate(halves, axis=-1))
    return outs


def rotate_combine_multi(us, ts, plan: NTTPlan, u_wide: bool = False):
    """Generic multi-bit combiner: sum over nonempty subsets S of
    prod_{i in S}(psi^{t_i} - 1) * u_S.

    us:  list of 2^g - 1 per-prime residue lists, indexed by subset mask
         m - 1 (mask bit i <-> coefficient i); each u int16/int32
         [B, ..., N] with |.| <= 0.55p (u_wide=False) or <= p + 768
         (u_wide=True: the pointwise-extprod FOLD — unreduced group-pair
         sums from ``pointwise_extprod(reduce_output=False)``).
    ts:  list of g int32 [B] rotation amounts.
    Returns per-prime int32 residues (|.| <= 0.52p).

    Overflow accounting (worst prime 63000): every d_m is either a
    singleton psi-row minus 1 (|.| <= p/2 + 1 = 31501) or a barrett
    output (<= p/2 + 384 = 31884).  Narrow u (<= 31884): a product
    d_m * u_m <= 31884^2 = 1.017e9, so terms are reduced in PAIRS
    (2 * 1.017e9 = 2.033e9 < 2^31); the <= 2^(g-1) pair-partials
    (each <= 31884) then sum far below 2^31 before one final barrett.
    Wide u (<= p + 768 = 63768): d_m * u_m <= 31884 * 63768 = 2.033e9
    < 2^31 for a SINGLE product, so terms are reduced individually —
    2^(g-1) - 1 extra barretts here buy 2^g - 1 skipped barretts in the
    pointwise stage (a net saving of elementwise work).  The subset diagonals build
    by binary DP: d[m] = barrett(d[m w/o lowest bit] * d[lowest bit]),
    2^g - 1 - g barretts on [B, N] planes.
    """
    g = len(ts)
    mask_all = jnp.int32(2 * plan.N - 1)
    t_cat = jnp.concatenate([jnp.asarray(t) & mask_all for t in ts])
    B = ts[0].shape[0]
    rows_all, signs, W = _rot_rows(t_cat, plan)
    n_half = plan.N // W
    outs = []
    for i, p in enumerate(plan.primes):
        raw = rows_all[:, i * W:(i + 1) * W]
        halves = []
        for h in range(n_half):
            d = {}
            for j in range(g):
                r = raw[j * B:(j + 1) * B]
                if h and signs is not None:
                    r = signs[j * B:(j + 1) * B, None] * r
                d[1 << j] = r - 1                    # |.| <= p/2 + 1
            for m in range(1, 1 << g):
                if m & (m - 1):                      # >= 2 bits set
                    low = m & -m
                    d[m] = barrett_reduce(d[m ^ low] * d[low], p)
            # reduced sum over all subset terms (pairwise for narrow u,
            # per-term for wide u — see the overflow accounting above)
            terms = []
            for m in range(1, 1 << g):
                u = us[m - 1][i].astype(jnp.int32)
                if n_half > 1:
                    u = u[..., h * W:(h + 1) * W]
                e = d[m]
                while e.ndim < u.ndim:
                    e = e[:, None]
                terms.append((e, u))
            partials = []
            stride = 1 if u_wide else 2
            for a in range(0, len(terms), stride):
                part = terms[a][0] * terms[a][1]
                if stride == 2 and a + 1 < len(terms):
                    part = part + terms[a + 1][0] * terms[a + 1][1]
                partials.append(barrett_reduce(part, p))
            halves.append(barrett_reduce(sum(partials), p))
        outs.append(halves[0] if n_half == 1
                    else jnp.concatenate(halves, axis=-1))
    return outs


def rotate_diag(res_list, t, plan: NTTPlan, minus_one: bool = True):
    """Multiply NTT residues by the diagonal of X^t (optionally X^t - 1).

    res_list: per prime int16/int32 [B, ..., N]; t: int32 [B] in [0, 2N).
    Wide (unreduced, <= p + 768) residues from
    ``pointwise_extprod(reduce_output=False)`` are accepted: the single
    product per output |row * u| <= (p/2 + 2)(p + 768) < 2^31 for every
    plan prime (worst 31502 * 63768 = 2.009e9 at the p = 63000 cap).
    Returns per-prime int32 residues (<= 0.52p).
    """
    t = jnp.asarray(t) & jnp.int32(2 * plan.N - 1)      # X^(2N) == X^0
    N = plan.N
    rows_all, signs, W = _rot_rows(t, plan)             # [B, P*W]
    n_half = N // W
    outs = []
    for i, p in enumerate(plan.primes):
        raw = rows_all[..., i * W:(i + 1) * W]          # [B, W]
        v = res_list[i].astype(jnp.int32)
        halves = []
        for h in range(n_half):
            row = signs[:, None] * raw if (h and signs is not None) else raw
            if minus_one:
                row = row - 1                            # |.| <= p/2 + 1
            w = v[..., h * W:(h + 1) * W]
            e = row
            while e.ndim < w.ndim:
                e = e[:, None]
            halves.append(barrett_reduce(w * e, p))
        outs.append(halves[0] if n_half == 1
                    else jnp.concatenate(halves, axis=-1))
    return outs
