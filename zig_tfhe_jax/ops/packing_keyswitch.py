"""TLWE -> TRLWE packing key switch (the tree-PBS enabler).

No reference analog: the reference has only the lv1->lv0 identity key
switch (trgsw.zig:471-502) and evaluates nothing above message modulus 16
(everything is comptime-pinned to the 128-bit boolean set,
params.zig:386-416).  Packing K TLWE(lv1) samples into ONE TRLWE — sample
k's message landing on coefficient k*delta — is what lets an encrypted
small-modulus index SELECT among K encrypted values with a single blind
rotation (models/lut.py:bootstrap_lut_radix), the standard route to
message moduli beyond the N=1024 modswitch capacity (docs/NOISE.md §8).

Batched: the whole pack is one int8-limb matmul (the identity-key-switch
kernel, ops/keyswitch.py) plus K static negacyclic rotations; the
block-spread multiply is one NTT round trip against a static window
polynomial.

Security note: the packing key encrypts lv1-key digit multiples UNDER the
lv1 key itself — the standard LWE-to-RLWE packing assumption (same
circular flavor as every TFHE bootstrapping-key/KSK cycle; see
docs/NOISE.md "Multi-bit key assumption" for the library's posture).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import trlwe as _trlwe
from zig_tfhe_jax.ops import ntt as _ntt
from zig_tfhe_jax.ops.decomposition import ks_decompose
from zig_tfhe_jax.ops.keyswitch import ks_plaintexts
from zig_tfhe_jax.ops.poly import negacyclic_rotate, small_matmul_torus
from zig_tfhe_jax.params import SecurityParams


def default_packing_gadget(params: SecurityParams) -> tuple:
    """(basebit, t) the packing key is built at when callers pass None.

    32-bit sets keep the parameter set's (basebit, iks_t) — the contract
    the 32-bit radix accuracy results were taken under.  64-bit sets use
    (8, 3): the packing rows are encrypted at the LV1 noise (bsk_alpha,
    e.g. 2^-49 at SECURITY_128_BIT_T64), so the digit-noise term is
    sqrt(n1*t*B^2/12)*alpha ~ 2^-36.5 even at base 256 — utterly
    negligible — while the decomposition-truncation term (the remainder
    below basebit*t bits, convolved with the binary lv1 key:
    sqrt(n1/2)*2^-(basebit*t+1)/sqrt(3)) needs basebit*t = 24 bits to sit
    at 2^-20.8, i.e. ~2^-17.8 after a delta=64 block spread — far under
    the t64 select budget.  (8, 3) reaches those 24 bits with 1/4 the
    rows of the set's (2, 12) lv1->lv0 gadget, quartering the packing
    key's device-memory footprint (201 MB at N=2048, from its shape) and
    matmul length.
    """
    if params.torus_bits == 32:
        return (params.basebit, params.iks_t)
    return (8, 3)


def gen_packing_ksk(key, secret_key_lv1, params: SecurityParams,
                    basebit: int | None = None, t: int | None = None,
                    alpha: float | None = None):
    """Packing key-switch key: carrier [n1*t, 2, N] (int32 at 32-bit
    torus, int64 at 64-bit).

    Row (i*t + j) is a TRLWE encryption (under the SAME lv1 key) of the
    constant polynomial with coefficient 0 equal to
    ``s1[i] * 2^(w-(j+1)*basebit)`` — the shared key-switch row encoding
    (ops/keyswitch.py:ks_plaintexts) lifted to ring ciphertexts.
    (basebit, t) default per width (default_packing_gadget).

    alpha defaults to the LV1 noise (params.bsk_alpha): the rows are
    TRLWE encryptions under the lv1 key, the same assumption as the
    bootstrapping key's rows.  (The lv0-calibrated ksk_alpha would be
    dimensionally wrong here — at uint4 it measurably blows the packed
    testvec's budget once the block spread multiplies it by sqrt(delta).)
    """
    from zig_tfhe_jax.utils.torus import carrier_dtype

    db, dt_ = default_packing_gadget(params)
    basebit = db if basebit is None else basebit
    t = dt_ if t is None else t
    alpha = params.bsk_alpha if alpha is None else alpha
    w = params.torus_bits
    n1, N = params.n1, params.N
    vals = ks_plaintexts(secret_key_lv1, basebit, t, w)    # [n1, t]
    mu = (jnp.zeros((n1, t, N), carrier_dtype(w))
          .at[:, :, 0].set(vals))
    ct = _trlwe.encrypt_torus(key, mu, float(alpha), secret_key_lv1,
                              width=w)
    return ct.reshape(n1 * t, 2, N)


def packing_key_switch(tlwes, pksk, basebit: int, t: int, delta: int):
    """Pack TLWE(lv1) samples k onto coefficients k*delta of one TRLWE.

    tlwes: carrier [..., K, n1+1] (lv1 samples, e.g. bootstrap_to_lv1
           outputs); pksk: carrier [n1*t, 2, N] from gen_packing_ksk.
    Returns carrier [..., 2, N] whose phase is
    ``sum_k message_k * X^(k*delta)`` (+ key-switch noise elsewhere).

    out = sum_k X^(k*delta) * ((0, b_k) - sum_ij digit_kij * PKSK[ij]);
    the digit contraction is one exact int8-limb matmul over all K
    samples (both widths ride small_matmul_torus's limb form — the
    64-bit carrier contracts digits against 8 int8 key limbs), the
    rotations are static (K is a Python int).
    """
    width = 64 if tlwes.dtype == jnp.int64 else 32
    n1 = tlwes.shape[-1] - 1
    N = pksk.shape[-1]
    K = tlwes.shape[-2]
    half_base = 1 << (basebit - 1)
    digits = ks_decompose(tlwes[..., :n1], basebit, t,
                          width)                           # [..., K, n1, t]
    d = digits.reshape(digits.shape[:-2] + (n1 * t,))
    u = small_matmul_torus(d, pksk.reshape(n1 * t, 2 * N), half_base,
                           width)
    u = u.reshape(u.shape[:-1] + (2, N))                   # [..., K, 2, N]
    base = (-u).at[..., 1, 0].add(tlwes[..., n1])
    out = None
    for k in range(K):
        term = negacyclic_rotate(base[..., k, :, :], (k * delta) % (2 * N))
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=None)
def _window_poly(N: int, delta: int) -> np.ndarray:
    """W(X) = X^(-delta/2) * (1 + X + ... + X^(delta-1)) as centered
    int8 negacyclic coefficients: +1 on [0, delta/2), -1 on [N - delta/2, N)
    (negative exponents wrap with the X^N = -1 sign)."""
    w = np.zeros(N, np.int8)
    w[: delta // 2] = 1
    w[N - delta // 2:] = -1
    return w


def spread_blocks(packed, delta: int, params: SecurityParams):
    """Multiply a packed TRLWE by the centered block window W(X).

    Each point mass at k*delta becomes a constant block of width delta
    CENTERED on k*delta — exactly the bin structure a Generator testvec
    has, so a blind rotation over a modulus-(N/delta) index decodes it
    with the full delta/2 phase margin.

    32-bit carriers: exact mod 2^32 via one NTT round trip — |true conv|
    <= delta * 2^31 <= 2^40 at delta <= 512, covered by the bound-41
    plan (P = 2^47.09 > 4 * 2^41).

    64-bit carriers (the split-ring sets): the NTT bound story fails
    (delta * 2^63 overruns every CRT pool), but W(X) = X^(-delta/2) *
    (1 + X + ... + X^(delta-1)) needs no ring product at all — the
    geometric sum builds by DOUBLING, S_{2k} = S_k + X^k * S_k, so the
    whole spread is log2(delta) static negacyclic rotate-adds plus one
    centering rotation, exact mod 2^64 (rotations are index permutations
    with sign flips; adds wrap).  Noise: each output coefficient sums
    delta inputs, so the packing noise grows by sqrt(delta) — identical
    to the NTT route (it is the same polynomial identity).
    """
    assert delta & (delta - 1) == 0 and delta >= 2, delta
    if params.torus_bits == 64:
        out = packed
        k = 1
        while k < delta:
            out = out + negacyclic_rotate(out, k)
            k *= 2
        return negacyclic_rotate(out, 2 * params.N - delta // 2)
    # the exactness argument above requires |conv| <= delta * 2^31 <= 2^40,
    # i.e. delta <= 512 = N/2 at N=1024 (m_hi = 1 would give delta = N and
    # a 2^41 bound — still under P/4 but outside the documented contract;
    # ADVICE r3 #2 asked the code to enforce the bound the comment proves)
    assert delta <= params.N // 2, (delta, params.N)
    plan = _ntt.make_plan(params.N, 41)
    w = jnp.asarray(_window_poly(params.N, delta))
    p_hat = _ntt.ntt_forward(packed, plan, digit_limbs=4, digit_bound=128)
    w_hat = _ntt.ntt_forward(w, plan, digit_limbs=1, digit_bound=1)
    v_hat = [_ntt.barrett_reduce(p_hat[i] * w_hat[i], p)
             for i, p in enumerate(plan.primes)]
    return _ntt.ntt_inverse_to_crt(v_hat, plan)


def pack_tlwes_blocks(tlwes, m_hi: int, pksk, params: SecurityParams,
                      basebit: int | None = None, t: int | None = None):
    """Pack K = m_hi TLWE(lv1) samples into a blind-rotation testvec.

    Sample k's message occupies the delta = N/m_hi coefficient block
    centered on k*delta; the result is a (noisy) TRLWE usable directly as
    a per-lane testvec for a blind rotation over a modulus-m_hi input.
    tlwes: carrier [..., m_hi, n1+1] -> carrier [..., 2, N].
    """
    db, dt_ = default_packing_gadget(params)
    basebit = db if basebit is None else basebit
    t = dt_ if t is None else t
    N = params.N
    assert N % m_hi == 0, (N, m_hi)
    delta = N // m_hi
    packed = packing_key_switch(tlwes, pksk, basebit, t, delta)
    return spread_blocks(packed, delta, params)
