"""Blind rotation on the matmul-NTT engine (the fast path).

Per step (cf. blindRotate, trgsw.zig:290-333, restructured for batched
integer matmuls):

    digits = gadget_decompose(acc)                 # coeff domain, elementwise
    d_hat  = NTT(digits)                           # int8 matmuls (static matrices)
    u_hat  = sum_rows d_hat * BSK_hat[i]           # elementwise modmul
    v_hat  = (psi^t - 1) * u_hat                   # NTT-domain X^t rotation
    acc   += CRT(invNTT(v_hat)) << drop_bits       # int8 matmuls + elementwise

The classic CMux order is rotate-then-decompose:
``acc += ExtProd(BSK_i, (X^t - 1) acc)``.  We use the algebraically
equivalent ``acc += (X^t - 1) ExtProd(BSK_i, acc)`` — polynomial
multiplication commutes with the external product's linear part, and the
decomposition/key noise merely picks up a factor <= 2 in L-inf (still far
under the margin; validated by gate-accuracy tests).  The payoff: the
coefficient-domain rotation is a per-batch-element gather along the
coefficient axis, while the NTT-domain rotation is one row gather from a
static psi-power table and an elementwise product.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from zig_tfhe_jax.ops import ntt as _ntt
from zig_tfhe_jax.ops.blind_rotate import modswitch, _decompose_to_rows
from zig_tfhe_jax.params import SecurityParams


def _use_fold(e_limbs: int) -> bool:
    """Pointwise/rotate barrett fold (ops/ntt.py:pointwise_extprod
    reduce_output=False).  PLAN-AWARE default: ON for single-limb engine
    digits (the boolean gadgets), OFF for multi-limb digits (uint sets:
    the per-term combine reductions multiply across their 5+ prime
    planes).  Not yet measured on the GPU.
    ZTFHE_FOLD=0/1 overrides either way.

    TRACE-TIME semantics: the env var is read when
    the jitted scan body is TRACED; flipping it after a kernel compiled
    has no effect on that kernel (the jit cache is keyed on shapes/static
    args, not env).  Set it before the first call of a given shape.
    Unrecognized values raise (ADVICE r3 #3) — a typo like ZTFHE_FOLD=off
    silently falling through to the default is worse than an error."""
    env = os.environ.get("ZTFHE_FOLD", "")
    if env in ("0", "false"):
        return False
    if env in ("1", "true"):
        return True
    if env:
        raise ValueError(
            f"ZTFHE_FOLD={env!r} not recognized: use 0/false, 1/true, or "
            "unset for the plan-aware default")
    return e_limbs == 1


def rotate_via_ntt(polys, t, plan, width: int = 32):
    """Exact negacyclic X^t rotation of full-torus polys through the NTT.

    polys: carrier [..., N] (any torus values); t: int32 [B] with the batch
    axis leading in polys (or polys unbatched, broadcast against t).
    Coefficient-domain rotation is a per-batch gather along the
    coefficient axis; round-tripping through the NTT costs about one
    matmul step instead.  Exactness: the result's
    integer coefficients are the original values (|.| <= 2^(width-1)
    < P/4 on the width's plan).
    """
    p_hat = _ntt.ntt_forward(polys, plan, digit_limbs=width // 8,
                             digit_bound=128)
    r_hat = _ntt.rotate_diag(p_hat, t, plan, minus_one=False)
    return _ntt.ntt_inverse_to_crt(r_hat, plan, width)


def blind_rotate_ntt(tlwe_batch, testvec, bsk_ntt, params: SecurityParams,
                     drop_bits: int, unroll: int = 1, group: int = 1,
                     levels=None, bgbit: int | None = None,
                     tv_lo_zero: bool = False):
    """tlwe_batch int32 [B, n0+1]; testvec int32 [2,N] or [B,2,N];
    bsk_ntt int16 [n0, P, la+lb, 2, N] (group=1) or
    [G, 2^g-1, P, la+lb, 2, N] (multi-bit, G = ceil(n0/g)).
    Returns int32 [B, 2, N].

    (bgbit, levels) is the key's ENGINE gadget (None -> the parameter
    base; ops/ntt.py:default_engine_gadget).  levels is the
    (a_levels, b_levels) of the key's gadget rows (an int means
    symmetric; None infers a symmetric count from the key's row axis —
    pre-asymmetric saved keys).  levels below the full count selects the
    approximate gadget: only the top digits of the accumulator feed the
    external product — la+lb rows through forward NTT + pointwise
    instead of 2L (ops/ntt.py:norm_levels for the asymmetric rationale)."""
    if params.split_ring:
        # N > 1024: the even/odd split engine (ops/split_ring.py) — the
        # direct N-point plan is prime-density-impossible (TORUS64.md §3).
        from zig_tfhe_jax.ops.split_ring import blind_rotate_split
        return blind_rotate_split(tlwe_batch, testvec, bsk_ntt, params,
                                  drop_bits, unroll=unroll, group=group,
                                  levels=levels, bgbit=bgbit,
                                  tv_lo_zero=tv_lo_zero)
    e = params.bgbit if bgbit is None else bgbit
    if levels is None:
        levels = (bsk_ntt.shape[2] if group == 1 else bsk_ntt.shape[3]) // 2
    levels = _ntt.norm_levels(params, levels, bgbit=e)
    n_rows = levels[0] + levels[1]
    assert n_rows == (bsk_ntt.shape[2] if group == 1 else bsk_ntt.shape[3]), \
        (levels, bsk_ntt.shape)
    plan = _ntt.plan_for_params(params, drop_bits, group, levels, bgbit=e,
                                pseudorandom_key=True)
    key_primes = bsk_ntt.shape[1] if group == 1 else bsk_ntt.shape[2]
    if key_primes != plan.n_primes:
        # A key serialized under a different plan-bound version: residues
        # mod the wrong primes would decrypt to noise with no error.
        raise ValueError(
            f"BSK holds {key_primes} CRT prime planes but the current "
            f"plan selects {plan.n_primes} — this key was generated under "
            "a different plan bound (regenerate it, or set "
            "ZTFHE_WORSTCASE_BOUND to match how it was built)")
    n0, N = params.n0, params.N
    w = params.torus_bits
    B = tlwe_batch.shape[0]
    e_limbs = _ntt.engine_digit_limbs(e)
    dbound = _ntt.top_limb_bound(1 << (e - 1), e_limbs)

    b = tlwe_batch[..., n0]
    b_tilda = jnp.int32(2 * N) - modswitch(b, params)
    if testvec.ndim == 2:
        testvec = testvec[None]          # [1, 2, N] broadcasts against [B]
    acc = rotate_via_ntt(testvec, b_tilda, plan, w)
    acc = jnp.broadcast_to(acc, (B, 2, N)) if acc.shape[0] != B else acc

    a_cols = jnp.swapaxes(tlwe_batch[..., :n0], 0, 1)  # [n0, B]

    def fwd(acc):
        rows = _decompose_to_rows(acc, params, levels, bgbit=e)
        return _ntt.ntt_forward(rows, plan, e_limbs, dbound)

    def finish(acc, v_hat):
        delta = _ntt.ntt_inverse_to_crt(v_hat, plan, w)  # [B, 2, N] carrier
        if drop_bits:
            delta = jax.lax.shift_left(delta, jnp.asarray(drop_bits,
                                                          delta.dtype))
        return acc + delta

    if group == 1:
        def step(acc, xs):
            bsk_i, a_col = xs                          # [P, 2L, 2, N], [B]
            t = modswitch(a_col, params)               # [B] in [0, 2N)
            # FOLD unconditionally: rotate_diag's single product absorbs
            # the unreduced pointwise output with the SAME one barrett
            # either way (its docstring bounds) — unlike the multi-bit
            # combiners there is no narrow/wide trade-off here
            u_hat = _ntt.pointwise_extprod(fwd(acc), bsk_i, plan,
                                           reduce_output=False)
            v_hat = _ntt.rotate_diag(u_hat, t, plan, minus_one=True)
            return finish(acc, v_hat), None

        acc, _ = jax.lax.scan(step, acc, (bsk_ntt, a_cols), unroll=unroll)
        return acc

    G = bsk_ntt.shape[0]
    if a_cols.shape[0] < group * G:                    # ragged n0: pad a=0
        a_cols = jnp.concatenate(
            [a_cols, jnp.zeros((group * G - n0, B), jnp.int32)])
    a_pairs = a_cols.reshape(G, group, B)

    if group > 2:
        def step_multi(acc, xs):
            """acc += sum over nonempty subsets S of prod_{i in S}
            (X^t_i - 1) * ExtProd(s_S, acc) — group-g multi-bit rotation,
            ONE decompose + forward + inverse per g LWE coefficients
            (BSK rows encrypt all subset products of the g key bits).
            The pointwise/combine FOLD skips 2^g - 1 pointwise barretts
            per prime for 2^(g-1) - 1 extra combine barretts (bounds in
            ops/ntt.py:rotate_combine_multi)."""
            bsk_g, a_grp = xs          # [2^g-1, P, 2L', 2, N], [g, B]
            ts = [modswitch(a_grp[j], params) for j in range(group)]
            d_hat = fwd(acc)
            fold = _use_fold(e_limbs)
            us = [_ntt.pointwise_extprod(d_hat, bsk_g[m], plan,
                                         reduce_output=not fold)
                  for m in range((1 << group) - 1)]
            v_hat = _ntt.rotate_combine_multi(us, ts, plan, u_wide=fold)
            return finish(acc, v_hat), None

        acc, _ = jax.lax.scan(step_multi, acc, (bsk_ntt, a_pairs),
                              unroll=unroll)
        return acc

    assert group == 2, group

    def step2(acc, xs):
        """acc += (X^t1-1) EP(s1) + (X^t2-1) EP(s2) + (X^t1-1)(X^t2-1) EP(s1 s2).

        One decompose + one forward + one inverse per TWO LWE coefficients
        (multi-bit blind rotation; BSK rows encrypt s1, s2, s1*s2)."""
        bsk_g, a_pair = xs                             # [3, P, 2L, 2, N], [2, B]
        t1 = modswitch(a_pair[0], params)
        t2 = modswitch(a_pair[1], params)
        d_hat = fwd(acc)
        fold = _use_fold(e_limbs)
        u1 = _ntt.pointwise_extprod(d_hat, bsk_g[0], plan,
                                    reduce_output=not fold)
        u2 = _ntt.pointwise_extprod(d_hat, bsk_g[1], plan,
                                    reduce_output=not fold)
        u12 = _ntt.pointwise_extprod(d_hat, bsk_g[2], plan,
                                     reduce_output=not fold)
        v_hat = _ntt.rotate_combine2(u1, u2, u12, t1, t2, plan, u_wide=fold)
        return finish(acc, v_hat), None

    acc, _ = jax.lax.scan(step2, acc, (bsk_ntt, a_pairs), unroll=unroll)
    return acc


def external_product_ntt(trgsw_ntt, ct, params: SecurityParams,
                         drop_bits: int = 0, levels=None,
                         bgbit: int | None = None):
    """Standalone NTT external product (oracle/tests).

    trgsw_ntt: int16 [n_primes, la+lb, 2, N]; ct: int32 [..., 2, N].
    Exact vs the Toeplitz engine when drop_bits matches the key form and
    levels == L (row-sliced keys select the approximate gadget; an
    (la, lb) tuple selects the asymmetric slicing; bgbit selects an
    engine-gadget key's base).
    """
    e = params.bgbit if bgbit is None else bgbit
    if levels is None:
        levels = trgsw_ntt.shape[1] // 2
    levels = _ntt.norm_levels(params, levels, bgbit=e)
    plan = _ntt.plan_for_params(params, drop_bits, levels=levels, bgbit=e)
    if trgsw_ntt.shape[0] != plan.n_primes:
        raise ValueError(
            f"TRGSW holds {trgsw_ntt.shape[0]} CRT prime planes but the "
            f"current plan selects {plan.n_primes} — ciphertext and plan "
            "were built under different plan bounds")
    e_limbs = _ntt.engine_digit_limbs(e)
    dbound = _ntt.top_limb_bound(1 << (e - 1), e_limbs)
    rows = _decompose_to_rows(ct, params, levels, bgbit=e)
    d_hat = _ntt.ntt_forward(rows, plan, e_limbs, dbound)
    u_hat = _ntt.pointwise_extprod(d_hat, trgsw_ntt, plan)
    out = _ntt.ntt_inverse_to_crt(u_hat, plan, params.torus_bits)
    if drop_bits:
        out = jax.lax.shift_left(out, jnp.asarray(drop_bits, out.dtype))
    return out
