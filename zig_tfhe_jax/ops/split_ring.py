"""Even/odd split-ring engine: N=2048 negacyclic arithmetic on the
N=1024 NTT plan (docs/TORUS64.md §4).

The matmul-NTT engine's int8 residue-limb cap admits only three primes
p ≡ 1 (mod 4096) below 63000 (44.8 bits of CRT product) — a DIRECT
N=2048 transform is impossible at any torus width (TORUS64.md §3).  The
unblocking isomorphism: Z[X]/(X^2048+1) ≅ pairs over Y = X², i.e.

    a(X) = a_e(Y) + X * a_o(Y),   a_e, a_o ∈ Z[Y]/(Y^1024+1),

so one N=2048 ring product becomes FOUR N=1024 products on the shipped
74.8-bit five-prime pool:

    c_e = Σ a_e b_e + Y * (a_o b_o)        c_o = Σ a_e b_o + a_o b_e

with multiply-by-Y a static diagonal (psi^(2k+1)) in the NTT domain.
The external product collapses onto the EXISTING per-prime contraction
(ops/ntt.py:pointwise_extprod) by flattening (row, input-parity) into a
2R-row axis and (component, output-parity) into a 4-plane column axis,
with the Y-twist folded into the key planes at keygen — zero new
hot-loop code on the matmul path.

X^t rotation (t = 2u + r): r=0 keeps parities ((Y^u e, Y^u o)); r=1
swaps them with one extra Y ((Y^(u+1) o, Y^u e)).  Branchless: ONE psi-
row gather (for Y^u) + a static psi^1 diagonal + a parity select.

Supported ring/torus: N > 1024 parameter sets (SecurityParams.split_ring)
with 64-bit carriers.  Multi-bit (group-g) blind rotation works through
the same pair representation: every rotation operator is the split-NTT
image (f_e_hat, f_o_hat) of its polynomial, products follow the
Y-twisted rule (x1x2 + psi1 y1y2, x1y2 + y1x2), and the BMMP16 subset
DP carries over verbatim (rotate_combine_multi_split).  Reference
anchor: the reference pins Torus=u32/N=1024 at
comptime (params.zig:21-30, 386-416); this engine is the capability door
beyond that ceiling (TORUS64.md §5: capability GO, throughput NO-GO —
~3.8x per-gate cost vs the 32-bit path, shipped for message-modulus and
noise-headroom demand, not for throughput).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax.ops import ntt as _ntt
from zig_tfhe_jax.ops.blind_rotate import modswitch, _decompose_to_rows
from zig_tfhe_jax.ops.poly import negacyclic_rotate
from zig_tfhe_jax.params import SecurityParams
from zig_tfhe_jax.utils.torus import shift_right_logical, to_i32


def split(x):
    """[..., N] -> [..., 2, N/2]: (even-index, odd-index) coefficient
    halves — a(X) = a_e(X^2) + X * a_o(X^2)."""
    return jnp.stack([x[..., 0::2], x[..., 1::2]], axis=-2)


def unsplit(x):
    """[..., 2, N/2] -> [..., N]: inverse of split (re-interleave)."""
    half = x.shape[-1]
    out = jnp.stack([x[..., 0, :], x[..., 1, :]], axis=-1)
    return out.reshape(x.shape[:-2] + (2 * half,))


def _rot_merged_rows(t, plan: _ntt.NTTPlan):
    """psi^(t(2k+1)) rows for all primes in one gather: int32 [B, P*N]."""
    merged = jnp.asarray(plan.rot_merged)
    return jnp.take(merged, t, axis=0).astype(jnp.int32)


def fold_key_split(res_e, res_o, plan: _ntt.NTTPlan):
    """Fold the Y-twist into split-key NTT planes.

    res_e/res_o: int16 [P, ..., R, 2, Nh] residues of the even/odd key
    halves (to_ntt_form output).  Returns int16 [..., P, 2R, 4, Nh] laid
    out for ops/ntt.py:pointwise_extprod: row axis r' = 2r + q_in,
    column axis c' = 2c + q_out, with

        K[(r,0),(c,0)] = k_e[r,c]      K[(r,1),(c,0)] = psi1 * k_o[r,c]
        K[(r,0),(c,1)] = k_o[r,c]      K[(r,1),(c,1)] = k_e[r,c]

    so u[c'] = Σ_r' d[r'] K[r',c'] computes c_e = d_e k_e + Y d_o k_o
    and c_o = d_e k_o + d_o k_e per component.  psi1 = psi^(2k+1) is the
    NTT diagonal of multiply-by-Y (plan.rot row 1).
    """
    outs = []
    for i, p in enumerate(plan.primes):
        psi1 = jnp.asarray(plan.rot[i][1].astype(np.int32))      # [Nh]
        ke = res_e[i].astype(jnp.int32)                  # [..., R, 2, Nh]
        ko = res_o[i].astype(jnp.int32)
        # |psi1 * ko| <= (p/2)^2 < 2^30: one product + barrett, then a
        # final centered reduce to |.| <= p/2 for canonical int16 storage
        koy = _ntt.barrett_reduce(psi1 * ko, p)
        koy = koy - jnp.int32(p) * (koy > jnp.int32(p // 2)).astype(jnp.int32)
        koy = koy + jnp.int32(p) * (koy < -jnp.int32(p // 2)).astype(jnp.int32)
        # rows (q_in): [..., R, 2(q_in), 2(c), 2(q_out), Nh]
        q0 = jnp.stack([ke, ko], axis=-2)            # [..., R, 2c, 2q, Nh]
        q1 = jnp.stack([koy, ke], axis=-2)
        k4 = jnp.stack([q0, q1], axis=-4)            # [..., R, 2qi, 2c, 2q, Nh]
        sh = k4.shape
        k4 = k4.reshape(sh[:-5] + (sh[-5] * 2, 4, sh[-1]))
        outs.append(k4.astype(jnp.int16))
    return jnp.stack(outs, axis=-4) if outs[0].ndim > 3 else jnp.stack(outs)


def rotate_minus1_split(us, t, plan: _ntt.NTTPlan):
    """(X^t - 1) * u in the split NTT domain, t in [0, 4*Nh).

    us: per-prime int32 [B, 4, Nh] with plane index 2c + q (the
    pointwise_extprod output under the fold_key_split layout), |.| <=
    0.55p.  Returns per-prime int32 [B, 2, 2, Nh] (component, parity)
    with |.| <= 0.52p.

    t = 2u + r:  X^t (e, o) = r ? (Y^(u+1) o, Y^u e) : (Y^u e, Y^u o).
    One psi-row gather for Y^u; Y^(u+1) = psi1 * Y^u folds the +1 into
    the operand (psi1 * u_o, then the shared row) — branchless parity
    select, no second gather.  Overflow: |row * sel| <= (p/2)(0.55p)
    <= 1.04e9 and the subtracted u adds < 2^16 — int32-safe for every
    plan prime (cap 63000).
    """
    Nh = plan.N
    t = jnp.asarray(t) & jnp.int32(4 * Nh - 1)
    r = (t & 1)[:, None, None]                       # [B, 1, 1]
    rows_all = _rot_merged_rows(t >> 1, plan)        # [B, P*Nh]
    outs = []
    for i, p in enumerate(plan.primes):
        row = rows_all[:, i * Nh:(i + 1) * Nh][:, None, :]   # [B, 1, Nh]
        psi1 = jnp.asarray(plan.rot[i][1].astype(np.int32))
        v = us[i].astype(jnp.int32)                  # [B, 4, Nh]
        ue = v[..., 0::2, :]                         # [B, 2, Nh] (q=0)
        uo = v[..., 1::2, :]                         # [B, 2, Nh] (q=1)
        m_o = _ntt.barrett_reduce(psi1 * uo, p)      # psi1*u_o, <= 0.52p
        sel_e = jnp.where(r != 0, m_o, ue)
        sel_o = jnp.where(r != 0, ue, uo)
        ve = _ntt.barrett_reduce(row * sel_e - ue, p)
        vo = _ntt.barrett_reduce(row * sel_o - uo, p)
        outs.append(jnp.stack([ve, vo], axis=-2))    # [B, 2, 2, Nh]
    return outs


def rotate_combine_multi_split(us, ts, plan: _ntt.NTTPlan):
    """Multi-bit combiner in the split domain: sum over nonempty subsets
    S of prod_{i in S} (X^{t_i} - 1) * u_S.

    us: list of 2^g - 1 per-prime residue lists (subset mask m - 1),
    each int32 [B, 4, Nh] in the (component, parity) plane layout, |.| <=
    0.55p; ts: list of g int32 [B] in [0, 4*Nh).  Returns per-prime
    int32 [B, 2, 2, Nh], |.| <= 0.52p.

    Every operator here is multiplication by a polynomial f(X) =
    f_e(Y) + X f_o(Y), represented in the split NTT domain by the
    diagonal pair (x, y) = (f_e_hat, f_o_hat): products follow the
    Y-twisted rule (x1, y1)(x2, y2) = (x1 x2 + psi1 y1 y2,
    x1 y2 + y1 x2), and application to u = (u_e, u_o) is
    (x u_e + psi1 (y u_o), x u_o + y u_e).  X^t at t = 2u + r is
    (Y^u, 0) for r=0 and (0, Y^u) for r=1, so (X^t - 1) is
    (row_u - 1, 0) / (-1, row_u) — branchless in the parity bit.
    Subset pairs build by the same binary DP as the direct engine's
    rotate_combine_multi.

    Overflow accounting (worst prime cap 63000; barrett envelope
    p/2 + 384 = 31884, psi rows <= p/2 + 1): the DP x-product
    x1 x2 + psi1 * barrett(y1 y2) <= 31884^2 + 31501 * 31884 = 2.02e9 <
    2^31; the y-product x1 y2 + y1 x2 <= 2 * 31884^2 = 2.03e9; the apply
    x u_e + psi1 * barrett(y u_o) <= 31884 * 34650 + 31501 * 31884 =
    2.11e9 — all int32-safe with one inner barrett on the y-side
    products.  The <= 2^g - 1 reduced subset terms sum to at most
    (2^g - 1) * (p/2 + 384) <= 15 * 31884 ~ 2^18.9 at g=4 (~2^17.9 at
    the g<=3 configs) before one final barrett per output plane.
    """
    g = len(ts)
    Nh = plan.N
    t_all = [jnp.asarray(t) & jnp.int32(4 * Nh - 1) for t in ts]
    rs = [(t & 1) for t in t_all]
    rows_all = _rot_merged_rows(
        jnp.concatenate([t >> 1 for t in t_all]), plan)     # [gB, P*Nh]
    B = t_all[0].shape[0]
    outs = []
    for i, p in enumerate(plan.primes):
        psi1 = jnp.asarray(plan.rot[i][1].astype(np.int32))
        d = {}
        for j in range(g):
            row = rows_all[j * B:(j + 1) * B, i * Nh:(i + 1) * Nh]
            rj = rs[j][:, None]
            x = jnp.where(rj != 0, jnp.int32(-1), row - 1)
            y = jnp.where(rj != 0, row, jnp.int32(0))
            d[1 << j] = (x, y)                       # each [B, Nh]
        for m in range(1, 1 << g):
            if m & (m - 1):
                low = m & -m
                x1, y1 = d[m ^ low]
                x2, y2 = d[low]
                w = _ntt.barrett_reduce(y1 * y2, p)
                d[m] = (_ntt.barrett_reduce(x1 * x2 + psi1 * w, p),
                        _ntt.barrett_reduce(x1 * y2 + y1 * x2, p))
        ves, vos = [], []
        for m in range(1, 1 << g):
            v = us[m - 1][i].astype(jnp.int32)       # [B, 4, Nh]
            ue = v[..., 0::2, :]                     # [B, 2, Nh]
            uo = v[..., 1::2, :]
            x, y = d[m]
            xb, yb = x[:, None, :], y[:, None, :]
            we = _ntt.barrett_reduce(yb * uo, p)
            ves.append(_ntt.barrett_reduce(xb * ue + psi1 * we, p))
            vos.append(_ntt.barrett_reduce(xb * uo + yb * ue, p))
        acc_e = _ntt.barrett_reduce(sum(ves), p)
        acc_o = _ntt.barrett_reduce(sum(vos), p)
        outs.append(jnp.stack([acc_e, acc_o], axis=-2))      # [B, 2, 2, Nh]
    return outs


def gen_bootstrapping_key_ntt_split(key, values, sk_poly,
                                    params: SecurityParams,
                                    drop: int, group: int = 1, levels=None,
                                    bgbit: int | None = None):
    """Split-engine BSK in folded split-NTT form.

    values: the TRGSW plaintexts — s0 itself for group=1 ([n0]), or the
    subset products of g-bit key groups for group=g ([(2^g-1) * G],
    mask-major per group — key.py:gen_bootstrapping_key_ntt computes
    them).  Returns int16 [n0, P, 2R, 4, Nh] (group=1) or
    [G, 2^g-1, P, 2R, 4, Nh] (fold_key_split layout per key).

    Encryption itself runs in the full X-ring (the exact int64 Toeplitz
    product — keygen is off the hot path); only the NTT residues are
    computed half-wise on the Nh plan.
    """
    from zig_tfhe_jax import trgsw as _trgsw

    e = params.bgbit if bgbit is None else bgbit
    la, lb = _ntt.norm_levels(params, levels, bgbit=e)
    plan = _ntt.plan_for_params(params, drop, group, (la, lb), bgbit=e,
                                pseudorandom_key=True)
    trgsw_ct = _trgsw.encrypt_gadget_rows(
        key, values, params.bsk_alpha, sk_poly,
        params, e, la, lb)                           # [V, R, 2, N] int64
    halves = split(trgsw_ct)                         # [V, R, 2, 2, Nh]
    w = params.torus_bits
    res_e = _ntt.to_ntt_form(halves[..., 0, :], plan, drop, width=w)
    res_o = _ntt.to_ntt_form(halves[..., 1, :], plan, drop, width=w)
    folded = fold_key_split(res_e, res_o, plan)      # [V, P, 2R, 4, Nh]
    if group > 1:
        G = -(-params.n0 // group)
        return folded.reshape(G, (1 << group) - 1, plan.n_primes,
                              2 * (la + lb), 4, params.N // 2)
    return folded


# ---------------------------------------------------------------------------
# Hi-plane (pure-int32) scan: the 64-bit scan body without int64 emulation
# ---------------------------------------------------------------------------
#
# The 64-bit scan body's ELEMENTWISE work (decompose / CRT combine /
# accumulator update) is int64; a device that emulates s64 elementwise ops
# as pair-of-int32 carry chains pays for every one of them (whether this
# path pays on the GPU is not yet measured).  Observation: with the BSK rounded by drop >= 32 bits, every
# per-step delta is delta_true * 2^drop — a multiple of 2^32 — so the
# accumulator's LOW 32 bits never change across the scan.  When additionally
# every decomposition shift and offset bit sits at position >= 32 (true for
# both in-tree split gadgets: bg8 x (3,2) -> lowest touched bit 39, bg8 x
# (2,2) -> 47), the entire scan body is a function of the hi-32 planes only:
#
#   * decompose: the 64-bit (acc + offset) >> s at s >= 32 equals the
#     32-bit (acc_hi + (offset >> 32)) >> (s - 32) EXACTLY (the offset has
#     no bits below 32, so the low word contributes no carry);
#   * CRT combine: only delta mod 2^32 survives the << drop, so the
#     centered-exact CRT lift runs at width 32 (int32 muls — and the
#     drop >= 32 key bound shrinks the Hoeffding plan from five CRT primes
#     to FOUR: ~20% fewer matmul passes);
#   * accumulate: acc_hi += delta32 << (drop - 32), an int32 wrapping add.
#
# The scan carry is int32 [B, 2, 2, Nh]; the low word is re-attached once
# after the scan.  Bit-exact vs the generic int64 path at equal drop
# (asserted by tests/test_split_ring.py); ZTFHE_SPLIT_HI32=0 forces the
# generic path.  The noise price of drop=32 itself is negligible — key-
# rounding residuals accumulate to sigma ~2^-15 of the torus at
# SECURITY_128_BIT_T64 vs its 2^-9.4 key-switch floor (ops/ntt.py:
# default_drop_bits derivation).


def _hi32_offsets(params: SecurityParams, e: int, levels):
    """The full-width decomposition offsets _decompose_to_rows uses
    (center=True semantics of ops/decomposition.py:gadget_decompose),
    per component: (off_a, off_b) as Python ints mod 2^w."""
    from zig_tfhe_jax.ops.decomposition import gadget_offset

    w = params.torus_bits
    la, lb = levels

    def off_for(lv):
        if e == params.bgbit:
            off = params.decomposition_offset
            if lv == params.L and params.L * e < w:
                off = (off + (1 << (w - params.L * e - 1))) % (1 << w)
            return off
        return gadget_offset(e, w // e, w)

    return off_for(la), off_for(lb)


def _hi32_viable(params: SecurityParams, drop_bits: int, e: int,
                 levels) -> bool:
    """True when the scan can run entirely on int32 hi planes."""
    if params.torus_bits != 64 or drop_bits < 32:
        return False
    if os.environ.get("ZTFHE_SPLIT_HI32", "") in ("0", "false"):
        return False
    la, lb = levels
    if params.torus_bits - max(la, lb) * e < 32:
        return False        # a digit shift would read below bit 32
    off_a, off_b = _hi32_offsets(params, e, levels)
    # an offset bit below 32 would make the low word carry into the hi
    # plane (the engine-override branch at w//e levels has such bits)
    return off_a % (1 << 32) == 0 and off_b % (1 << 32) == 0


def _rows_hi32(acc_hi, params: SecurityParams, e: int, levels):
    """Hi-plane gadget decomposition: int32 [B, 2, 2, Nh] -> row-stacked
    digits int32 [B, 2R, Nh] ((r, q_in) row order, matching
    _decompose_to_rows + the fold_key_split layout).  Digit-exact vs the
    64-bit decomposition under the _hi32_viable conditions."""
    la, lb = levels
    off_a, off_b = _hi32_offsets(params, e, levels)
    mask = jnp.int32((1 << e) - 1)
    half = jnp.int32(1 << (e - 1))

    def digs(x, off, lv):
        tmp = x + jnp.int32(to_i32(off >> 32))
        return [(shift_right_logical(tmp, 32 - (i + 1) * e) & mask) - half
                for i in range(lv)]

    rows = digs(acc_hi[:, 0], off_a, la) + digs(acc_hi[:, 1], off_b, lb)
    r = jnp.stack(rows, axis=1)                  # [B, R, 2, Nh]
    return r.reshape(r.shape[0], 2 * (la + lb), r.shape[-1])


def blind_rotate_split(tlwe_batch, testvec, bsk_split,
                       params: SecurityParams, drop_bits: int,
                       unroll: int = 1, group: int = 1, levels=None,
                       bgbit: int | None = None,
                       tv_lo_zero: bool = False):
    """Blind rotation over the split ring (N > 1024, 64-bit torus).

    tlwe_batch: int64 [B, n0+1]; testvec: int64 [2, N] or [B, 2, N];
    bsk_split: int16 [n0, P, 2R, 4, Nh] (group=1) or
    [G, 2^g-1, P, 2R, 4, Nh] (multi-bit).  Returns int64 [B, 2, N].

    tv_lo_zero is a CALLER CONTRACT that every testvec coefficient's
    low 32 bits are zero (true for the gate path: the boolean encoding
    +-1/8 = +-2^61 sits entirely in the hi word, key.py:gen_testvec).
    With the hi-plane scan it skips the int64 initial rotation — the
    per-gate [B, 2, 2N]-gather runs on int32 hi planes (half the bytes)
    and the scan-invariant low word is the constant 0.  Traced values
    cannot be inspected, so the flag is static; a violating caller gets
    silently wrong low output bits (gates never read them, and only
    gate-path entry points set the flag).

    Per step: decompose (coefficient-wise — parity layout free), forward
    NTT of 2R half-rows, the folded pointwise contraction per subset,
    the parity-pair rotation combine, inverse + 64-bit CRT.  The initial
    X^(-b) testvec rotation runs in the coefficient domain (a per-batch
    gather): a full-torus NTT rotation needs |conv| <= 2^75 which misses
    the 74.8-bit pool by 0.2 bits (TORUS64.md §4) — once per gate it is
    ~1% of the n0-step scan.
    """
    e = params.bgbit if bgbit is None else bgbit
    if levels is None:
        levels = (bsk_split.shape[2] if group == 1
                  else bsk_split.shape[3]) // 4
    levels = _ntt.norm_levels(params, levels, bgbit=e)
    n_rows = levels[0] + levels[1]
    rows_ax = bsk_split.shape[2] if group == 1 else bsk_split.shape[3]
    assert 2 * n_rows == rows_ax, (levels, bsk_split.shape)
    plan = _ntt.plan_for_params(params, drop_bits, group, levels, bgbit=e,
                                pseudorandom_key=True)
    key_primes = bsk_split.shape[1] if group == 1 else bsk_split.shape[2]
    if key_primes != plan.n_primes:
        raise ValueError(
            f"split BSK holds {key_primes} CRT prime planes but "
            f"the current plan selects {plan.n_primes} — key and plan "
            "were built under different plan bounds")
    n0, N = params.n0, params.N
    Nh = N // 2
    assert plan.N == Nh, (plan.N, N)
    w = params.torus_bits
    B = tlwe_batch.shape[0]
    e_limbs = _ntt.engine_digit_limbs(e)
    dbound = _ntt.top_limb_bound(1 << (e - 1), e_limbs)

    b = tlwe_batch[..., n0]
    b_tilda = jnp.int32(2 * N) - modswitch(b, params)    # [B], [0, 2N]
    if testvec.ndim == 2:
        testvec = testvec[None]

    hi32 = _hi32_viable(params, drop_bits, e, levels)
    acc_lo = None
    if hi32 and tv_lo_zero:
        # gate-path fast start: the low word is identically zero, so the
        # once-per-gate initial rotation gathers int32 hi planes only
        tv_hi = jax.lax.shift_right_arithmetic(
            testvec, jnp.int64(32)).astype(jnp.int32)
        tv_hi = jnp.broadcast_to(tv_hi, (B, 2, N))
        acc = split(negacyclic_rotate(tv_hi, b_tilda))   # [B, 2, 2, Nh] i32
        acc_lo = jnp.zeros((B, 2, 2, Nh), jnp.int64)
    else:
        testvec = jnp.broadcast_to(testvec, (B, 2, N))
        acc_full = negacyclic_rotate(testvec, b_tilda)   # [B, 2, N]
        acc = split(acc_full)                            # [B, 2, 2, Nh]
        if hi32:
            # low word is scan-invariant (every delta is a multiple of
            # 2^32); carry only the hi-32 planes, as int32
            acc_lo = acc & jnp.int64(0xFFFFFFFF)         # [0, 2^32), int64
            acc = jax.lax.shift_right_arithmetic(
                acc, jnp.int64(32)).astype(jnp.int32)    # [B, 2, 2, Nh] i32

    # modswitch hoisted out of the scan: with hi32 the step body then
    # touches no int64 value at all
    t_cols = modswitch(jnp.swapaxes(tlwe_batch[..., :n0], 0, 1),
                       params)                           # [n0, B] int32

    def fwd(acc):
        if hi32:
            rows = _rows_hi32(acc, params, e, levels)    # [B, 2R, Nh]
        else:
            rows = _decompose_to_rows(acc.reshape(B, 2, N), params, levels,
                                      bgbit=e)           # [B, R, N]
            rows = rows.reshape(B, n_rows * 2, Nh)       # (r, q_in) rows
        return _ntt.ntt_forward(rows, plan, e_limbs, dbound)

    def finish(acc, v):
        if hi32:
            delta = _ntt.ntt_inverse_to_crt(v, plan, 32)  # conv mod 2^32
            if drop_bits > 32:
                delta = jax.lax.shift_left(delta, jnp.int32(drop_bits - 32))
            return acc + delta
        delta = _ntt.ntt_inverse_to_crt(v, plan, w)      # int64
        if drop_bits:
            delta = jax.lax.shift_left(delta, jnp.asarray(drop_bits,
                                                          delta.dtype))
        return acc + delta

    def reattach(acc):
        if hi32:
            acc = jax.lax.shift_left(acc.astype(jnp.int64),
                                     jnp.int64(32)) + acc_lo
        return unsplit(acc)                              # [B, 2, N]

    if group == 1:
        def step(acc, xs):
            bsk_i, t = xs                  # [P, 2R, 4, Nh], [B] in [0, 2N]
            u = _ntt.pointwise_extprod(fwd(acc), bsk_i, plan)
            v = rotate_minus1_split(u, t, plan)          # [B, 2, 2, Nh]
            return finish(acc, v), None

        acc, _ = jax.lax.scan(step, acc, (bsk_split, t_cols), unroll=unroll)
        return reattach(acc)

    G = bsk_split.shape[0]
    if t_cols.shape[0] < group * G:                      # ragged n0 padding
        # t=0 == modswitch(a=0) (the identity rotation), matching the
        # pre-hoist behavior; the padded BSK slots are TRGSW(0) no-ops
        t_cols = jnp.concatenate(
            [t_cols, jnp.zeros((group * G - n0, B), t_cols.dtype)])
    t_grps = t_cols.reshape(G, group, B)

    def step_multi(acc, xs):
        bsk_g, t_grp = xs          # [2^g-1, P, 2R, 4, Nh], [g, B]
        ts = [t_grp[j] for j in range(group)]
        d_hat = fwd(acc)
        us = [_ntt.pointwise_extprod(d_hat, bsk_g[m], plan)
              for m in range((1 << group) - 1)]
        v = rotate_combine_multi_split(us, ts, plan)
        return finish(acc, v), None

    acc, _ = jax.lax.scan(step_multi, acc, (bsk_split, t_grps),
                          unroll=unroll)
    return reattach(acc)
