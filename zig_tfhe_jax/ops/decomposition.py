"""Gadget and key-switch digit decomposition as vectorized int32 ops.

Gadget decomposition (trgsw.zig:193-219): add the decomposition offset
(key.zig:121-131), then extract L signed base-Bg digits from the top bits:

    tmp    = x + offset                       (wrapping)
    dig_i  = ((tmp >>u (32-(i+1)*bgbit)) & (Bg-1)) - Bg/2   in [-Bg/2, Bg/2)

Key-switch decomposition uses the same digit-extraction with the reference's
rounding offset 2^(32-(1+basebit*t)) (trgsw.zig:483) PLUS a balancing offset
(params.ks_balance_offset) so digits come out signed — enabling the
one-matmul key switch (see ops/keyswitch.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from zig_tfhe_jax.params import SecurityParams
from zig_tfhe_jax.utils.torus import (shift_right_logical, to_carrier,
                                      to_i32)


def gadget_offset(bgbit: int, n_terms: int, width: int = 32) -> int:
    """sum_{i=1..n_terms} (Bg/2) * 2^(width - i*bgbit), mod 2^width.

    The reference's offset (key.zig:121-131) is this with n_terms = L at
    width 32.  ENGINE gadgets (a base chosen by the NTT engine, decoupled
    from the parameter set — ops/ntt.py:default_engine_gadget) use
    n_terms = floor(width/bgbit) so the truncation remainder at ANY kept
    level count stays centered.
    """
    off, half = 0, 1 << (bgbit - 1)
    for i in range(n_terms):
        sh = width - (i + 1) * bgbit
        if sh < 0:
            break
        off = (off + half * (1 << sh)) % (1 << width)
    return off


def gadget_decompose(x, params: SecurityParams, level_axis: int = -1,
                     levels: int | None = None, bgbit: int | None = None,
                     center: bool = False):
    """Signed gadget digits of torus values.

    x: int32 [...]; returns int32 [..., L] (level_axis=-1, default) or the
    digits stacked on another axis (level_axis=-2 gives [..., L, last] with
    NO relayout of the trailing axis — the layout the NTT engine wants).
    Digits are in [-Bg/2, Bg/2).  Matches decompositionIntoStorage
    (trgsw.zig:193-219) digit-for-digit (the reference stores digits as
    wrapped u32; values are identical mod 2^32 and small, so our signed
    form is the same integer).

    levels < L selects APPROXIMATE decomposition: only the top ``levels``
    digits are produced, truncating x to levels*bgbit bits.  The standard
    L-level offset (params.decomposition_offset) already centers the
    truncation remainder: its dropped terms sum to ~2^(32-levels*bgbit-1),
    so the remainder is ~uniform in ±2^(32-levels*bgbit-1) (docs/NOISE.md
    §6 gives the noise budget).  No reference analog (the reference always
    uses all L levels); this is the classic TFHE approximate-gadget trick.

    bgbit overrides the decomposition base (ENGINE gadget — the NTT BSK's
    gadget is an implementation detail decoupled from the parameter set;
    ops/ntt.py:default_engine_gadget).  The offset then uses all
    floor(32/bgbit) terms so the remainder is centered at every level
    count; levels may range up to floor(32/bgbit).

    center=True CENTERS the truncation remainder in the one case the
    offsets above leave it biased: the parameter-base gadget at the full
    L levels with L*bgbit < torus_bits.  There the reference-parity
    offset (L terms, every one a multiple of the kept grid
    2^(w - L*bgbit)) makes the reconstruction a plain floor — remainder
    uniform in [0, grid), mean grid/2.  That bias, amplified by the
    a-component's key convolution (~(N/2) ones), is ~2^-10 of the torus
    at the 32-bit uint sets (invisible under their margins) but 2^-7 at
    the 64-bit N=2048 sets — it visibly ate the single-shot LUT margin
    (caught by the m=64 split-set LUT test).  The extra half-grid term
    turns the floor into round-to-nearest, matching the centering the
    engine-override and levels<L branches already have.  Default False:
    digit-for-digit reference parity (trgsw.zig:193-219).  The engine
    paths (ops/blind_rotate.py:_decompose_to_rows) pass True.
    """
    w = params.torus_bits
    if bgbit is None or bgbit == params.bgbit:
        bgbit, L = params.bgbit, params.L
        offset = params.decomposition_offset
        if center and levels in (None, L) and L * bgbit < w:
            offset = (offset + (1 << (w - L * bgbit - 1))) % (1 << w)
    else:
        L = w // bgbit
        offset = gadget_offset(bgbit, L, w)
    levels = L if levels is None else levels
    assert 1 <= levels <= L, (levels, L)
    mask = (1 << bgbit) - 1
    half = 1 << (bgbit - 1)
    tmp = x + to_carrier(offset, w)
    digs = []
    for i in range(levels):
        sh = w - (i + 1) * bgbit
        d = (shift_right_logical(tmp, sh) & mask) - half
        # digits are tiny (|.| < Bg/2); keep them int32 so the downstream
        # int8-limb split / matmuls are width-independent
        digs.append(d.astype(jnp.int32))
    return jnp.stack(digs, axis=level_axis)


def ks_decompose(a, basebit: int, t: int, width: int = 32):
    """Signed key-switch digits.

    a: carrier [...] at ``width``; returns int32 [..., t] with digits in
    [-B/2, B/2).  Reconstruction
    sum_j d_j * 2^(width-(j+1)*basebit) == a + prec_offset - eps,
    eps in [0, 2^(width-basebit*t)), i.e. a rounded to basebit*t bits — the
    same rounding the reference's unsigned decomposition achieves
    (trgsw.zig:483-499), with digits balanced instead of in [0, B).
    """
    mask = (1 << basebit) - 1
    half = 1 << (basebit - 1)
    prec = 1 << (width - (1 + basebit * t))
    balance = 0
    for j in range(t):
        balance += (1 << (basebit - 1)) * (1 << (width - (j + 1) * basebit))
    a_bar = a + to_carrier((prec + balance) % (1 << width), width)
    digs = []
    for j in range(t):
        sh = width - (j + 1) * basebit
        digs.append(((shift_right_logical(a_bar, sh) & mask)
                     - half).astype(jnp.int32))
    return jnp.stack(digs, axis=-1)
