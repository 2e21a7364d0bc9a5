"""External product, CMux, and blind rotation — the TFHE hot loop.

Reference pipeline per gate (trgsw.zig:290-333): a sequential loop of n0
CMuxes, each doing 6 forward f64 FFTs + 12 complex MACs + 2 inverse FFTs.
~99% of gate time.  The loop over i is inherently sequential (data
dependence), so all throughput comes from **batching over gates**:

  - ciphertexts are ``[B, ...]`` arrays; the CMux becomes one big int8
    matmul ``[B, 2L*N] @ [2L*N, 2*N]`` per key limb;
  - the loop over the n0 LWE coefficients is a ``lax.scan`` whose xs stream
    the bootstrapping key (in negacyclic-extension int8-limb form) from
    device memory;
  - the per-step Toeplitz operand is built on the fly by a static gather
    (ops/poly.py:toeplitz_from_ext), keeping the key compact
    (n0 * 4 * 2L * 2 * 2N int8 ~ 69 MB at 128-bit vs ~34 GB if the circulant
    matrices were materialized).

All arithmetic is EXACT mod 2^32 (no FFT rounding noise at all).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

import os

from zig_tfhe_jax.ops.decomposition import gadget_decompose
from zig_tfhe_jax.ops.poly import matmul_i8, negacyclic_rotate, toeplitz_from_ext
from zig_tfhe_jax.params import SecurityParams
from zig_tfhe_jax.trgsw import N_KLIMBS
from zig_tfhe_jax.utils.torus import i32_to_i8_limbs, shift_right_logical


def default_engine() -> str:
    """'ntt' (matmul NTT engine — fastest and exact) on every backend.

    Override with ZTFHE_ENGINE=ntt|xla ('xla' is the Toeplitz-circulant
    engine, kept as the test oracle).
    """
    return os.environ.get("ZTFHE_ENGINE") or "ntt"


def _decompose_to_rows(ct, params: SecurityParams, levels=None,
                       bgbit: int | None = None):
    """[..., 2, N] -> signed digit rows [..., la+lb, N] (a-levels then
    b-levels).

    Matches decompositionIntoStorage row order (trgsw.zig:193-219).  Digits
    are stacked level-major directly (no N-axis transpose — the moveaxis
    relayout was a measurable per-step cost at blind-rotate batch sizes).
    levels may be an int (symmetric, < L is the approximate-gadget fast
    path) or an (a_levels, b_levels) tuple (asymmetric: the a-component's
    truncation is key-convolution-amplified, so it keeps more levels —
    ops/ntt.py:norm_levels).  bgbit overrides the decomposition base
    (ENGINE gadget, ops/ntt.py:default_engine_gadget)."""
    from zig_tfhe_jax.ops.ntt import norm_levels

    la, lb = norm_levels(params, levels, bgbit=bgbit)
    if la == lb:
        digs = gadget_decompose(ct, params, level_axis=-2, levels=la,
                                bgbit=bgbit, center=True)
        sh = digs.shape
        return digs.reshape(sh[:-3] + (2 * la, params.N))
    da = gadget_decompose(ct[..., 0, :], params, level_axis=-2, levels=la,
                          bgbit=bgbit, center=True)
    db = gadget_decompose(ct[..., 1, :], params, level_axis=-2, levels=lb,
                          bgbit=bgbit, center=True)
    return jnp.concatenate([da, db], axis=-2)      # [..., la+lb, N]


def _trgsw_matrices(ext_limbs, params: SecurityParams):
    """ext-limb TRGSW [n_klimbs, 2L, 2, 2N] -> matmul operands
    [n_klimbs, 2L*N, 2*N] int8 (the negacyclic circulant per row/component).
    """
    T = toeplitz_from_ext(ext_limbs)               # [kl, 2L, 2, N(k), N(n)]
    T = jnp.moveaxis(T, -2, -3)                    # [kl, 2L, N(k), 2, N(n)]
    kl = T.shape[0]
    return T.reshape(kl, 2 * params.L * params.N, 2 * params.N)


def external_product(ext_limbs, ct, params: SecurityParams):
    """TRGSW (ext-limb form) x TRLWE batch -> TRLWE batch, exact mod 2^32.

    ext_limbs: int8 [n_klimbs, 2L, 2, 2N] (shared across the batch)
    ct:        int32 [..., 2, N]
    Mirrors externalProductWithFft (trgsw.zig:111-154) with matmuls in place
    of FFT/MAC/IFFT.
    """
    mats = _trgsw_matrices(ext_limbs, params)
    return _external_product_from_mats(mats, ct, params)


def _external_product_from_mats(mats, ct, params: SecurityParams):
    N, L = params.N, params.L
    n_dl = params.digit_limbs
    n_kl = mats.shape[0]
    drop = N_KLIMBS - n_kl  # key limbs below 8*drop bits were rounded away
    rows = _decompose_to_rows(ct, params)          # [..., 2L, N]
    batch = rows.shape[:-2]
    d = rows.reshape(batch + (2 * L * N,))
    d_limbs = i32_to_i8_limbs(d, n_dl)             # [..., 2L*N, n_dl]
    out = jnp.zeros(batch + (2 * N,), jnp.int32)
    for dl in range(n_dl):
        for kl in range(n_kl):
            sh = 8 * (dl + kl + drop)
            if sh >= 32:
                continue
            part = matmul_i8(d_limbs[..., dl], mats[kl])
            out = out + jax.lax.shift_left(part, jnp.int32(sh))
    return out.reshape(batch + (2, N))


def cmux(ext_limbs, ct0, ct1, params: SecurityParams):
    """ct0 + ExtProd(cond, ct1 - ct0): cond==0 -> ct0, cond==1 -> ct1
    (trgsw.zig:260-284)."""
    return ct0 + external_product(ext_limbs, ct1 - ct0, params)


def modswitch(x, params: SecurityParams):
    """Torus carrier -> [0, 2N] rotation amount, int32 (trgsw.zig:297,312).

    (x + 2^(w-nbit-2)) >>u (w-nbit-1), w = torus_bits.  Carrier wrap at
    the add maps 2N -> 0, which is the same rotation mod 2N.  The result
    is a tiny index, returned int32 at every width.
    """
    from zig_tfhe_jax.utils.torus import to_carrier

    w = params.torus_bits
    nbit = params.nbit
    rounded = x + to_carrier(1 << (w - nbit - 2), w)
    return shift_right_logical(rounded, w - nbit - 1).astype(jnp.int32)


def blind_rotate(tlwe_batch, testvec, ck, params: SecurityParams,
                 unroll: int | None = None, engine: str | None = None,
                 tv_lo_zero: bool = False):
    """Blind rotation of a batch of TLWE lv0 ciphertexts.

    tlwe_batch: int32 [B, n0+1]
    testvec:    int32 [2, N] (shared) or [B, 2, N] (per-gate, for PBS)
    ck:         CloudKey (the engine picks its key form: bsk_ntt for 'ntt',
                bsk_ext_limbs for 'xla')
    Returns int32 [B, 2, N].

    Semantics match blindRotate / blindRotateWithTestvec
    (trgsw.zig:290-400): rotate the testvec by -b (mod X^N+1), then fold in
    each LWE coefficient with a CMux against BSK[i].

    tv_lo_zero (STATIC): caller asserts every testvec coefficient's low
    32 bits are zero — the split engine's hi-plane scan then skips the
    int64 initial rotation (ops/split_ring.py).  Set only by the gate
    bootstrap entry points (the +-1/8 testvec); ignored off the split
    path.
    """
    from zig_tfhe_jax.utils.torus import carrier_dtype

    want_dt = carrier_dtype(params.torus_bits)
    if tlwe_batch.dtype != want_dt:
        # a width-mismatched ciphertext would silently modswitch garbage
        # (caught live: int32 bits fed to a 64-bit set decrypted "1" with
        # no error); fail loudly at the pipeline chokepoint instead
        raise TypeError(
            f"ciphertext dtype {tlwe_batch.dtype} does not match the "
            f"{params.torus_bits}-bit torus carrier {np.dtype(want_dt)} — "
            f"encrypt with width={params.torus_bits}")
    lead = tlwe_batch.shape[:-1]
    if len(lead) != 1:
        # arbitrary leading batch dims (e.g. [W, B, n0+1] serving batches):
        # flatten for the engines' flat-[B] scan, restore on the way out
        flat = tlwe_batch.reshape((-1,) + tlwe_batch.shape[-1:])
        tv = testvec
        if tv.ndim == len(lead) + 2:           # per-lane testvecs
            tv = tv.reshape((-1,) + tv.shape[-2:])
        out = blind_rotate(flat, tv, ck, params, unroll=unroll, engine=engine,
                           tv_lo_zero=tv_lo_zero)
        return out.reshape(lead + out.shape[-2:])
    explicit = engine is not None or bool(os.environ.get("ZTFHE_ENGINE"))
    engine = engine or default_engine()
    if engine not in ("ntt", "xla"):
        raise ValueError(f"unknown blind-rotation engine {engine!r}: use "
                         "'ntt' or 'xla'")
    if unroll is None:
        try:
            unroll = int(os.environ.get("ZTFHE_UNROLL", "1"))
        except ValueError:
            unroll = 1
    if (engine == "ntt" and ck.bsk_ntt is None
            and ck.bsk_ext_limbs is not None and not explicit):
        engine = "xla"      # e.g. a cloud key saved by an older version
    # real exceptions (not asserts): an explicitly requested engine whose
    # key form is missing must fail loudly, including under python -O
    if engine == "ntt":
        from zig_tfhe_jax.ops.blind_rotate_ntt import blind_rotate_ntt
        if ck.bsk_ntt is None:
            raise ValueError(
                "engine 'ntt' requested but CloudKey lacks bsk_ntt "
                "(generate with engines=('ntt', ...))")
        return blind_rotate_ntt(tlwe_batch, testvec, ck.bsk_ntt, params,
                                ck.bsk_ntt_drop, unroll=unroll,
                                group=ck.bsk_group, levels=ck.bsk_levels,
                                bgbit=getattr(ck, "bsk_bgbit", None),
                                tv_lo_zero=tv_lo_zero)
    if ck.bsk_ext_limbs is None:
        raise ValueError(
            f"engine '{engine}' requested but CloudKey lacks bsk_ext_limbs "
            "(generate with engines=('toeplitz', ...))")
    return blind_rotate_toeplitz(tlwe_batch, testvec, ck.bsk_ext_limbs,
                                 params, unroll=unroll)


def blind_rotate_toeplitz(tlwe_batch, testvec, bsk_ext_limbs,
                          params: SecurityParams, unroll: int = 1):
    """Toeplitz-circulant blind rotation (per-step operand build)."""
    n0 = params.n0
    B = tlwe_batch.shape[0]
    b = tlwe_batch[..., n0]
    b_tilda = jnp.int32(2 * params.N) - modswitch(b, params)
    if testvec.ndim == 2:
        testvec = jnp.broadcast_to(testvec, (B,) + testvec.shape)
    acc = negacyclic_rotate(testvec, b_tilda)

    a_cols = jnp.swapaxes(tlwe_batch[..., :n0], 0, 1)  # [n0, B]

    def step(acc, xs):
        bsk_i, a_col = xs
        a_tilda = modswitch(a_col, params)             # [B]
        rotated = negacyclic_rotate(acc, a_tilda)
        diff = rotated - acc
        mats = _trgsw_matrices(bsk_i, params)
        acc = acc + _external_product_from_mats(mats, diff, params)
        return acc, None

    acc, _ = jax.lax.scan(step, acc, (bsk_ext_limbs, a_cols), unroll=unroll)
    return acc
