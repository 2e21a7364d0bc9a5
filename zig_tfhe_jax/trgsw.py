"""TRGSW gadget ciphertexts and their matmul-ready form.

A TRGSW ciphertext is int32 ``[..., 2L, 2, N]`` — 2L TRLWE rows
(trgsw.zig:16-72).  Row i has p*Bg^-(i+1) added to a[0]; row i+L has it added
to b[0].

Where the reference converts TRGSW rows to the f64 FFT domain
(TRGSWLv1FFT, trgsw.zig:75-105), this framework converts them to the
**negacyclic-extension int8-limb form** consumed by the matmul external
product: ``ext_limbs`` of shape ``[..., n_klimbs, 2L, 2, 2N] int8`` where
ext = [p, -p] and limbs are the signed 8-bit recode of ops/poly.py.  This is
the exact-arithmetic analog of the FFT-domain bootstrapping key.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import trlwe as _trlwe
from zig_tfhe_jax.params import SecurityParams
from zig_tfhe_jax.ops.poly import negacyclic_extend
from zig_tfhe_jax.utils.torus import i32_to_i8_limbs, to_i32

N_KLIMBS = 4  # full 32-bit torus => 4 signed 8-bit limbs


def gadget_scales(bgbit: int, count: int, width: int = 32) -> np.ndarray:
    """h_i = torus(Bg^-(i+1)) = 2^(width-(i+1)*bgbit), carrier [count]."""
    from zig_tfhe_jax.utils.torus import to_carrier

    dtype = np.int32 if width == 32 else np.int64
    return np.array(
        [to_carrier(1 << (width - (i + 1) * bgbit), width)
         if (i + 1) * bgbit < width
         else 1 if (i + 1) * bgbit == width else 0
         for i in range(count)],
        dtype=dtype,
    )


def gadget_values(params: SecurityParams) -> np.ndarray:
    """Parameter-set gadget: gadget_scales(params.bgbit, params.L)."""
    return gadget_scales(params.bgbit, params.L)


def encrypt_torus(key, p, alpha: float, sk_poly, params: SecurityParams):
    """TRGSW-encrypt small integers ``p`` (int32 [...]) (trgsw.zig:35-71).

    Returns int32 [..., 2L, 2, N].
    """
    p = jnp.asarray(p, jnp.int32)
    N = params.N
    L = params.L
    batch = p.shape
    # one batched zero-encrypt over the 2L rows (trlwe.encrypt_torus takes
    # arbitrary batch dims; a per-row Python loop would emit 2L separate
    # encrypt subgraphs inside the jitted keygen)
    zeros = jnp.zeros(batch + (2 * L, N), jnp.int32)
    ct = _trlwe.encrypt_torus(key, zeros, alpha, sk_poly)  # [..., 2L, 2, N]
    h = jnp.asarray(gadget_values(params))  # [L]
    add = p[..., None] * h  # [..., L]
    # rows 0..L-1: a[0] += p*h_i ; rows L..2L-1: b[0] += p*h_i
    ct = ct.at[..., 0:L, _trlwe.A, 0].add(add)
    ct = ct.at[..., L:2 * L, _trlwe.B, 0].add(add)
    return ct


def encrypt_gadget_rows(key, p, alpha: float, sk_poly,
                        params: SecurityParams, bgbit: int, la: int, lb: int):
    """TRGSW-style gadget rows with an ENGINE gadget base.

    Returns int32 [..., la+lb, 2, N]: rows 0..la-1 are TRLWE(p * Bg_e^-(i+1))
    added into a[0], rows la..la+lb-1 into b[0], Bg_e = 2^bgbit.  This is
    the generalization of encrypt_torus (trgsw.zig:16-72) to a gadget base
    chosen by the NTT engine rather than the parameter set
    (ops/ntt.py:default_engine_gadget): the BSK freshly encrypts the lv0
    key bits, so the gadget inside the bootstrap is an implementation
    detail — each row is an ordinary TRLWE encryption under the SAME
    security assumption, only the public scaling constants differ.
    """
    w = params.torus_bits
    p = jnp.asarray(p, jnp.int32)
    zeros = jnp.zeros(p.shape + (la + lb, params.N),
                      jnp.int32 if w == 32 else jnp.int64)
    ct = _trlwe.encrypt_torus(key, zeros, alpha, sk_poly,
                              width=w)              # [..., la+lb, 2, N]
    h = gadget_scales(bgbit, max(la, lb), w)
    if la:
        ct = ct.at[..., 0:la, _trlwe.A, 0].add(p[..., None] * jnp.asarray(h[:la]))
    if lb:
        ct = ct.at[..., la:la + lb, _trlwe.B, 0].add(
            p[..., None] * jnp.asarray(h[:lb]))
    return ct


def to_ext_limbs(trgsw_ct, n_klimbs: int = N_KLIMBS):
    """TRGSW int32 [..., 2L, 2, N] -> int8 [..., n_klimbs, 2L, 2, 2N].

    The analog of TRGSWLv1FFT.new (trgsw.zig:81-91): the static operand of
    every external product, pre-recoded so the per-CMux work is only the
    Toeplitz roll-build + int8 matmuls.

    n_klimbs < 4 trades key precision for matmul passes: the value is
    rounded to its top 8*n_klimbs bits (limb shifts then start at
    8*(4-n_klimbs); ops/blind_rotate reads the drop from the limb count).
    Dropping one limb adds ~2^17-rms noise per external product at 128-bit
    — well under the decryption margin (validated by gate tests) — and cuts
    the CMux matmul work by 25%.
    """
    drop = N_KLIMBS - n_klimbs
    ext = negacyclic_extend(trgsw_ct)  # [..., 2L, 2, 2N]
    if drop:
        half = jnp.int32(1 << (8 * drop - 1))
        ext = jax.lax.shift_right_arithmetic(ext + half, jnp.int32(8 * drop))
    limbs = i32_to_i8_limbs(ext, n_klimbs)  # [..., 2L, 2, 2N, n_klimbs]
    return jnp.moveaxis(limbs, -1, -4)


def dummy_ext_limbs(params: SecurityParams, batch=()):
    """All-zero ext-limb TRGSW (TRGSWLv1FFT.newDummy, trgsw.zig:94-105)."""
    return jnp.zeros(batch + (N_KLIMBS, 2 * params.L, 2, 2 * params.N), jnp.int8)
