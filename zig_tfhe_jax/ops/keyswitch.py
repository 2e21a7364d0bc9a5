"""Identity key switching as a single integer matmul.

The reference key switch (trgsw.zig:471-502) walks 1024 coefficients x t
levels, gathers one of 2^basebit precomputed KSK entries per nonzero digit,
and subtracts it — a scalar, branchy loop.  Batched redesign:

  * decompose all digits SIGNED in [-B/2, B/2) (ops/decomposition.py), so
    the per-digit contribution is ``digit * KSK1[i, j]`` where KSK1[i, j]
    encrypts s1[i] * 2^(32-(j+1)*basebit) — linear in the digit;
  * the whole key switch is then ``out = (0..,b) - D @ KSK1`` with
    D int8 [B, N1*t] and KSK1 int32 [N1*t, n0+1], run exactly via int8-limb
    matmuls (ops/poly.py:small_matmul_torus).

Noise: variance sum E[d^2] * sigma_ksk^2 with E[d^2] <= (B/2)^2 * ...;
for basebit=2 this is 1.5*t*N*sigma^2 vs the reference's 0.75*t*N*sigma^2 —
a 2x variance increase, orders of magnitude under the 1/16 decryption
margin (verified by the gate truth-table tests).

The same kernel implements LWE proxy re-encryption (proxy_reenc.zig:267-306),
which is a key switch keyed by a re-encryption key.
"""

from __future__ import annotations


import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax.ops.decomposition import ks_decompose
from zig_tfhe_jax.ops.poly import small_matmul_torus
from zig_tfhe_jax.params import SecurityParams
from zig_tfhe_jax.utils.torus import to_i32


def ks_plaintexts(key_from, basebit: int, t: int, width: int = 32):
    """[n, t] plaintexts ``key_from[i] * 2^(width-(j+1)*basebit)``.

    This is the row encoding every key-switch-style key must match (row
    i*t+j of the KSK / proxy re-encryption key encrypts this value); it is
    defined once here, next to the kernel that consumes it.
    """
    from zig_tfhe_jax.utils.torus import to_carrier

    dtype = np.int32 if width == 32 else np.int64
    shifts = np.array([to_carrier(1 << (width - (j + 1) * basebit), width)
                       for j in range(t)], dtype=dtype)
    return key_from.astype(dtype)[:, None] * jnp.asarray(shifts)[None, :]


def key_switch_matmul(ct, ksk1, basebit: int, t: int, width: int = 32):
    """Generic digit-decompose + matmul key switch.

    ct:   carrier [..., n_from+1]
    ksk1: carrier [n_from*t, n_to+1]  row (i*t + j) encrypts
          key_from[i] * 2^(width-(j+1)*basebit) under key_to.
    Returns carrier [..., n_to+1].

    Both widths run the int8-limb matmul form (small_matmul_torus):
    width=64 contracts the digits against 8 int8 key limbs and combines
    mod 2^64 (digit partials stay far inside int32 — poly.py documents
    the overflow contract).
    """
    n_from = ct.shape[-1] - 1
    half_base = 1 << (basebit - 1)
    digits = ks_decompose(ct[..., :n_from], basebit, t,
                          width)                          # [..., n_from, t]
    d = digits.reshape(digits.shape[:-2] + (n_from * t,))
    sub = small_matmul_torus(d, ksk1, half_base, width)   # [..., n_to+1]
    n_to = ksk1.shape[-1] - 1
    out = -sub
    out = out.at[..., n_to].add(ct[..., n_from])
    return out


def identity_key_switch(tlwe_lv1, ksk1, params: SecurityParams):
    """TLWE lv1 -> lv0 under the lv0 key (trgsw.zig:471-502 semantics)."""
    return key_switch_matmul(tlwe_lv1, ksk1, params.basebit, params.iks_t,
                             params.torus_bits)
