"""Exact negacyclic polynomial arithmetic as integer matmuls.

The reference's keystone is a Klemsa negacyclic f64 FFT (fft.zig, 1015 LoC)
feeding complex pointwise MACs (trgsw.zig:157-189).  That design targets CPU
SIMD; an f32 FFT's error (~2^23 ulps on 2^47-magnitude products) would
destroy decryption.  We therefore take a different route: negacyclic
convolution as **matrix multiplication in signed int8 limbs** with int32
accumulation on the integer matmul path.  Results are
EXACT mod 2^32 — strictly less noise than the reference's FFT rounding.

Negacyclic convolution (X^N = -1):
    out[n] = sum_{k+j == n} a[k] b[j] - sum_{k+j == n+N} a[k] b[j]  (mod 2^32)
With ext(b) = [b, -b] (length 2N):
    out[n] = sum_k a[k] * ext(b)[(n - k) mod 2N]
i.e. ``out = a @ T(b)`` where T(b)[k, n] = ext(b)[(n - k) mod 2N] is the
negacyclic circulant of b.  T is built by a single static-index gather, and
all products run as int8 x int8 -> int32 matmuls with both operands recoded
into signed 8-bit limbs (utils/torus.py:i32_to_i8_limbs); limb pairs whose
combined shift is >= 32 vanish mod 2^32 and are skipped.

Oracle: ``negacyclic_polymul_naive`` is the O(N^2) schoolbook used by tests,
mirroring the reference's oracle pattern (fft.zig:695-714).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax.utils.torus import i32_to_i8_limbs, i8_limbs_combine


@functools.lru_cache(maxsize=None)
def _toeplitz_index(N: int) -> np.ndarray:
    """Static gather index: IDX[k, n] = (n - k) mod 2N, shape [N, N]."""
    n = np.arange(N)[None, :]
    k = np.arange(N)[:, None]
    return ((n - k) % (2 * N)).astype(np.int32)


def negacyclic_extend(p):
    """[..., N] -> [..., 2N] with ext = [p, -p]."""
    return jnp.concatenate([p, -p], axis=-1)


def toeplitz(p):
    """Negacyclic circulant T(p)[..., k, n] = ext(p)[..., (n-k) mod 2N].

    ``a @ T(p)`` computes the negacyclic product a*p.
    """
    return toeplitz_from_ext(negacyclic_extend(p))


def toeplitz_from_ext(ext):
    """Toeplitz build from a [..., 2N] extension by log2(N) doubling rolls.

    Row k of the circulant is roll(ext, k); rows [s, 2s) are rows [0, s)
    rolled by s, so the whole [N, 2N] stack builds in log2(N) concat+roll
    doublings: each roll is two slices + a concat, plain streaming data
    movement, where the obvious one-gather construction (take with an
    [N, N] index matrix) gathers every element by index.
    """
    N = ext.shape[-1] // 2
    rows = ext[..., None, :]  # [..., 1, 2N]
    s = 1
    while s < N:
        rows = jnp.concatenate([rows, jnp.roll(rows, s, axis=-1)], axis=-2)
        s *= 2
    return rows[..., :N]


def toeplitz_gather_reference(ext):
    """One-gather Toeplitz (reference implementation for tests)."""
    N = ext.shape[-1] // 2
    return jnp.take(ext, jnp.asarray(_toeplitz_index(N)), axis=-1)


def _limb_count_for_bound(bound: int) -> int:
    """Signed int8 limbs needed to represent values in [-bound, bound]."""
    k = 1
    while not (-(1 << (8 * k - 1)) <= -bound and bound < (1 << (8 * k - 1))):
        k += 1
    return k


def matmul_i8(a_i8, b_i8):
    """int8 x int8 -> int32 matmul."""
    return jax.lax.dot_general(
        a_i8, b_i8,
        dimension_numbers=(((a_i8.ndim - 1,), (b_i8.ndim - 2,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def small_matmul_torus(small, torus_mat, small_bound: int, width: int = 32):
    """Exact ``small @ torus_mat`` mod 2^width via int8 limb matmuls.

    small:     carrier [..., K] with |values| <= small_bound
    torus_mat: carrier [K, M] full-range torus values at ``width``
    Returns carrier [..., M], exact mod 2^width.

    Overflow contract: each int8 x int8 partial accumulates in int32, so
    K * min(small_bound, 127) * 127 must stay < 2^31 — true for every
    key-switch shape in-tree (worst: K = N1*iks_t = 12288 at 127-bound
    digit limbs -> 2e8).  width=64 uses 8 key limbs: every 64-bit
    contraction stays an s8 x s8 -> s32 dot.
    """
    n_dl = _limb_count_for_bound(small_bound)
    n_kl = width // 8
    d_limbs = i32_to_i8_limbs(small, n_dl)      # [..., K, n_dl]
    k_limbs = i32_to_i8_limbs(torus_mat, n_kl)  # [K, M, n_kl]
    parts, shifts = [], []
    for dl in range(n_dl):
        for kl in range(n_kl):
            sh = 8 * (dl + kl)
            if sh >= width:
                continue  # vanishes mod 2^width
            parts.append(matmul_i8(d_limbs[..., dl], k_limbs[..., kl]))
            shifts.append(sh)
    return i8_limbs_combine(parts, shifts, width)


def negacyclic_polymul(a, b, a_bound: int):
    """Exact negacyclic product of int32 polys, |a| <= a_bound, b full torus.

    a: [..., N] (arbitrary batch dims); b: [N], ONE polynomial shared
    across a's batch (its Toeplitz operand is built once).  For per-batch
    b there is no shared operand to amortize — map over b with the NTT
    engine (ops/ntt.py) or call this per polynomial.
    """
    assert b.ndim == 1, "b must be a single shared [N] polynomial"
    return small_matmul_torus(a, toeplitz(b), a_bound)


def negacyclic_polymul_binary(a_torus, s_binary):
    """Exact a * s for binary s in {0,1}.

    int32 carriers: products are a*1 or 0, so multiply-accumulate at the
    carrier width with natural two's-complement wrap is exact mod 2^32 —
    one plain matmul.  int64 carriers (the 64-bit-torus pipeline) instead
    split ``a`` into 8 int8 limbs and contract each against the {0,1,-1}
    Toeplitz in int32 (|partial| <= 127*N < 2^31), combining mod 2^64, so
    no s64 dot_general is needed.  Used by encrypt/decrypt where the second operand is a
    secret key polynomial (trlwe.zig:54-60).
    """
    if a_torus.dtype == jnp.int64:
        T8 = toeplitz(s_binary.astype(jnp.int8))        # {0, 1, -1}
        a_limbs = i32_to_i8_limbs(a_torus, 8)           # [..., N, 8]
        parts = [matmul_i8(a_limbs[..., l], T8) for l in range(8)]
        return i8_limbs_combine(parts, [8 * l for l in range(8)], 64)
    T = toeplitz(s_binary.astype(a_torus.dtype))  # entries in {0, 1, -1}
    return jax.lax.dot_general(
        a_torus, T,
        dimension_numbers=(((a_torus.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=a_torus.dtype,
    )


def negacyclic_rotate(p, k):
    """Multiply by X^k (negacyclic rotation), k in [0, 2N] mod 2N.

    p: int32 [..., N]; k: int32 scalar or batch matching leading dims of p.
    out[..., n] = ext(p)[..., (n - k) mod 2N]  — matches polyMulWithXK
    (trgsw.zig:442-466) for all k in [0, 2N].
    """
    N = p.shape[-1]
    ext = negacyclic_extend(p)  # [..., 2N]
    n_idx = jnp.arange(N, dtype=jnp.int32)
    k = jnp.asarray(k, jnp.int32)
    idx = (n_idx - k[..., None]) % (2 * N) if k.ndim else (n_idx - k) % (2 * N)
    if k.ndim:
        # batch k: idx [..., N] must broadcast against ext's leading dims
        while idx.ndim < ext.ndim:
            idx = idx[..., None, :]
        idx = jnp.broadcast_to(idx, ext.shape[:-1] + (N,))
        return jnp.take_along_axis(ext, idx, axis=-1)
    return ext[..., idx]


# ---------------------------------------------------------------------------
# Test oracle (host-side, numpy object/int64 exact arithmetic)
# ---------------------------------------------------------------------------


def negacyclic_polymul_naive(a, b):
    """Schoolbook negacyclic product mod 2^32, numpy int64 (test oracle).

    Mirrors the reference's naive oracle (fft.zig:695-714).  Inputs int32
    arrays [N]; a treated as signed, b as torus (mod 2^32 — sign-agnostic).
    """
    a = np.asarray(a).astype(object)  # exact big-int arithmetic
    b = np.asarray(b).astype(object)
    N = a.shape[-1]
    out = np.zeros(N, dtype=object)
    for k in range(N):
        for j in range(N):
            idx = k + j
            if idx < N:
                out[idx] += a[k] * b[j]
            else:
                out[idx - N] -= a[k] * b[j]
    out = np.array([int(v) & 0xFFFFFFFF for v in out], dtype=np.uint32)
    return out.astype(np.int32)
