"""TRLWE ring ciphertexts, batch-first.

A TRLWE ciphertext is int32 ``[..., 2, N]`` — index 0 is the mask polynomial
``a``, index 1 the body ``b`` (trlwe.zig:15-18).  Encryption computes
``b = a * s + noise + mu`` with an EXACT negacyclic product (the reference
uses the f64 FFT poly_mul, trlwe.zig:54-60; binary s makes plain int32
matmul exact here — see ops/poly.py:negacyclic_polymul_binary).

Sample extraction (trlwe.zig:146-180) is a flip-gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax.ops.poly import negacyclic_polymul_binary
from zig_tfhe_jax.utils import rng as _rng
from zig_tfhe_jax.utils.torus import f64_to_torus, to_i32

A, B = 0, 1  # component indices on axis -2


def encrypt_torus(key, mu, alpha: float, sk_poly, width: int = 32):
    """Encrypt torus polynomial plaintexts ``mu`` ([..., N] carriers).

    Returns carrier [..., 2, N].
    """
    from zig_tfhe_jax.utils.torus import carrier_dtype

    mu = jnp.asarray(mu, carrier_dtype(width))
    N = sk_poly.shape[-1]
    ka, kn = jax.random.split(key)
    a = _rng.uniform_torus(ka, mu.shape, width)
    noise = _rng.gaussian_torus(kn, mu.shape, alpha, width)
    b = negacyclic_polymul_binary(a, sk_poly) + noise + mu
    return jnp.stack([a, b], axis=-2)


def encrypt_bool(key, bits, alpha: float, sk_poly):
    """Encrypt boolean polynomials as +-1/8 per coefficient (trlwe.zig:67-82)."""
    bits = jnp.asarray(bits, bool)
    mu = jnp.where(bits, to_i32(int(f64_to_torus(0.125))),
                   to_i32(int(f64_to_torus(-0.125))))
    return encrypt_torus(key, mu, alpha, sk_poly)


def phase(ct, sk_poly):
    """b - a*s, int32 [..., N]."""
    return ct[..., B, :] - negacyclic_polymul_binary(ct[..., A, :], sk_poly)


def decrypt_bool(ct, sk_poly):
    return phase(ct, sk_poly) >= 0


def sample_extract(ct, k: int = 0):
    """Extract the TLWE(lv1) sample at coefficient ``k`` (trlwe.zig:146-162).

    p[i] = a[k-i] for i <= k else -a[N+k-i];  b = b_poly[k].
    Returns int32 [..., N+1].
    """
    return sample_extract_lv0_shaped(ct, ct.shape[-1], k)


def sample_extract_lv0_shaped(ct, n0: int, k: int = 0):
    """Reference's sampleExtractIndex2 (trlwe.zig:165-180): TLWELv0-shaped
    extract that keeps only the first n0 mask coefficients.  The result is
    under (a truncation of) the lv1 key — a hybrid used by
    bootstrapWithoutKeySwitch (vanilla.zig:58-69).  Provided for API parity.

    Requires n0 <= N: a degree-N ring sample determines only N mask
    coefficients (for i > N+k the gather index N+k-i would go negative and
    JAX would silently wrap it — garbage, not an error — so this is checked
    explicitly; the uint5-uint8 sets have n0 > N and cannot use this path).
    """
    N = ct.shape[-1]
    if n0 > N:
        raise ValueError(
            f"sample_extract_lv0_shaped needs n0 <= N, got n0={n0} > N={N}")
    i = np.arange(n0)
    src = np.where(i <= k, k - i, N + k - i)
    sign = np.where(i <= k, 1, -1).astype(np.int32)
    p = ct[..., A, :][..., jnp.asarray(src)] * jnp.asarray(sign)
    b = ct[..., B, k][..., None]
    return jnp.concatenate([p, b], axis=-1)
