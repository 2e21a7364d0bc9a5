"""TLWE ciphertexts, batch-first.

A TLWE ciphertext is an int32 array ``[..., n+1]``: the mask ``a`` in the
first n slots and the body ``b`` last (tlwe.zig:11-14).  The unit of
work is a *batch* of ciphertexts, so every function here takes arbitrary
leading batch dims and is jit/vmap/shard_map friendly.

Boolean encoding is +-1/8 (tlwe.zig:52-55); the PBS message codec encodes
``msg * 1/(2m)`` and decodes with +0.5 rounding (tlwe.zig:74-117).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax.utils import rng as _rng
from zig_tfhe_jax.utils.torus import (carrier_dtype, f64_to_torus, to_carrier,
                                      to_i32, torus_constant_w,
                                      torus_to_float, torus_to_float_w)

BOOL_MU = 0.125  # tlwe.zig:53


def _inner_product_binary(a, s):
    """<a, s> mod 2^width for binary s: carrier-width multiply-accumulate
    is exact (products are a*1 or 0; two's-complement wrap).  int64
    carriers contract via 8 int8 limbs (|partial| <= 127*n < 2^31), so
    no s64 dot_general is needed (ops/poly.py:small_matmul_torus
    documents the same contract)."""
    if a.dtype == jnp.int64:
        from zig_tfhe_jax.utils.torus import i32_to_i8_limbs, i8_limbs_combine
        from zig_tfhe_jax.ops.poly import matmul_i8

        a_limbs = i32_to_i8_limbs(a, 8)                  # [..., n, 8]
        s8 = s.astype(jnp.int8)[:, None]                 # [n, 1]
        parts = [matmul_i8(a_limbs[..., l], s8)[..., 0] for l in range(8)]
        return i8_limbs_combine(parts, [8 * l for l in range(8)], 64)
    return jax.lax.dot_general(
        a, s.astype(a.dtype),
        dimension_numbers=(((a.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=a.dtype,
    )


def encrypt_torus(key, mu, alpha: float, sk, width: int = 32):
    """Encrypt torus plaintexts ``mu`` ([...] carriers at ``width``) under
    binary key ``sk``.

    Returns carrier [..., n+1].  b = <a, s> + gaussian(mu, alpha), a uniform
    (tlwe.zig:34-49).
    """
    mu = jnp.asarray(mu, carrier_dtype(width))
    n = sk.shape[-1]
    ka, kn = jax.random.split(key)
    a = _rng.uniform_torus(ka, mu.shape + (n,), width)
    noise = _rng.gaussian_torus(kn, mu.shape, alpha, width)
    b = _inner_product_binary(a, sk) + noise + mu
    return jnp.concatenate([a, b[..., None]], axis=-1)


def encrypt_torus_seeded(key, mu, alpha: float, sk, width: int = 32):
    """Seeded (compressed) encryption: returns (mask_seed, b) with b int32
    [...] — the wire form is (n+1)x smaller than the expanded ciphertext.
    ``expand_seeded(mask_seed, b, n)`` reconstructs EXACTLY the ciphertext
    ``encrypt_torus(key, mu, alpha, sk)``.

    SECURITY: only the MASK seed is returned/published — the mask ``a`` is
    public in any LWE ciphertext, so a seed that derives ``a`` and nothing
    else reveals nothing extra (under the PRF assumption on the keyed
    RNG).  The noise is drawn from the OTHER half of the key split and
    must stay secret: publishing the parent ``key`` itself would let
    anyone recompute the Gaussian noise and solve ``b - noise - mu =
    <a, s>`` for the secret key.  The classic seeded-LWE bandwidth trick;
    no reference analog (its seeding is nondeterministic, utils.zig:16-22,
    so it cannot compress).  width=64 for the 64-bit-torus sets."""
    mu = jnp.asarray(mu, carrier_dtype(width))
    n = sk.shape[-1]
    ka, kn = jax.random.split(key)
    a = _rng.uniform_torus(ka, mu.shape + (n,), width)
    noise = _rng.gaussian_torus(kn, mu.shape, alpha, width)
    b = _inner_product_binary(a, sk) + noise + mu
    return ka, b


def expand_seeded(mask_seed, b, n: int, width: int = 32):
    """(mask_seed, b) -> full ciphertext carrier [..., n+1] (see
    encrypt_torus_seeded; ``mask_seed`` is the published half of the
    encryption key split, NOT the encryption key itself)."""
    b = jnp.asarray(b, carrier_dtype(width))
    a = _rng.uniform_torus(mask_seed, b.shape + (n,), width)
    return jnp.concatenate([a, b[..., None]], axis=-1)


def encrypt_bool(key, bits, alpha: float, sk, width: int = 32):
    """Encrypt booleans as +-1/8 (tlwe.zig:52-55)."""
    return encrypt_torus(key, _bool_mu(bits, width), alpha, sk, width)


def encrypt_bool_seeded(key, bits, alpha: float, sk, width: int = 32):
    """Seeded-form boolean encryption (see encrypt_torus_seeded)."""
    return encrypt_torus_seeded(key, _bool_mu(bits, width), alpha, sk, width)


def _bool_mu(bits, width: int = 32):
    bits = jnp.asarray(bits, bool)
    return jnp.where(bits, to_carrier(torus_constant_w(BOOL_MU, width), width),
                     to_carrier(torus_constant_w(-BOOL_MU, width), width))


def phase(ct, sk):
    """b - <a, s> (the noisy plaintext), int32 [...]."""
    n = sk.shape[-1]
    return ct[..., n] - _inner_product_binary(ct[..., :n], sk)


def decrypt_bool(ct, sk):
    """Sign test on the phase (tlwe.zig:58-68)."""
    return phase(ct, sk) >= 0


def encrypt_message(key, message, message_modulus: int, alpha: float, sk,
                    width: int = 32):
    """PBS codec encrypt: msg * 1/(2m) on the torus (tlwe.zig:74-88)."""
    message = jnp.asarray(message) % message_modulus
    mu = _encode_message_table(message_modulus, width)
    mu = jnp.take(jnp.asarray(mu), message)
    return encrypt_torus(key, mu, alpha, sk, width)


def _encode_message_table(message_modulus: int, width: int = 32) -> np.ndarray:
    """Torus encodings of all messages in [0, m): trunc(x/(2m) * 2^width)."""
    scale = 1.0 / (2.0 * message_modulus)
    if width == 32:
        return f64_to_torus(np.arange(message_modulus) * scale)
    return np.array([to_carrier(torus_constant_w(x * scale, 64), 64)
                     for x in range(message_modulus)], np.int64)


def decrypt_message(ct, message_modulus: int, sk, width: int = 32):
    """PBS codec decrypt with +0.5 rounding (tlwe.zig:100-117)."""
    ph = phase(ct, sk)
    f = torus_to_float_w(ph, width)
    m = jnp.floor(f * (2.0 * message_modulus) + 0.5).astype(jnp.int32)
    return m % message_modulus


# Linear homomorphic ops (tlwe.zig:119-239) — int32 wrap == u32 wrap.

def add(x, y):
    return x + y


def sub(x, y):
    return x - y


def neg(x):
    return -x


def add_mul(x, y, multiplier: int):
    return x + y * jnp.int32(multiplier)


def sub_mul(x, y, multiplier: int):
    return x - y * jnp.int32(multiplier)


def add_to_b(ct, const_torus: int, n: int):
    """ct with ``const_torus`` added to the body only (gate bias)."""
    return ct.at[..., n].add(jnp.int32(const_torus))
