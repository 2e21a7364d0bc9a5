"""LWE proxy re-encryption (public keys, re-encryption keys, re-encrypt op).

Mirrors proxy_reenc.zig: a public key is a bank of zero-encryptions
(proxy_reenc.zig:47-75); public-key encryption is a random +-1 subset-sum of
the bank plus the plaintext and fresh noise (83-113); a re-encryption key is
a key-switching key from the delegator's key to the delegatee's, built
either from the delegatee's PUBLIC key (asymmetric, 134-192) or secret key
(symmetric, 198-255); re-encryption is a key switch (267-306).

Batched redesign: the re-encryption key stores a single entry per (i, j)
(signed digits), and re-encryption is one int8-limb matmul — the same kernel
as the identity key switch (ops/keyswitch.py).  Multi-hop chains compose.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

import functools

from zig_tfhe_jax import tlwe as _tlwe
from zig_tfhe_jax.ops.keyswitch import key_switch_matmul, ks_plaintexts
from zig_tfhe_jax.params import SecurityParams
from zig_tfhe_jax.utils import rng as _rng
from zig_tfhe_jax.utils.torus import to_i32, torus_constant


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PublicKeyLv0:
    """Bank of zero-encryptions under a lv0 secret key (proxy_reenc.zig:38-75)."""

    encryptions: Any  # int32 [size, n0+1]

    def tree_flatten(self):
        return (self.encryptions,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def generate(cls, key, secret_key_lv0, params: SecurityParams,
                 size: int | None = None, alpha: float | None = None):
        size = 2 * params.n0 if size is None else size  # 2N for security
        alpha = params.tlwe_lv0.alpha if alpha is None else alpha
        zeros = jnp.zeros((size,), jnp.int32)
        return cls(_encrypt_torus_j(key, zeros, alpha, secret_key_lv0))

    def encrypt_torus(self, key, mu, alpha: float):
        """Public-key encrypt torus plaintexts ``mu`` (int32 [...]).

        result = sum_i s_i * bank[i] + (0.., mu + fresh_noise), with
        s_i in {0:1/2, +1:1/4, -1:1/4} (proxy_reenc.zig:83-113).  The
        subset-sum is one int32 matmul (coefficients in {-1,0,1} are exact).
        """
        mu = jnp.asarray(mu, jnp.int32)
        size = self.encryptions.shape[0]
        ks, kn = jax.random.split(key)
        r = jax.random.randint(ks, mu.shape + (size,), 0, 4)
        signs = jnp.where(r == 0, 1, jnp.where(r == 1, -1, 0)).astype(jnp.int32)
        combo = jax.lax.dot_general(
            signs, self.encryptions,
            dimension_numbers=(((signs.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        noise = _rng.gaussian_torus(kn, mu.shape, float(alpha))
        n0 = self.encryptions.shape[-1] - 1
        return combo.at[..., n0].add(mu + noise)

    def encrypt_bool(self, key, bits, alpha: float):
        bits = jnp.asarray(bits, bool)
        mu = jnp.where(bits, to_i32(torus_constant(_tlwe.BOOL_MU)),
                       to_i32(torus_constant(-_tlwe.BOOL_MU)))
        return self.encrypt_torus(key, mu, alpha)


# jitted keygen cores: one dispatch instead of one per eager op
_encrypt_torus_j = jax.jit(_tlwe.encrypt_torus, static_argnums=2)


# whole-keygen cores: ks_plaintexts + encrypt + reshape as ONE dispatch
@functools.partial(jax.jit, static_argnames=("alpha", "basebit", "t"))
def _asym_key_core(key, key_from, bank, alpha, basebit, t):
    mu = ks_plaintexts(key_from, basebit, t)
    ct = PublicKeyLv0(bank).encrypt_torus(key, mu, alpha)
    return ct.reshape(key_from.shape[0] * t, -1)


@functools.partial(jax.jit, static_argnames=("alpha", "basebit", "t"))
def _sym_key_core(key, key_from, key_to, alpha, basebit, t):
    mu = ks_plaintexts(key_from, basebit, t)
    ct = _tlwe.encrypt_torus(key, mu, alpha, key_to)
    return ct.reshape(key_from.shape[0] * t, -1)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ProxyReencryptionKey:
    """Signed-digit re-encryption key: row (i*t + j) encrypts
    key_from[i] * 2^(32-(j+1)*basebit) under the delegatee's key."""

    key_encryptions: Any  # int32 [n0*t, n0+1]
    basebit: int = dataclasses.field(metadata=dict(static=True))
    t: int = dataclasses.field(metadata=dict(static=True))

    def tree_flatten(self):
        return (self.key_encryptions,), (self.basebit, self.t)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], basebit=aux[0], t=aux[1])

    @property
    def base(self) -> int:
        return 1 << self.basebit

    @classmethod
    def new_symmetric(cls, key, key_from, key_to, params: SecurityParams,
                      alpha: float | None = None,
                      basebit: int | None = None, t: int | None = None):
        """Both secret keys available (proxy_reenc.zig:198-255)."""
        basebit = params.basebit if basebit is None else basebit
        t = params.iks_t if t is None else t
        alpha = params.ksk_alpha if alpha is None else alpha
        ct = _sym_key_core(key, key_from, key_to, float(alpha), basebit, t)
        return cls(ct, basebit=basebit, t=t)

    @classmethod
    def new_asymmetric(cls, key, key_from, public_key_to: PublicKeyLv0,
                       params: SecurityParams, alpha: float | None = None,
                       basebit: int | None = None, t: int | None = None):
        """Delegatee contributes only a PUBLIC key (proxy_reenc.zig:134-192)."""
        basebit = params.basebit if basebit is None else basebit
        t = params.iks_t if t is None else t
        alpha = params.ksk_alpha if alpha is None else alpha
        ct = _asym_key_core(key, key_from, public_key_to.encryptions,
                            float(alpha), basebit, t)
        return cls(ct, basebit=basebit, t=t)


def reencrypt(ct, reenc_key: ProxyReencryptionKey):
    """Re-encrypt TLWE lv0 batch(es) to the delegatee's key
    (proxy_reenc.zig:267-306).  ct: int32 [..., n0+1]."""
    return key_switch_matmul(ct, reenc_key.key_encryptions,
                             reenc_key.basebit, reenc_key.t)
