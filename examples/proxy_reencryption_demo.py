#!/usr/bin/env python
"""Proxy re-encryption demo: Alice -> Bob -> Carol delegation chain.

Port-equivalent of examples/proxy_reencryption_demo.zig: public-key
generation timing, batched re-encryption of messages, a 3-hop chain, and an
accuracy report — batch-first (all messages re-encrypted in one matmul).

Run (CPU, fast):  JAX_PLATFORMS=cpu python examples/proxy_reencryption_demo.py tiny
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                 ".jax_cache"))

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zig_tfhe_jax import key as K, params as P, tlwe  # noqa: E402
from zig_tfhe_jax.models import proxy_reenc as PR  # noqa: E402
from zig_tfhe_jax.utils.profiling import time_op  # noqa: E402


def main():
    params = P.PARAMS_BY_NAME[sys.argv[1]] if len(sys.argv) > 1 else P.SECURITY_128_BIT
    print("=== LWE Proxy Re-encryption Demo ===\n")

    alice = K.SecretKey.generate(jax.random.key(0), params)
    bob = K.SecretKey.generate(jax.random.key(1), params)
    carol = K.SecretKey.generate(jax.random.key(2), params)

    # warm timings via the shared harness (compile excluded)
    dt = time_op(lambda: PR.PublicKeyLv0.generate(
        jax.random.key(3), bob.key_lv0, params), iters=3, warmup=1)
    bob_pk = PR.PublicKeyLv0.generate(jax.random.key(3), bob.key_lv0, params)
    print(f"Public key generation: {dt*1000:.1f} ms (warm)")

    dt = time_op(lambda: PR.ProxyReencryptionKey.new_asymmetric(
        jax.random.key(4), alice.key_lv0, bob_pk, params), iters=3, warmup=1)
    rk_ab = PR.ProxyReencryptionKey.new_asymmetric(
        jax.random.key(4), alice.key_lv0, bob_pk, params)
    print(f"Asymmetric re-enc keygen (Alice->Bob): {dt*1000:.1f} ms (warm)")

    dt = time_op(lambda: PR.ProxyReencryptionKey.new_symmetric(
        jax.random.key(5), bob.key_lv0, carol.key_lv0, params),
        iters=3, warmup=1)
    rk_bc_sym = PR.ProxyReencryptionKey.new_symmetric(
        jax.random.key(5), bob.key_lv0, carol.key_lv0, params)
    print(f"Symmetric re-enc keygen (Bob->Carol): {dt*1000:.1f} ms (warm)")

    # batched re-encryption of many messages at once (jitted, warmed)
    n_msgs = 256
    bits = jnp.asarray(np.random.default_rng(0).integers(0, 2, n_msgs).astype(bool))
    ct_alice = tlwe.encrypt_bool(jax.random.key(6), bits, params.tlwe_lv0.alpha,
                                 alice.key_lv0)
    reenc = jax.jit(lambda ct, k: PR.reencrypt(
        ct, PR.ProxyReencryptionKey(k, rk_ab.basebit, rk_ab.t)))
    dt = time_op(reenc, ct_alice, rk_ab.key_encryptions, iters=3, warmup=1)
    ct_bob = reenc(ct_alice, rk_ab.key_encryptions)
    acc_bob = float((np.asarray(tlwe.decrypt_bool(ct_bob, bob.key_lv0))
                     == np.asarray(bits)).mean())
    print(f"\nRe-encrypted {n_msgs} messages Alice->Bob in {dt*1000:.1f} ms "
          f"warm ({dt*1e6/n_msgs:.1f} us/msg), accuracy {acc_bob*100:.1f}%")

    ct_carol = PR.reencrypt(ct_bob, rk_bc_sym)
    acc_carol = float((np.asarray(tlwe.decrypt_bool(ct_carol, carol.key_lv0))
                       == np.asarray(bits)).mean())
    print(f"3-hop chain Alice->Bob->Carol accuracy: {acc_carol*100:.1f}%")
    if acc_carol < 0.9:
        sys.exit(1)


if __name__ == "__main__":
    main()
