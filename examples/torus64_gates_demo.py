#!/usr/bin/env python
"""64-bit torus / N=2048 gates — past the reference's u32 ceiling.

The upstream reference pins Torus=u32 and N=1024 at comptime
(params.zig:21-30, 386-416): a secure N=2048 ring is unreachable there
because its lv1 noise (~2^-51.5 of the torus) underflows u32.  This
framework makes the torus width a runtime parameter and runs N=2048
rings on the even/odd split engine (ops/split_ring.py, docs/TORUS64.md)
— four N=1024 half-products on the shipped five-prime NTT pool.

The demo evaluates the NAND/XOR truth tables on a 64-bit N=2048 set and
prints the noise headroom the wider torus buys.

Usage:
  python examples/torus64_gates_demo.py [--params tiny_split|128bit_t64]
  (tiny_split is the fast exact CPU run; 128bit_t64 is the real-scale
  128-bit set, pinned by the in-tree estimator — docs/SECURITY.md; the
  round-4 spike name draft128_t64 still resolves as an alias)
"""

import argparse
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

jax.config.update("jax_enable_x64", True)      # int64 carriers

import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import gates as G
from zig_tfhe_jax.ops.ntt import default_group


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="tiny_split")
    args = ap.parse_args()
    params = P.PARAMS_BY_NAME[args.params]
    assert params.split_ring, "pick an N=2048 set (tiny_split/128bit_t64)"

    print(f"params: {params.name}  N={params.N}  torus=2^{params.torus_bits}"
          f"  n0={params.n0}  (split-ring engine, group "
          f"{default_group(params)})")
    t0 = time.time()
    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)
    print(f"keygen: {time.time() - t0:.1f}s  "
          f"(BSK {np.prod(ck.bsk_ntt.shape) * 2 / 1e6:.0f} MB split-NTT form)")

    a = jnp.array([0, 0, 1, 1], bool)
    b = jnp.array([0, 1, 0, 1], bool)
    alpha = params.tlwe_lv0.alpha
    ca = tlwe.encrypt_bool(jax.random.key(2), a, alpha, sk.key_lv0, width=64)
    cb = tlwe.encrypt_bool(jax.random.key(3), b, alpha, sk.key_lv0, width=64)

    t0 = time.time()
    nand = np.asarray(tlwe.decrypt_bool(G.nand(ca, cb, ck), sk.key_lv0))
    xor = np.asarray(tlwe.decrypt_bool(G.xor(ca, cb, ck), sk.key_lv0))
    dt = time.time() - t0
    print(f"NAND(a,b) = {nand.astype(int).tolist()}  (expect [1, 1, 1, 0])")
    print(f"XOR(a,b)  = {xor.astype(int).tolist()}  (expect [0, 1, 1, 0])")
    ok = (nand == [True, True, True, False]).all() and \
         (xor == [False, True, True, False]).all()
    print(f"both truth tables {'EXACT' if ok else 'WRONG'} in {dt:.1f}s")

    # the integer layer rides the same engine (multi-value bootstraps
    # included): encrypted arithmetic on the 64-bit variant
    from zig_tfhe_jax.models.integer import FheUint, decrypt_radix
    xi = FheUint.encrypt(jax.random.key(5), 45, 2, sk, ck)
    yi = FheUint.encrypt(jax.random.key(6), 23, 2, sk, ck)
    prod = decrypt_radix((xi * yi).digits, sk.key_lv0)
    print(f"\nFheUint on the 64-bit set: 45 * 23 = {prod} "
          f"({'EXACT' if prod == 1035 else 'WRONG'})")
    ok = ok and prod == 1035

    # what the 64-bit torus buys (docs/TORUS64.md §2)
    print("\nnoise headroom vs the 32-bit ceiling:")
    print("  decrypt margin (1/16 torus):  2^28 (u32)  ->  2^60 (u64)")
    print("  secure N=2048 lv1 noise ~2^-51.5 of the torus: < 1 ulp on "
          "u32 (unrepresentable), ~2^12.5 absolute on u64")
    if not ok:
        raise SystemExit(1)
    print("SUCCESS")


if __name__ == "__main__":
    main()
