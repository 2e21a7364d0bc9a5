#!/usr/bin/env python
"""Programmable (LUT) bootstrapping demo: evaluate f(x) = x^2 mod m on
encrypted 4-bit integers in one bootstrap each.

The reference ships the LUT building blocks (lut/encoder.zig,
lut/generator.zig, lut/lookup_table.zig) but no end-to-end wrapper
(lut.zig:42 documents a bootstrapLut that does not exist); here the whole
pipeline is the first-class `models.lut.bootstrap_lut`.

Usage: python examples/lut_bootstrap_demo.py [params] [modulus]
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

from zig_tfhe_jax import key as K  # noqa: E402
from zig_tfhe_jax import params as P  # noqa: E402
from zig_tfhe_jax.models import lut as L  # noqa: E402


def main():
    pname = sys.argv[1] if len(sys.argv) > 1 else "uint4"
    m = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    params = P.PARAMS_BY_NAME[pname]
    f = lambda x: (x * x) % m

    print(f"=== LUT bootstrapping: f(x) = x^2 mod {m} on {pname} ===\n")
    t0 = time.time()
    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)
    jax.block_until_ready(ck)
    print(f"Keys generated in {time.time()-t0:.1f}s")

    gen = L.Generator.new(m, params)
    table = gen.generate_lookup_table(f)

    msgs = np.arange(m)
    ct = L.encrypt_message(jax.random.key(2), jnp.asarray(msgs), m,
                           params.tlwe_lv0.alpha, sk.key_lv0)
    pbs = jax.jit(lambda c, k: L.bootstrap_lut(c, table, k))
    jax.block_until_ready(pbs(ct, ck))    # warmup: compile excluded below
    t0 = time.time()
    out = jax.block_until_ready(pbs(ct, ck))
    dt = time.time() - t0
    dec = np.asarray(L.decrypt_message(out, m, sk.key_lv0)).tolist()

    ok = all(d == f(x) for d, x in zip(dec, msgs))
    for x, d in zip(msgs, dec):
        mark = "" if d == f(x) else "   <-- WRONG"
        print(f"  f({x:2d}) = {d:2d}{mark}")
    print(f"\n{m} programmable bootstraps in {dt*1e3:.0f} ms "
          f"({'all correct' if ok else 'ERRORS'})")

    # --- large-modulus (radix tree-PBS) leg: moduli the single-shot route
    # cannot decode at N=1024 (docs/NOISE.md §8) ---
    big_m = 64
    g = lambda x: (x * 3 + 5) % big_m
    from zig_tfhe_jax.ops.packing_keyswitch import gen_packing_ksk
    pksk = gen_packing_ksk(jax.random.key(3), sk.key_lv1, params)
    big_msgs = np.array([0, 9, 17, 31, 40, 63]) % big_m
    cts = L.encrypt_radix_message(jax.random.key(4), big_msgs, big_m,
                                  params.tlwe_lv0.alpha, sk.key_lv0)
    out2 = L.bootstrap_lut_radix(*cts, g, big_m, ck, pksk)
    dec2 = np.asarray(L.decrypt_radix_message(out2, big_m, sk.key_lv0))
    ok2 = all(int(d) == g(int(x)) for d, x in zip(dec2, big_msgs))
    print(f"radix tree-PBS at m={big_m}: "
          f"{[int(d) for d in dec2]} ({'all correct' if ok2 else 'ERRORS'})")
    print("> OK" if ok and ok2 else "> FAIL")
    sys.exit(0 if ok and ok2 else 1)


if __name__ == "__main__":
    main()
