#!/usr/bin/env python
"""Programmable (LUT) bootstrapping throughput on the current device.

Evaluates an arbitrary function f: Z_m -> Z_m homomorphically via
encrypt -> blind-rotate with a custom test vector -> sample extract ->
key switch -> decrypt (the reference ships the pieces but no wrapper,
lut.zig:42; here it is the bootstrap_lut API).

Env: BENCH_BATCH (default 1024), BENCH_PARAMS (default uint4),
     BENCH_ITERS (default 3).
Prints one JSON line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# persistent compilation cache: repeat runs skip the compiles
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"))

import jax

import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax.models import lut as L


_sync = jax.block_until_ready


def main():
    B = int(os.environ.get("BENCH_BATCH", "1024"))
    pname = os.environ.get("BENCH_PARAMS", "uint4")
    iters = int(os.environ.get("BENCH_ITERS", "3"))
    params = P.PARAMS_BY_NAME[pname]
    # uintN sets carry the message bit-width in security_bits;
    # tiny_uint (bits=0) is built for m=16; boolean sets bench m=4
    if "uint" in params.name:
        m = 2 ** params.security_bits if params.security_bits else 16
    else:
        m = 4
    m = min(m, 16)

    t0 = time.time()
    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)
    jax.block_until_ready(ck)
    print(f"# keygen (cold, incl jit compile): {time.time()-t0:.1f}s",
          file=sys.stderr)

    f = lambda x: (x * 3 + 1) % m
    gen = L.Generator.new(m, params)
    table = gen.generate_lookup_table(f)

    msgs = np.random.default_rng(0).integers(0, m, B)
    ct = L.encrypt_message(jax.random.key(2), jnp.asarray(msgs),
                           m, params.tlwe_lv0.alpha, sk.key_lv0)
    pbs = jax.jit(lambda c, k: L.bootstrap_lut(c, table, k))

    t0 = time.time()
    out = _sync(pbs(ct, ck))
    print(f"# compile+first run: {time.time()-t0:.1f}s", file=sys.stderr)

    n_chk = min(B, 256)
    dec = np.asarray(L.decrypt_message(out[:n_chk], m, sk.key_lv0))
    acc = float((dec == f(msgs[:n_chk])).mean())
    print(f"# accuracy (first {len(dec)}): {acc:.4f}", file=sys.stderr)

    times = []
    for _ in range(iters):
        t0 = time.time()
        _sync(pbs(ct, ck))
        times.append(time.time() - t0)
    dt = float(np.median(times))
    per_s = B / dt
    print(f"# median: {dt*1e3:.1f} ms for {B} PBS ({dt/B*1e3:.3f} ms/op)",
          file=sys.stderr)
    print(json.dumps({
        "metric": f"pbs_per_s_{pname}_m{m}_batch{B}",
        "value": round(per_s, 2),
        "unit": "bootstraps/s",
        "accuracy": acc,
    }))


if __name__ == "__main__":
    main()
