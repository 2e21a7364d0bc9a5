#!/usr/bin/env python
"""Encrypted integer op throughput: batched radix-8 6-bit operands.

Each op is an exact composition of programmable bootstraps
(models/integer.py); the batch axis shares every PBS round, so the cost
per integer amortizes like the gate benches.  Accuracy is checked against
plain arithmetic (must be 1.0 at uint4 real noise).

Env: BENCH_BATCH (default 256), BENCH_PARAMS (default uint4),
     BENCH_ITERS (default 3), BENCH_OP (mul|add|div|lt|eq, default mul),
     BENCH_PACKING=1 (tree-PBS digit multiplier via a packing key).
Prints one JSON line.

BENCH_PARAMS=128bit_t64 measures the SECURE integer path (the in-tree-
estimator-pinned 64-bit split-ring set; VERDICT r4 #2 — every uint-set
row is 0-bit lv1 security per docs/SECURITY.md and the README labels
them so).  Requires jax_enable_x64; the carrier width follows the set.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"))

import jax


import numpy as np  # noqa: E402

from zig_tfhe_jax import key as K  # noqa: E402
from zig_tfhe_jax import params as P  # noqa: E402
from zig_tfhe_jax.models import integer as I  # noqa: E402


_sync = jax.block_until_ready


def main():
    B = int(os.environ.get("BENCH_BATCH", "256"))
    pname = os.environ.get("BENCH_PARAMS", "uint4")
    iters = int(os.environ.get("BENCH_ITERS", "3"))
    params = P.PARAMS_BY_NAME[pname]
    if params.torus_bits == 64:
        jax.config.update("jax_enable_x64", True)

    t0 = time.time()
    sk = K.SecretKey.generate(jax.random.key(0), params)
    opname = os.environ.get("BENCH_OP", "mul")
    # only mul's digit multiplier uses the packing key; add/div/lt/eq keep
    # their round-1 metric names (and skip the extra keygen)
    packing = opname == "mul" and \
        os.environ.get("BENCH_PACKING", "1") in ("1", "true")
    ck = K.CloudKey.generate(jax.random.key(1), sk, params,
                             packing_key=packing)
    jax.block_until_ready(ck)
    print(f"# keygen (cold, incl jit compile): {time.time()-t0:.1f}s",
          file=sys.stderr)

    w = params.torus_bits
    rng = np.random.default_rng(0)
    a = rng.integers(0, 64, B)
    b = rng.integers(0, 64, B)
    ca = I.encrypt_radix(jax.random.key(2), a, 2, params.tlwe_lv0.alpha,
                         sk.key_lv0, width=w)
    cb = I.encrypt_radix(jax.random.key(3), b, 2, params.tlwe_lv0.alpha,
                         sk.key_lv0, width=w)

    ops = {
        # (jitted fn on digit arrays, plain reference on values)
        "mul": (lambda x, y, k: I.radix_mul(x, y, k), lambda: a * b),
        "add": (lambda x, y, k: I.radix_add(x, y, k)[:, :2],
                lambda: (a + b) % 64),
        "div": (lambda x, y, k: I.radix_divmod(x, y, k)[0],
                lambda: a // np.maximum(b, 1)),
        "lt": (lambda x, y, k: I.radix_lt(x, y, k)[:, None, :],
               lambda: (a < b).astype(np.int64)),
        "eq": (lambda x, y, k: I.radix_eq(x, y, k)[:, None, :],
               lambda: (a == b).astype(np.int64)),
    }
    fn, ref = ops[opname]
    if opname == "div":
        b = np.maximum(b, 1)           # benchmarked path: nonzero divisors
        cb = I.encrypt_radix(jax.random.key(3), b, 2,
                             params.tlwe_lv0.alpha, sk.key_lv0, width=w)
    op = jax.jit(fn)
    t0 = time.time()
    out = _sync(op(ca, cb, ck))
    print(f"# compile+first run: {time.time()-t0:.1f}s", file=sys.stderr)

    dec = I.decrypt_radix(out, sk.key_lv0)
    acc = float((dec == ref()).mean())
    print(f"# accuracy: {acc:.4f}", file=sys.stderr)

    times = []
    for _ in range(iters):
        t0 = time.time()
        _sync(op(ca, cb, ck))
        times.append(time.time() - t0)
    dt = float(np.median(times))
    # "mults" (not "muls") keeps the round-1 metric series continuous
    plural = {"mul": "mults"}.get(opname, f"{opname}s")
    print(f"# median: {dt*1e3:.1f} ms for {B} {plural} "
          f"({dt/B*1e3:.2f} ms each)", file=sys.stderr)
    suffix = "_treepbs" if packing else ""
    print(json.dumps({
        "metric": f"encrypted_int6_{plural}_per_s_{pname}_batch{B}{suffix}",
        "value": round(B / dt, 2),
        "unit": f"{plural}/s",
        "accuracy": acc,
    }))


if __name__ == "__main__":
    main()
