#!/usr/bin/env python
"""Benchmark: bootstrapped-gate throughput at 128-bit security on one chip.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "gates/s", "vs_baseline": N}

Baseline: the reference evaluates one bootstrapped gate in 37.31 ms on an
M-series core (CHANGELOG.md:86) => ~26.8 gates/s.  vs_baseline is our
batched gates/s divided by that.

Env knobs:
  BENCH_BATCH   gate batch per step (default 2048, the gate path's knee)
  BENCH_ITERS   timed iterations (default 4)
  BENCH_PARAMS  parameter set name (default 128bit)
"""

import json
import os
import sys
import time

# persistent compilation cache: repeat runs skip the compiles
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"))

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import gates as G

REFERENCE_GATES_PER_S = 1000.0 / 37.31  # CHANGELOG.md:86


def main():
    B = int(os.environ.get("BENCH_BATCH", "2048"))
    iters = int(os.environ.get("BENCH_ITERS", "4"))
    pname = os.environ.get("BENCH_PARAMS", "128bit")
    params = P.PARAMS_BY_NAME[pname]

    drop = os.environ.get("BENCH_DROP")
    # default: the per-set group (ops/ntt.py:default_group)
    group = os.environ.get("BENCH_GROUP")
    group = int(group) if group else None
    t0 = time.time()
    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params, group=group,
                             ntt_drop=int(drop) if drop else None)
    jax.block_until_ready(ck)
    print(f"# keygen (cold, incl jit compile): {time.time()-t0:.1f}s",
          file=sys.stderr)
    t0 = time.time()
    ck_w = K.CloudKey.generate(jax.random.key(4), sk, params, group=group,
                               ntt_drop=int(drop) if drop else None)
    jax.block_until_ready(ck_w)
    print(f"# keygen (warm): {(time.time()-t0)*1e3:.0f} ms "
          f"(reference: ~30 s observed, key.zig:240-241)", file=sys.stderr)
    del ck_w

    bits_a = jnp.asarray(np.random.default_rng(0).integers(0, 2, B).astype(bool))
    bits_b = jnp.asarray(np.random.default_rng(1).integers(0, 2, B).astype(bool))
    cta = tlwe.encrypt_bool(jax.random.key(2), bits_a, params.tlwe_lv0.alpha, sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(3), bits_b, params.tlwe_lv0.alpha, sk.key_lv0)

    nand_jit = jax.jit(lambda a, b, k: G.gate("nand", a, b, k))
    nand_fn = lambda a, b: nand_jit(a, b, ck)

    _sync = jax.block_until_ready

    t0 = time.time()
    out = _sync(nand_fn(cta, ctb))
    print(f"# compile+first run: {time.time()-t0:.1f}s", file=sys.stderr)

    # correctness gate: decrypts must match the NAND truth table
    dec = np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))
    expected = ~(np.asarray(bits_a) & np.asarray(bits_b))
    acc = float((dec == expected).mean())
    print(f"# accuracy: {acc:.4f}", file=sys.stderr)

    times = []
    for _ in range(iters):
        t0 = time.time()
        out = _sync(nand_fn(cta, ctb))
        times.append(time.time() - t0)
    dt = float(np.median(times))
    gates_per_s = B / dt
    print(f"# median step: {dt*1e3:.1f} ms for {B} gates "
          f"({dt/B*1e3:.3f} ms/gate)", file=sys.stderr)

    result = {
        "metric": f"bootstrapped_gates_per_s_{pname}_batch{B}",
        "value": round(gates_per_s, 2),
        "unit": "gates/s",
        "vs_baseline": round(gates_per_s / REFERENCE_GATES_PER_S, 2),
        "accuracy": acc,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }

    # single-gate / small-batch p50 latency (reference single gate =
    # 37.31 ms, CHANGELOG.md:86).  BENCH_LATENCY=0 skips (two extra jit
    # shapes => two extra compiles).
    if os.environ.get("BENCH_LATENCY", "1") not in ("0", "false"):
        for bl in (1, 16):
            ca, cb = cta[:bl], ctb[:bl]
            _sync(nand_fn(ca, cb))         # compile
            lts = []
            for _ in range(10):
                t0 = time.time()
                _sync(nand_fn(ca, cb))
                lts.append(time.time() - t0)
            p50 = float(np.median(lts)) * 1e3
            result[f"latency_ms_p50_b{bl}"] = round(p50, 2)
            print(f"# latency p50 B={bl}: {p50:.1f} ms (reference single "
                  f"gate 37.31 ms)", file=sys.stderr)

    print(json.dumps(result))


if __name__ == "__main__":
    main()
