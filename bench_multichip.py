#!/usr/bin/env python
"""Multi-chip scaling benchmark: batch-sharded gate evaluation over a mesh.

Measures bootstrapped-gate throughput at 1 device and at N devices (batch
axis sharded over the "data" mesh axis, keys replicated) and reports the
scaling efficiency.  Gate evaluation is embarrassingly parallel over the
batch, so the expected efficiency is ~1.0: the only cross-device traffic
is the initial key broadcast.

Without several accelerators, validate the sharded path on a virtual CPU
mesh (NOTE: virtual devices share the same physical
cores, so "efficiency" there only validates correctness, not scaling —
gate evaluation has no cross-device traffic, so real-hardware efficiency
tracks ~1.0):

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      BENCH_PARAMS=tiny python bench_multichip.py

Prints one JSON line {"metric", "value" (gates/s at N devices),
"unit", "n_devices", "efficiency"}.
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
from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import gates as G
from zig_tfhe_jax.parallel import mesh as M


_sync = jax.block_until_ready


def throughput(mesh, ck, sk, params, B, iters):
    rng = np.random.default_rng(0)
    bits_a = jnp.asarray(rng.integers(0, 2, B).astype(bool))
    bits_b = jnp.asarray(rng.integers(0, 2, B).astype(bool))
    cta = tlwe.encrypt_bool(jax.random.key(2), bits_a,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(3), bits_b,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    ck_r = M.replicate(mesh, ck)
    cta, ctb = M.shard_batch(mesh, cta), M.shard_batch(mesh, ctb)
    fn = jax.jit(lambda a, b, k: G.gate("nand", a, b, k))
    with mesh:
        out = _sync(fn(cta, ctb, ck_r))  # compile + warmup
        dec = np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))
        acc = float((dec == ~(np.asarray(bits_a) & np.asarray(bits_b))).mean())
        times = []
        for _ in range(iters):
            t0 = time.time()
            _sync(fn(cta, ctb, ck_r))
            times.append(time.time() - t0)
    return B / float(np.median(times)), acc


def main():
    pname = os.environ.get("BENCH_PARAMS", "128bit")
    params = P.PARAMS_BY_NAME[pname]
    n_dev = len(jax.devices())
    B_per_dev = int(os.environ.get("BENCH_BATCH_PER_DEV",
                                   "64" if params.N < 1024 else "1024"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))

    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)
    jax.block_until_ready(jax.tree_util.tree_leaves(ck))

    mesh1 = M.make_mesh(devices=jax.devices()[:1])
    g1, acc1 = throughput(mesh1, ck, sk, params, B_per_dev, iters)
    print(f"# 1 device: {g1:.1f} gates/s (accuracy {acc1:.4f})",
          file=sys.stderr)

    if n_dev > 1:
        meshN = M.make_mesh(devices=jax.devices())
        gN, accN = throughput(meshN, ck, sk, params, B_per_dev * n_dev, iters)
    else:
        meshN, gN, accN = mesh1, g1, acc1
    eff = gN / (g1 * n_dev)
    print(f"# {n_dev} devices: {gN:.1f} gates/s, efficiency {eff:.3f} "
          f"(accuracy {accN:.4f})", file=sys.stderr)

    print(json.dumps({
        "metric": f"multichip_gates_per_s_{pname}_{n_dev}dev",
        "value": round(gN, 2),
        "unit": "gates/s",
        "n_devices": n_dev,
        "efficiency": round(eff, 4),
        "accuracy": accN,
    }))


if __name__ == "__main__":
    main()
