#!/usr/bin/env python
"""Scheduler-scale circuit bench: Wallace-tree 64x64 multiplier (~27k
gates, 43 levels) through the native level scheduler + batched evaluator.

This is the serving story's large-circuit datapoint (VERDICT r3 #7): a
real depth-43 netlist where every level runs as ONE batched heterogeneous
bootstrap, with level widths from 7 to 4097 exercising the gate path's
batch-bucket padding.  Prints one JSON line with circuit gates/s and
ms/level; accuracy is exact-product-or-bust.

Env: BENCH_W (operand bits, default 64), BENCH_BATCH (clients evaluated
simultaneously through the same plan, default 1), BENCH_PARAMS
(default 128bit).
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


import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zig_tfhe_jax import key as K  # noqa: E402
from zig_tfhe_jax import params as P  # noqa: E402
from zig_tfhe_jax import tlwe  # noqa: E402
from zig_tfhe_jax.models import scheduler as S  # noqa: E402
from zig_tfhe_jax.models.netlists import (bristol_multiplier,  # noqa: E402
                                          eval_bristol_plain)


def main():
    w = int(os.environ.get("BENCH_W", "64"))
    B = int(os.environ.get("BENCH_BATCH", "1"))
    pname = os.environ.get("BENCH_PARAMS", "128bit")
    params = P.PARAMS_BY_NAME[pname]
    if params.torus_bits == 64:
        jax.config.update("jax_enable_x64", True)

    text = bristol_multiplier(w)
    t0 = time.time()
    plan = S.parse_bristol(text)
    print(f"# scheduled {plan.n_gates} gates -> {plan.n_levels} levels, "
          f"{plan.n_slots} slots in {(time.time()-t0)*1e3:.0f} ms "
          f"(native scheduler)", file=sys.stderr)
    boot_gates = sum(int((l[:, 0] < 100).sum()) for l in plan.levels)

    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)
    jax.block_until_ready(ck)

    rng = np.random.default_rng(0)
    a_vals = rng.integers(0, 1 << w, B, dtype=np.uint64)
    b_vals = rng.integers(0, 1 << w, B, dtype=np.uint64)
    bits = np.zeros((2 * w, B), bool)
    for j in range(B):
        for i in range(w):
            bits[i, j] = (int(a_vals[j]) >> i) & 1
            bits[w + i, j] = (int(b_vals[j]) >> i) & 1
    cts = tlwe.encrypt_bool(jax.random.key(2), jnp.asarray(bits),
                            params.tlwe_lv0.alpha, sk.key_lv0,
                            width=params.torus_bits)
    if B == 1:
        cts = cts[:, 0]

    def run():
        return jax.block_until_ready(S.evaluate(plan, cts, ck))

    t0 = time.time()
    out = run()
    print(f"# compile+first run: {time.time()-t0:.1f}s", file=sys.stderr)
    t0 = time.time()
    out = run()
    dt = time.time() - t0

    dec = np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))
    if B == 1:
        dec = dec[:, None]
    ok = 0
    for j in range(B):
        got = sum(int(v) << i for i, v in enumerate(dec[:, j]))
        ok += got == int(a_vals[j]) * int(b_vals[j])
    acc = ok / B
    print(f"# accuracy: {acc:.4f} ({ok}/{B} exact {w}x{w} products)",
          file=sys.stderr)
    print(f"# warm eval: {dt*1e3:.0f} ms total, {dt/plan.n_levels*1e3:.1f} "
          f"ms/level, {boot_gates*B/dt:.0f} bootstrapped gates/s at depth "
          f"{plan.n_levels}", file=sys.stderr)
    print(json.dumps({
        "metric": f"bristol_mult{w}_gates_per_s_{pname}_batch{B}",
        "value": round(boot_gates * B / dt, 1),
        "unit": "gates/s",
        "accuracy": acc,
        "levels": plan.n_levels,
        "ms_per_level": round(dt / plan.n_levels * 1e3, 2),
        "total_ms": round(dt * 1e3, 1),
    }))


if __name__ == "__main__":
    main()
