#!/usr/bin/env python
"""Serving-level throughput: one circuit plan, many clients per arena.

Schedules a 16-bit ripple-carry adder once (native C++ scheduler), then
evaluates it over a batch of B independent client input pairs in one
arena pass — every level's gates fuse across the batch, so per-client
cost rides the batched-bootstrap throughput curve instead of the
circuit's own width.

Reference point: the reference evaluates ONE 16-bit addition in 2985 ms
(CHANGELOG.md:87), strictly sequentially.

Env: BENCH_BATCH clients (default 64), BENCH_ITERS (default 3),
     BENCH_PARAMS (default 128bit).
Prints one JSON line.
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

BITS = 16


def adder_plan():
    c = S.Circuit()
    a = [c.input() for _ in range(BITS)]
    b = [c.input() for _ in range(BITS)]
    carry = None
    outs = []
    for i in range(BITS):
        x = c.gate("xor", a[i], b[i])
        g = c.gate("and", a[i], b[i])
        if carry is None:
            outs.append(c.copy(x))
            carry = g
        else:
            outs.append(c.gate("xor", x, carry))
            t = c.gate("and", x, carry)
            carry = c.gate("or", g, t)
    outs.append(carry)
    for w in outs:
        c.output(w)
    return c.schedule()


def main():
    B = int(os.environ.get("BENCH_BATCH", "64"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))
    pname = os.environ.get("BENCH_PARAMS", "128bit")
    params = P.PARAMS_BY_NAME[pname]

    plan = adder_plan()
    print(f"# plan: {plan.n_gates} gates, {plan.n_levels} levels, "
          f"{plan.n_slots} slots", file=sys.stderr)

    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)
    jax.block_until_ready(ck)

    rng = np.random.default_rng(0)
    av = rng.integers(0, 1 << BITS, B)
    bv = rng.integers(0, 1 << BITS, B)
    bits = np.zeros((2 * BITS, B), bool)
    for i in range(BITS):
        bits[i] = (av >> i) & 1
        bits[BITS + i] = (bv >> i) & 1
    cts = tlwe.encrypt_bool(jax.random.key(2), jnp.asarray(bits),
                            params.tlwe_lv0.alpha, sk.key_lv0)

    run = jax.jit(lambda c, k: S.evaluate(plan, c, k))

    _sync = jax.block_until_ready

    t0 = time.time()
    out = _sync(run(cts, ck))
    print(f"# compile+first: {time.time()-t0:.1f}s", file=sys.stderr)

    dec = np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))
    got = sum(dec[i].astype(np.int64) << i for i in range(BITS + 1))
    expect = (av + bv) & ((1 << (BITS + 1)) - 1)
    acc = float((got == expect).mean())
    print(f"# accuracy: {acc:.4f}", file=sys.stderr)

    ts = []
    for _ in range(iters):
        t0 = time.time()
        _sync(run(cts, ck))
        ts.append(time.time() - t0)
    dt = float(np.median(ts))
    adds_per_s = B / dt
    print(f"# {dt*1e3:.0f} ms for {B} adds "
          f"({dt/B*1e3:.2f} ms/client-add; reference single add 2985 ms)",
          file=sys.stderr)
    print(json.dumps({
        "metric": f"encrypted_16bit_adds_per_s_{pname}_clients{B}",
        "value": round(adds_per_s, 2),
        "unit": "adds/s",
        "vs_baseline": round(adds_per_s / (1000.0 / 2985.0), 2),
        "accuracy": acc,
    }))


if __name__ == "__main__":
    main()
