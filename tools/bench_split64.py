#!/usr/bin/env python
"""Benchmark the even/odd split-ring engine: N=2048 / 64-bit-torus gates.

Measures bootstrapped-gate throughput at SECURITY_128_BIT_T64 (the
estimator-pinned N=2048 set, docs/TORUS64.md §6) and prints ONE JSON
line:

  {"metric": "split64_gates_per_s", "value": N, "unit": "gates/s",
   "accuracy": x, "ms_per_step": y, "vs_32bit_projection": z}

TORUS64.md §5 projected ~3.8x per-gate cost vs the 32-bit path (~1,600
gates/s against the 6,042 shipped); this script replaces the projection
with a measurement.  BENCH_MODE=lut instead measures the capability
flagship: single-shot m=64 programmable bootstraps (ONE rotation — the
32-bit path radix-decomposes past m=32; metric split64_lut64_evals_per_s).
Env knobs: BENCH_BATCH (default 512), BENCH_ITERS (default 3),
BENCH_PARAMS (default 128bit_t64; tiny_split for a smoke run).
Requires jax_enable_x64 (set below — int64 carriers).
"""

import json
import os
import sys
import time

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache"))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import gates as G


def run_lut64(params, sk, ck, B, iters, name):
    """Single-shot m=64 PBS: the 64-bit set's capability flagship."""
    from zig_tfhe_jax.models import lut as L

    m = 64
    f = lambda x: (x * 3 + 1) % m
    gen = L.Generator.new(m, params)
    table = gen.generate_lookup_table(f).as_jax()
    rng = np.random.default_rng(11)
    msgs = rng.integers(0, m, B)
    cts = L.encrypt_message(jax.random.key(5), jnp.asarray(msgs), m,
                            params.tlwe_lv0.alpha, sk.key_lv0, width=64)
    pbs = jax.jit(lambda c, tv, k: L.bootstrap_lut(c, tv, k))
    t0 = time.time()
    out = jax.block_until_ready(pbs(cts, table, ck))
    print(f"[split64] lut64 first call {time.time() - t0:.1f}s",
          file=sys.stderr)
    dec = np.asarray(L.decrypt_message(out, m, sk.key_lv0, width=64))
    acc = float((dec == np.vectorize(f)(msgs)).mean())
    times = []
    for _ in range(iters):
        t0 = time.time()
        jax.block_until_ready(pbs(cts, table, ck))
        times.append(time.time() - t0)
    dt = min(times)
    print(f"[split64] lut64 {dt * 1e3:.1f} ms/batch, "
          f"{B / dt:.1f} evals/s, accuracy {acc:.4f}", file=sys.stderr)
    print(json.dumps({
        "metric": "split64_lut64_evals_per_s",
        "value": round(B / dt, 1),
        "unit": "evals/s",
        "accuracy": acc,
        "batch": B,
        "params": name,
        "rotation_lanes_per_eval": 1,
    }))


def main():
    name = os.environ.get("BENCH_PARAMS", "128bit_t64")
    params = P.PARAMS_BY_NAME[name]
    B = int(os.environ.get("BENCH_BATCH", "512"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))
    print(f"[split64] params={name} N={params.N} n0={params.n0} "
          f"B={B}", file=sys.stderr)

    t0 = time.time()
    sk = K.SecretKey.generate(jax.random.key(0), params)
    group = os.environ.get("BENCH_GROUP")      # default: per-set (2)
    drop = os.environ.get("BENCH_DROP")        # e.g. 37: the gates-only
    # 3-prime plan (trades the m<=32 LUT envelope for fewer matmul
    # passes; opt-in key, never the default)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params,
                             group=int(group) if group else None,
                             ntt_drop=int(drop) if drop else None)
    jax.block_until_ready(ck.bsk_ntt)
    print(f"[split64] keygen {time.time() - t0:.1f}s "
          f"bsk {ck.bsk_ntt.shape} {ck.bsk_ntt.nbytes / 1e6:.0f} MB",
          file=sys.stderr)

    if os.environ.get("BENCH_MODE", "").strip().lower() == "lut":
        run_lut64(params, sk, ck, B, iters, name)
        return

    rng = np.random.default_rng(7)
    xs = rng.integers(0, 2, B).astype(bool)
    ys = rng.integers(0, 2, B).astype(bool)
    ca = tlwe.encrypt_bool(jax.random.key(2), jnp.asarray(xs),
                           params.tlwe_lv0.alpha, sk.key_lv0, width=64)
    cb = tlwe.encrypt_bool(jax.random.key(3), jnp.asarray(ys),
                           params.tlwe_lv0.alpha, sk.key_lv0, width=64)

    # ck rides as a jit ARGUMENT (CloudKey is a pytree): closing over it
    # would embed the ~377 MB BSK in the program as an HLO constant.
    nand_fn = jax.jit(lambda a, b, k: G.nand(a, b, k))
    t0 = time.time()
    out = jax.block_until_ready(nand_fn(ca, cb, ck))
    print(f"[split64] first call (compile+run) {time.time() - t0:.1f}s",
          file=sys.stderr)

    dec = np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))
    acc = float((dec == ~(xs & ys)).mean())
    print(f"[split64] accuracy {acc:.4f}", file=sys.stderr)

    times = []
    for _ in range(iters):
        t0 = time.time()
        jax.block_until_ready(nand_fn(ca, cb, ck))
        times.append(time.time() - t0)
    dt = min(times)
    gps = B / dt
    steps = -(-params.n0 // ck.bsk_group)    # scan steps (group-g folds g)
    ms_step = dt / steps * 1e3
    print(f"[split64] {dt * 1e3:.1f} ms/batch, {ms_step:.3f} ms/step, "
          f"{gps:.1f} gates/s", file=sys.stderr)
    print(json.dumps({
        "metric": "split64_gates_per_s",
        "value": round(gps, 1),
        "unit": "gates/s",
        "accuracy": acc,
        "ms_per_step": round(ms_step, 3),
        "batch": B,
        "params": name,
        "group": ck.bsk_group,
        "ntt_drop": ck.bsk_ntt_drop,
        "vs_32bit_projection": round(gps / 1600.0, 2),
    }))


if __name__ == "__main__":
    main()
