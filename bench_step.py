#!/usr/bin/env python
"""Blind-rotate step timing probe (dev tool for perf iteration).

Times the FULL production blind rotation (the bench.py hot loop) with a
dummy zero cloud key (identical compute graph/shapes to a real key, no
6-minute keygen compile) and reports ms/step + projected gates/s.

Methodology: the per-call cost is the median of several calls, each
waited for with block_until_ready; the scan's hundreds of steps amortize
dispatch to noise level.

Usage:
  BENCH_BATCH=1536 ZTFHE_INV=i16cast python bench_step.py [params] [group]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"))

import jax

import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax.ops.blind_rotate import blind_rotate


def main():
    pname = sys.argv[1] if len(sys.argv) > 1 else "128bit"
    group = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    params = P.PARAMS_BY_NAME[pname]
    B = int(os.environ.get("BENCH_BATCH", "1536"))
    iters = int(os.environ.get("BENCH_ITERS", "5"))
    levels = os.environ.get("BENCH_LEVELS")
    if levels and "-" in levels:
        levels = tuple(int(x) for x in levels.split("-"))
    else:
        levels = int(levels) if levels else None

    bgbit = os.environ.get("BENCH_BGBIT")   # engine-gadget base override
    drop = os.environ.get("BENCH_DROP")     # BSK rounding-bits override
    ck = K.CloudKey.generate_no_ksk(params, group=group,
                                    decomp_levels=levels,
                                    engine_bgbit=int(bgbit) if bgbit else None,
                                    ntt_drop=int(drop) if drop else None)
    steps = (params.n0 + group - 1) // group
    rng = np.random.default_rng(0)
    # RANDOM key material passed as a jit ARGUMENT: a closed-over (or
    # all-zero) key becomes an XLA constant and the whole scan body
    # constant-folds away — measured 3x faster than reality.  Random int16
    # residues have production magnitudes; validity doesn't matter for
    # timing.
    import dataclasses as _dc
    ck = _dc.replace(
        ck, bsk_ntt=jnp.asarray(
            rng.integers(-30000, 30000, ck.bsk_ntt.shape).astype(np.int16)))
    tl = jnp.asarray(
        rng.integers(-2**31, 2**31, (B, params.n0 + 1)).astype(np.int32))

    @jax.jit
    def run(tl, ck):
        return blind_rotate(tl, ck.testvec, ck, params)

    t0 = time.time()
    jax.block_until_ready(run(tl, ck))
    print(f"# compile+first: {time.time()-t0:.1f}s", file=sys.stderr)

    ts = []
    for _ in range(iters):
        t0 = time.time()
        jax.block_until_ready(run(tl, ck))
        ts.append(time.time() - t0)
    dt = float(np.median(ts))
    ms_step = dt / steps * 1e3
    print(f"cfg params={pname} group={group} B={B} "
          f"levels={levels or 'default'} "
          f"bgbit={ck.bsk_bgbit} drop={ck.bsk_ntt_drop} "
          f"INV={os.environ.get('ZTFHE_INV', '(default)')} "
          f"UNROLL={os.environ.get('ZTFHE_UNROLL', '1')}")
    print(f"blind-rotate: {dt*1e3:.1f} ms total, {ms_step:.3f} ms/step "
          f"({steps} steps) -> ~{B/dt:.0f} blind-rotations/s")


if __name__ == "__main__":
    main()
