#!/usr/bin/env python
"""Radix (carry-decomposed) PBS benchmark: uint8 LUT evaluations/s.

The composed route (models/lut.py:bootstrap_lut_radix) is the production
path for message moduli 32-256 — the single-shot envelope at uint8 is
29% accuracy (docs/NOISE.md §8), the radix route measures 1.000.  The
reference defines the uint sets but cannot execute them (comptime-pinned
to the boolean set), so vs_baseline is null; the cost model is 3
blind-rotation lanes (1 multi-value mid + 2 select-family lanes) plus
2*m_hi factored multiplications per evaluation.

Env: BENCH_BATCH (default 512, the measured knee: 256 -> 643, 512 ->
663, 1024 -> 603 evals/s), BENCH_PARAMS (uint8), BENCH_ITERS (3),
BENCH_M (message modulus; default 2^security_bits for the uint sets,
256 otherwise — e.g. BENCH_PARAMS=128bit_t64 measures the SECURE radix
route on the 64-bit split-ring set, where steep mid tables ride exact
dedicated lanes per models/lut.py:mid_norm1_budget).
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

import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax.models import lut as L
from zig_tfhe_jax.ops.packing_keyswitch import gen_packing_ksk


def main():
    B = int(os.environ.get("BENCH_BATCH", "512"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))
    pname = os.environ.get("BENCH_PARAMS", "uint8")
    params = P.PARAMS_BY_NAME[pname]
    if params.torus_bits == 64:
        jax.config.update("jax_enable_x64", True)
    default_m = (1 << params.security_bits if pname.startswith("uint")
                 else 256)
    m = int(os.environ.get("BENCH_M", str(default_m)))
    w = params.torus_bits
    f = lambda x: (x * 5 + 1) % m

    t0 = time.time()
    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)
    # uint and 64-bit cloud keys embed the packing key by default now —
    # reuse it instead of building a second 200+ MB bank
    pksk = (ck.pksk if ck.pksk is not None
            else gen_packing_ksk(jax.random.key(2), sk.key_lv1, params))
    jax.block_until_ready((ck, pksk))
    print(f"# keygen+pksk: {time.time()-t0:.1f}s", file=sys.stderr)

    rng = np.random.default_rng(0)
    msgs = rng.integers(0, m, B)
    cts = L.encrypt_radix_message(jax.random.key(3), msgs, m,
                                  params.tlwe_lv0.alpha, sk.key_lv0,
                                  width=w)

    run = jax.jit(lambda lo, hi, ck, pksk: L.bootstrap_lut_radix(
        lo, hi, f, m, ck, pksk))

    _sync = jax.block_until_ready

    t0 = time.time()
    out = _sync(run(*cts, ck, pksk))
    print(f"# compile+first: {time.time()-t0:.1f}s", file=sys.stderr)

    dec = np.asarray(L.decrypt_radix_message(out, m, sk.key_lv0, width=w))
    exp = np.array([f(int(x)) for x in msgs])
    acc = float((dec == exp).mean())
    print(f"# accuracy: {acc:.4f}", file=sys.stderr)

    ts = []
    for _ in range(iters):
        t0 = time.time()
        _sync(run(*cts, ck, pksk))
        ts.append(time.time() - t0)
    dt = float(np.median(ts))
    per_s = B / dt
    # cost model: one eval = 1 multi-value mid rotation + the select
    # lanes, plus 2*m_hi factored multiplications and the packing matmul.
    # For m <= 128 the two select families interleave into ONE rotation
    # (models/lut.py: 2*n_blocks*64 <= N) -> 1+1 lanes; m = 256 stays
    # 1+2 (margin-blocked at m_hi=16 on N=1024).  A single-shot
    # (29%-accurate at uint8) bootstrap is 1 lane.
    m_hi = m // 16
    sel_lanes = 1 if 2 * m_hi * 64 <= params.N else 2
    tvs = L.radix_lut_testvecs(f, m, params)
    budget = L.mid_norm1_budget(ck)
    ded = sum(1 for fam in range(2) for h in range(m_hi)
              if L.factor_lut(tvs[fam, h], 16)[2] > budget)
    mid_lanes = (1 if ded < 2 * m_hi else 0) + ded
    print(f"# {dt*1e3:.0f} ms/batch of {B} ({dt/B*1e3:.1f} ms/eval, "
          f"{mid_lanes} mid + {sel_lanes} select rotation lanes, "
          f"{2*m_hi - ded} factored muls/eval)",
          file=sys.stderr)
    print(json.dumps({
        "metric": f"radix_lut_m{m}_evals_per_s_{pname}_batch{B}"
        if not pname.startswith("uint")
        else f"radix_lut_evals_per_s_{pname}_batch{B}",
        "value": round(per_s, 2),
        "unit": "evals/s",
        "vs_baseline": None,
        "accuracy": acc,
        "rotation_lanes_per_eval": mid_lanes + sel_lanes,
    }))


if __name__ == "__main__":
    main()
