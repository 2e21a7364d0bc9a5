#!/usr/bin/env python
"""Exact 8-bit LUTs at (estimated) 128-bit security — the radix door.

The upstream reference DEFINES uint5-8 parameter sets for messages up to
m=256 but can never execute them (everything is comptime-pinned to the
boolean set, params.zig:386-416) — and the in-tree security estimator
shows those sets' lv1 noise discretizes to ZERO on a u32 torus anyway
(0-bit lv1 security, docs/SECURITY.md).  A single blind rotation also
cannot decode m > ~32 reliably at any secure N=1024 set (modswitch
physics, docs/NOISE.md §8).

This framework's answer is the width-64 radix tree-PBS
(docs/TORUS64.md §10): messages carry as (lo, hi) modulus-16 digits on
the N=2048 / 64-bit-torus set `SECURITY_128_BIT_T64` (estimator-pinned
139/137 gate-model bits), the per-hypothesis tables evaluate through
||q||_1-routed mid rotations, the candidates pack into one testvec via
the int64 packing key switch, and one select rotation over the hi digit
finishes the job.  Measured at m=64 and m=256: accuracy 1.0 under real
noise.

Usage:
  python examples/secure_wide_lut_demo.py [--params tiny_split|128bit_t64]
      [--m 64|128|256] [--batch 8]
  (tiny_split is the fast exact CPU run; 128bit_t64 is the real 128-bit
  set — background it on CPU, it is minutes of keygen.)
"""

import argparse
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

jax.config.update("jax_enable_x64", True)      # int64 carriers

import numpy as np

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax.models import lut as L


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="tiny_split")
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    params = P.PARAMS_BY_NAME[args.params]
    assert params.torus_bits == 64, "pick a 64-bit set (tiny_split/128bit_t64)"
    m, B = args.m, args.batch

    print(f"params: {params.name}  N={params.N}  torus=2^{params.torus_bits}"
          f"  message modulus m={m}")
    t0 = time.time()
    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)  # incl. pksk
    print(f"keygen (incl. int64 packing key, "
          f"{ck.pksk.nbytes / 1e6:.0f} MB): {time.time() - t0:.1f}s")

    # an S-box-ish function: affine over Z_m (any f: [0,m) -> [0,m) works)
    f = lambda x: (x * 57 + 19) % m

    rng = np.random.default_rng(1)
    msgs = rng.integers(0, m, B)
    alpha = params.tlwe_lv0.alpha
    ct_lo, ct_hi = L.encrypt_radix_message(jax.random.key(2), msgs, m,
                                           alpha, sk.key_lv0, width=64)
    t0 = time.time()
    out = L.bootstrap_lut_radix(ct_lo, ct_hi, f, m, ck, ck.pksk)
    dec = np.asarray(L.decrypt_radix_message(out, m, sk.key_lv0, width=64))
    dt = time.time() - t0
    want = np.array([f(int(x)) for x in msgs])
    n_ok = int((dec == want).sum())
    print(f"f(x) = 57x + 19 mod {m} over {B} encrypted inputs: "
          f"{n_ok}/{B} exact in {dt:.1f}s")
    for x, g, w in list(zip(msgs, dec, want))[:4]:
        print(f"  f({x}) -> {g} (expect {w})")
    if n_ok == B:
        print(f"SUCCESS: exact m={m} LUT through the radix tree-PBS")
    else:
        print("FAILURE")
        sys.exit(1)


if __name__ == "__main__":
    main()
