#!/usr/bin/env python
"""Measure the CIM17 ||q||_1 amplification directly (the mid_norm1_budget
calibration, models/lut.py).

For a factored multi-value bootstrap the output's amplitude error is
||q||_1 * sigma_1, where sigma_1 is the per-unit-norm blind-rotation
amplitude error (truncation + key rounding, subset-combined).  This
probe builds tables of controlled ||q||_1 (x -> (k*x) mod 16 has jumps
of +-k), runs them through the REAL factored route at real noise,
decrypts the lv1 phase error against the exact encoding, and reports
sigma per table — the fit pins sigma_1 and validates the linear model
the budget rests on.

Round-5 calibration origin: the analytic sigma_1 was 2^-12.7; the first
live m=256 failure implied ~2^-11.3 (the group-2 subset combiner's
(X^t1-1)(X^t2-1) term), and MID_SIGMA_CAL=4 covers it with margin.

Env: BENCH_PARAMS (default 128bit_t64), BENCH_BATCH (default 256).
Prints one JSON line with sigma_rel (log2, per table norm) and the
fitted per-unit-norm sigma.
"""

import json
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                 ".jax_cache"))

import jax


import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax import tlwe, trlwe
from zig_tfhe_jax.models import lut as L
from zig_tfhe_jax.ops.blind_rotate import blind_rotate


def main():
    pname = os.environ.get("BENCH_PARAMS", "128bit_t64")
    params = P.PARAMS_BY_NAME[pname]
    if params.torus_bits == 64:
        jax.config.update("jax_enable_x64", True)
    B = int(os.environ.get("BENCH_BATCH", "64"))
    w = params.torus_bits

    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params,
                             packing_key=False)

    gen = L.Generator.new(16, params)
    rng = np.random.default_rng(0)
    msgs = rng.integers(0, 16, B)
    ct = tlwe.encrypt_message(jax.random.key(2), jnp.asarray(msgs), 16,
                              params.tlwe_lv0.alpha, sk.key_lv0, w)

    base = jnp.asarray(L.multi_lut_base(16, params.N, w))

    results = {}
    mask = (1 << w) - 1
    half = 1 << (w - 1)
    slopes = (1, 3, 5, 7)
    tables = [gen.generate_lookup_table(lambda x, k=k: (k * x) % 16)
              for k in slopes]
    facts = [L.factor_lut(tv, 16) for tv in tables]

    @jax.jit
    def run(c, key_lv1, k):
        acc = blind_rotate(c, base, k, params)
        phs = []
        for offs, coeffs, _ in facts:
            out = L.apply_factored(acc, offs, coeffs)
            lv1 = trlwe.sample_extract(out, 0)
            phs.append(tlwe.phase(lv1, key_lv1))
        return jnp.stack(phs)                      # [n_tables, B]

    all_ph = np.asarray(jax.block_until_ready(run(ct, sk.key_lv1, ck)))
    for ki, k in enumerate(slopes):
        offs, coeffs, n1 = facts[ki]
        ph = all_ph[ki].astype(np.int64)
        exp = np.array([gen.encoder.encode((k * int(m)) % 16) for m in msgs],
                       np.uint64)
        err = ((ph.astype(np.uint64) - exp + half) & mask).astype(np.int64) \
            - half
        sig = float(np.std(err)) / 2.0 ** w
        results[n1] = sig
        print(f"# slope {k}: norm1={n1} sigma=2^{math.log2(sig):.2f} "
              f"(per-unit 2^{math.log2(sig / n1):.2f})", file=sys.stderr)

    norms = np.array(sorted(results))
    sigs = np.array([results[n] for n in norms])
    unit = float(np.sum(sigs * norms) / np.sum(norms * norms))
    analytic = math.log2(2.0 ** -(8 * 2 + 1) * math.sqrt(
        -(-params.n0 // ck.bsk_group)))
    print(json.dumps({
        "metric": f"cim17_per_unit_norm_sigma_{pname}",
        "value": round(math.log2(unit), 2),
        "unit": "log2(sigma_rel)",
        "by_norm1": {int(n): round(math.log2(results[n]), 2) for n in norms},
        "analytic_b_side_log2": round(analytic, 2),
        "budget_cal": 4.0,
    }))


if __name__ == "__main__":
    main()
