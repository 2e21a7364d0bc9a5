#!/usr/bin/env python
"""Diagnose the 64-bit split-engine LUT phase-error distribution.

The m=64 single-shot LUT at SECURITY_128_BIT_T64 measured accuracy 0.52
at the basebit4 KS (sigma_KS = 2^-8.0 — understood, fixed) but only 0.72
at the basebit2 KS where the noise model predicts ~0.94.  The residual
pattern fits a systematic phase BIAS of ~0.65 half-bins (2^-8.6 of the
torus) on top of ~2^-8.8 noise.  This probe decrypts the raw PHASE error
of the LUT output against the exact expected encoding and reports
mean/std/quantiles — bias shows up as a nonzero mean, a noise-model gap
as std.

Also probes WHERE the bias enters: --stage controls how far the pipeline
runs (br = blind rotate + extract only, decode at lv1; full = + key
switch).  Usage: python tools/split_phase_probe.py [--stage full|br]
[BENCH_BATCH=512] [BENCH_PARAMS=128bit_t64] [BENCH_M=64].
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache"))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zig_tfhe_jax import key as K  # noqa: E402
from zig_tfhe_jax import params as P  # noqa: E402
from zig_tfhe_jax import tlwe  # noqa: E402
from zig_tfhe_jax.models import lut as L  # noqa: E402


def main():
    stage = "br" if "--stage" in sys.argv and "br" in sys.argv else \
        os.environ.get("PROBE_STAGE", "full")
    pname = os.environ.get("BENCH_PARAMS", "128bit_t64")
    B = int(os.environ.get("BENCH_BATCH", "512"))
    m = int(os.environ.get("BENCH_M", "64"))
    params = P.PARAMS_BY_NAME[pname]
    w = params.torus_bits

    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)
    jax.block_until_ready(ck)

    f = lambda x: (x * 3 + 1) % m
    gen = L.Generator.new(m, params)
    table = gen.generate_lookup_table(f).as_jax()
    rng = np.random.default_rng(11)
    msgs = rng.integers(0, m, B)
    cts = L.encrypt_message(jax.random.key(5), jnp.asarray(msgs), m,
                            params.tlwe_lv0.alpha, sk.key_lv0, width=w)

    if stage == "br":
        def _br_to_lv1(c, tv, k):
            from zig_tfhe_jax import trlwe as _trlwe
            from zig_tfhe_jax.ops.blind_rotate import blind_rotate
            tr = blind_rotate(c, tv, k, k.params)
            return _trlwe.sample_extract(tr, 0)
        run = jax.jit(_br_to_lv1)
        out = np.asarray(run(cts, table, ck))
        key = sk.key_lv1
    else:
        run = jax.jit(lambda c, tv, k: L.bootstrap_lut(c, tv, k))
        out = np.asarray(run(cts, table, ck))
        key = sk.key_lv0

    ph = np.asarray(tlwe.phase(jnp.asarray(out), key))        # int64
    exp = np.array([gen.encoder.encode(f(int(x))) for x in msgs],
                   np.uint64).astype(np.int64)
    err = (ph - exp).astype(np.int64)                          # wraps ok
    frac = err.astype(np.float64) / float(1 << 63) / 2.0       # of torus
    half_bin = 1.0 / (4 * m)
    q = np.quantile(frac, [0.01, 0.25, 0.5, 0.75, 0.99])
    print(f"stage={stage} params={pname} m={m} B={B}")
    print(f"phase error (torus fraction): mean {frac.mean():+.3e} "
          f"(= {frac.mean()/half_bin:+.2f} half-bins), "
          f"std {frac.std():.3e} (= {frac.std()/half_bin:.2f} half-bins)")
    print("quantiles 1/25/50/75/99%:",
          " ".join(f"{v:+.3e}" for v in q))
    acc = float((np.abs(frac) < half_bin).mean())
    print(f"|err| < half-bin: {acc:.4f}")
    # bias per blind-rotate step, if the mean is the story
    steps = -(-params.n0 // ck.bsk_group)
    print(f"mean / step ({steps} steps): {frac.mean()/steps:+.3e} "
          f"(2^{np.log2(abs(frac.mean()/steps) + 1e-300):.1f})")


if __name__ == "__main__":
    main()
