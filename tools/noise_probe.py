#!/usr/bin/env python
"""Measure the OUTPUT phase-noise sigma of a bootstrapped gate per config.

The gate-failure model: a chained NAND's decision phase is
(1/8 - x - y) + modswitch rounding, with x, y bootstrapped outputs of
noise sigma_out each, so failure ~ P(|N(0, 2*sigma_out^2 + sigma_ms^2)|
> 2^29 margin).  This probe decrypts the PHASE of gate outputs (not just
the sign), prints sigma_out in bits (log2 of torus*2^32 units), and the
implied chained-gate failure probability — the number that must support
accuracy 1.0 at batch 4096 (needs margin/sigma_eff >= ~4.3).

Usage:  python tools/noise_probe.py "levels,drop[,group]" ...
        (each arg one config; levels/drop empty = default)
Env: PROBE_BATCH (default 4096), PROBE_PARAMS (default 128bit).
"""

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
from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import gates as G

MARGIN = 1 << 29  # distance from the +-1/8 decision phase to the boundary


def probe(params, B, levels, drop, group):
    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params,
                             ntt_drop=drop, decomp_levels=levels,
                             group=group)
    rng = np.random.default_rng(7)
    bits_a = jnp.asarray(rng.integers(0, 2, B).astype(bool))
    bits_b = jnp.asarray(rng.integers(0, 2, B).astype(bool))
    cta = tlwe.encrypt_bool(jax.random.key(2), bits_a,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(3), bits_b,
                            params.tlwe_lv0.alpha, sk.key_lv0)
    nand = jax.jit(lambda a, b, k: G.gate("nand", a, b, k))
    out = nand(cta, ctb, ck)
    ph = np.asarray(tlwe.phase(out, sk.key_lv0)).astype(np.int64)
    expected = ~(np.asarray(bits_a) & np.asarray(bits_b))
    ideal = np.where(expected, 1 << 29, -(1 << 29))  # +-1/8 of 2^32
    err = ((ph - ideal + (1 << 31)) % (1 << 32)) - (1 << 31)
    sigma = float(err.std())
    # second generation: feed outputs back through another gate (captures
    # the sqrt(2) input stacking exactly as the bench chain would)
    out2 = nand(out, out[::-1], ck)
    dec2 = np.asarray(tlwe.decrypt_bool(out2, sk.key_lv0))
    exp2 = ~(expected & expected[::-1])
    acc2 = float((dec2 == exp2).mean())
    # modswitch sigma from the NOISE.md model (inherent)
    n0 = params.n0
    sigma_ms = math.sqrt((n0 / 2 + 1) / 12.0) * (1 << (32 - params.nbit - 1))
    sigma_eff = math.sqrt(2 * sigma * sigma + sigma_ms * sigma_ms)
    ratio = MARGIN / sigma_eff
    # two-sided normal tail
    pfail = math.erfc(ratio / math.sqrt(2.0))
    return dict(sigma_bits=math.log2(sigma), sigma_ms_bits=math.log2(sigma_ms),
                ratio=ratio, pfail_per_gate=pfail,
                exp_fails_b4096=pfail * 4096, acc_gen2=acc2,
                max_err_bits=math.log2(max(1, np.abs(err).max())))


def main():
    B = int(os.environ.get("PROBE_BATCH", "4096"))
    params = P.PARAMS_BY_NAME[os.environ.get("PROBE_PARAMS", "128bit")]
    configs = sys.argv[1:] or ["2,6", "3,7"]
    for cfg in configs:
        parts = (cfg.split(",") + ["", ""])[:3]
        if "-" in parts[0]:
            levels = tuple(int(x) for x in parts[0].split("-"))
        else:
            levels = int(parts[0]) if parts[0] else None
        drop = int(parts[1]) if parts[1] else None
        group = int(parts[2]) if parts[2] else 2
        r = probe(params, B, levels, drop, group)
        print(f"levels={levels} drop={drop} group={group} B={B}: "
              f"sigma_out=2^{r['sigma_bits']:.2f} (max 2^{r['max_err_bits']:.1f}) "
              f"sigma_ms=2^{r['sigma_ms_bits']:.2f} margin/sigma_eff={r['ratio']:.2f} "
              f"E[fails@4096]={r['exp_fails_b4096']:.2f} gen2_acc={r['acc_gen2']:.4f}",
              flush=True)


if __name__ == "__main__":
    main()
