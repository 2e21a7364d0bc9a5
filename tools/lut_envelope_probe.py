#!/usr/bin/env python
"""Measure the single-shot programmable-bootstrap accuracy envelope of a
parameter set across message moduli.

Why: the security audit (docs/SECURITY.md) found the Uint2-8 sets —
where all multi-bit work was previously validated — have zero lv1
security (noiseless after u32 discretization).  The security-VALID sets
are the boolean family (80/110/128-bit) and the 64-bit set; this probe
pins what message modulus each actually supports single-shot at real
noise, so the "use the radix route on a secure set" recommendation rests
on a measurement instead of a noise model.

Model prediction at SECURITY_128_BIT (margin = 1/(4m)): sigma_total ~
sqrt(sigma_ms^2 + sigma_KS^2 + sigma_BR^2) ~ 2^-7.7 -> m=4 ~11 sigma,
m=8 ~5.4 sigma (solid), m=16 ~2.7 sigma (~99%), m=32 <1.4 sigma.

Usage: [BENCH_PARAMS=128bit] [BENCH_BATCH=2048] python
tools/lut_envelope_probe.py.  Prints one JSON line:
{"metric": "lut_envelope_<set>", "accuracy_by_m": {...}, ...}.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache"))

import jax


import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zig_tfhe_jax import key as K  # noqa: E402
from zig_tfhe_jax import params as P  # noqa: E402
from zig_tfhe_jax.models import lut as L  # noqa: E402


def main():
    pname = os.environ.get("BENCH_PARAMS", "128bit")
    B = int(os.environ.get("BENCH_BATCH", "2048"))
    params = P.PARAMS_BY_NAME[pname]
    w = params.torus_bits
    if w == 64:
        jax.config.update("jax_enable_x64", True)
    ms = [int(x) for x in os.environ.get(
        "BENCH_MS", "4,8,16,32").split(",")]

    sk = K.SecretKey.generate(jax.random.key(0), params)
    # optional key-config knobs: a finer engine gadget trades rotation
    # rows for a smaller key-amplified a-truncation term (the dominant
    # noise at the sets' defaults — docs/SECURITY.md "envelope")
    kw = {}
    if os.environ.get("BENCH_GROUP"):
        kw["group"] = int(os.environ["BENCH_GROUP"])
    if os.environ.get("BENCH_LEVELS"):
        la, lb = (int(x) for x in os.environ["BENCH_LEVELS"].split(","))
        kw["decomp_levels"] = (la, lb)
    if os.environ.get("BENCH_BGBIT"):
        kw["engine_bgbit"] = int(os.environ["BENCH_BGBIT"])
    ck = K.CloudKey.generate(jax.random.key(1), sk, params, **kw)
    jax.block_until_ready(ck)

    pbs = jax.jit(lambda c, tv, k: L.bootstrap_lut(c, tv, k))
    rng = np.random.default_rng(3)
    acc_by_m = {}
    for m in ms:
        f = lambda x: (x * 3 + 1) % m
        table = L.Generator.new(m, params).generate_lookup_table(f).as_jax()
        msgs = rng.integers(0, m, B)
        cts = L.encrypt_message(jax.random.key(4), jnp.asarray(msgs), m,
                                params.tlwe_lv0.alpha, sk.key_lv0, width=w)
        out = pbs(cts, table, ck)
        dec = np.asarray(L.decrypt_message(out, m, sk.key_lv0, width=w))
        acc = float((dec == np.vectorize(f)(msgs)).mean())
        acc_by_m[str(m)] = round(acc, 5)
        print(f"# m={m}: accuracy {acc:.5f} "
              f"({int(round((1 - acc) * B))}/{B} wrong)", file=sys.stderr)
    print(json.dumps({
        "metric": f"lut_envelope_{pname}",
        "unit": "accuracy",
        "batch": B,
        "accuracy_by_m": acc_by_m,
    }))


if __name__ == "__main__":
    main()
