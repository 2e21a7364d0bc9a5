#!/usr/bin/env python
"""Proxy re-encryption benchmarks vs the reference's headline numbers.

Reference (Apple Silicon, PROXY_REENC.md / CHANGELOG.md):
  public key generation   ~1.6 ms
  asymmetric re-enc keygen ~1.7 s
  symmetric re-enc keygen  ~20 ms
  single re-encryption     ~1.1 ms

Here re-encryption is a batched digit-decompose + int8-limb matmul
(ops/keyswitch.py), so the headline metric is reencryptions/s at a batch
size, plus amortized per-op latency.  Prints one JSON line.

Env: BENCH_BATCH (default 4096), BENCH_PARAMS (default 128bit).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# persistent compilation cache: repeat runs skip the compiles
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"))

import jax

import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import proxy_reenc as PRE

REF_REENC_PER_S = 1000.0 / 1.1  # ~909/s (PROXY_REENC.md:223)


def timed(fn, *args, iters=3):
    """(median_seconds, result): the warmup call's value is returned so
    callers don't recompute the (expensive) op one more time."""
    result = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.time()
        jax.block_until_ready(fn(*args))
        ts.append(time.time() - t0)
    return float(np.median(ts)), result


def main():
    B = int(os.environ.get("BENCH_BATCH", "4096"))
    pname = os.environ.get("BENCH_PARAMS", "128bit")
    params = P.PARAMS_BY_NAME[pname]

    sk_a = K.SecretKey.generate(jax.random.key(0), params)
    sk_b = K.SecretKey.generate(jax.random.key(1), params)

    # warm timings: first call per shape pays the (remote) compile
    t_pk, pk_b = timed(
        lambda k: PRE.PublicKeyLv0.generate(k, sk_b.key_lv0, params),
        jax.random.key(2))
    t_asym, rk_asym = timed(lambda k: PRE.ProxyReencryptionKey.new_asymmetric(
        k, sk_a.key_lv0, pk_b, params), jax.random.key(3))
    t_sym, _ = timed(lambda k: PRE.ProxyReencryptionKey.new_symmetric(
        k, sk_a.key_lv0, sk_b.key_lv0, params), jax.random.key(4))

    bits = jnp.asarray(np.random.default_rng(0).integers(0, 2, B).astype(bool))
    ct = tlwe.encrypt_bool(jax.random.key(5), bits, params.tlwe_lv0.alpha,
                           sk_a.key_lv0)
    reenc = jax.jit(lambda c, k: PRE.reencrypt(c, k))
    dt, out = timed(reenc, ct, rk_asym)
    acc = float((np.asarray(tlwe.decrypt_bool(out, sk_b.key_lv0))
                 == np.asarray(bits)).mean())

    per_s = B / dt
    print(f"# public keygen: {t_pk*1e3:.1f} ms (ref ~1.6 ms)", file=sys.stderr)
    print(f"# asym re-enc keygen: {t_asym*1e3:.0f} ms (ref ~1700 ms)",
          file=sys.stderr)
    print(f"# sym re-enc keygen: {t_sym*1e3:.1f} ms (ref ~20 ms)",
          file=sys.stderr)
    print(f"# reencrypt: {dt/B*1e6:.1f} us/op at batch {B} "
          f"({per_s:.0f}/s), accuracy {acc:.4f}", file=sys.stderr)
    print(json.dumps({
        "metric": f"pre_reencryptions_per_s_{pname}_batch{B}",
        "value": round(per_s, 1),
        "unit": "reenc/s",
        "vs_baseline": round(per_s / REF_REENC_PER_S, 2),
        "accuracy": acc,
        "pk_keygen_ms": round(t_pk * 1e3, 1),
        "asym_keygen_ms": round(t_asym * 1e3, 1),
        "sym_keygen_ms": round(t_sym * 1e3, 1),
    }))


if __name__ == "__main__":
    main()
