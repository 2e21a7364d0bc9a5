#!/usr/bin/env python
"""Add Two Numbers — homomorphic 16-bit addition (402 + 304 = 706).

Port-equivalent of examples/add_two_numbers.zig, batch-first: stage-1 gates
of the adder run as single batched bootstraps, and a Kogge-Stone variant
shows the batched log-depth carry (use --adder=kogge).

Usage:
  python examples/add_two_numbers.py [--params 128bit] [--adder kogge|ripple]
  (use --params tiny for a fast exact CPU run)
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

from zig_tfhe_jax import key as K, params as P  # noqa: E402
from zig_tfhe_jax.models import circuits as C, gates as G  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="128bit", choices=sorted(P.PARAMS_BY_NAME))
    ap.add_argument("--adder", default="kogge", choices=["kogge", "ripple"])
    ap.add_argument("--a", type=int, default=402)
    ap.add_argument("--b", type=int, default=304)
    args = ap.parse_args()
    params = P.PARAMS_BY_NAME[args.params]

    print("=== TFHE Add Two Numbers ===\n")
    t0 = time.time()
    print("Generating keys...")
    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)
    jax.block_until_ready(ck)   # keygen time is not the first run's
    print(f"Keys generated in {time.time()-t0:.1f}s\n")

    a, b = args.a, args.b
    expected = (a + b) % (1 << 16)
    print(f"A = {a}, B = {b}, expected sum = {expected}")

    ct_a = C.encrypt_bits(jax.random.key(2), a, 16, sk, params)
    ct_b = C.encrypt_bits(jax.random.key(3), b, 16, sk, params)

    rounds = (2 + 2 * 4) if args.adder == "kogge" else (1 + 2 * 16)

    @jax.jit
    def _add_jit(xa, xb, k):
        # the whole adder is ONE jitted graph: a single device dispatch
        if args.adder == "kogge":
            return C.kogge_stone_add(xa, xb, k)[0]
        cin = G.constant(False, params, batch=(1,))
        return C.ripple_carry_add(xa, xb, cin, k)[0]

    def run_add(xa, xb):
        return _add_jit(xa, xb, ck), rounds

    t0 = time.time()
    ct_sum, rounds = run_add(ct_a, ct_b)
    jax.block_until_ready(ct_sum)
    dt_cold = time.time() - t0

    t0 = time.time()                      # warm: all shapes compiled above
    ct_sum, _ = run_add(ct_a, ct_b)
    jax.block_until_ready(ct_sum)
    dt = time.time() - t0

    result = C.decrypt_bits(ct_sum, sk)
    print(f"\nHomomorphic sum = {result}  ({'OK' if result == expected else 'WRONG'})")
    print(f"Adder: {args.adder}, ~{rounds} batched bootstrap rounds, "
          f"{dt*1000:.0f} ms warm ({dt*1000/rounds:.0f} ms/round; "
          f"first run incl. compiles: {dt_cold*1000:.0f} ms)")
    print("Reference (zig-tfhe, M-series CPU): 2985 ms for the same addition")
    if result != expected:
        sys.exit(1)


if __name__ == "__main__":
    main()
