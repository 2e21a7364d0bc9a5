#!/usr/bin/env python
"""Encrypted integer arithmetic: a*b + c, compares, division, signed ints.

Every operation is a composition of programmable bootstraps
(models/integer.py): digit products via the bit-plane packing trick,
carry/borrow chains via mod/div LUT pairs, division by restoring
shift-subtract, signed (FheInt) compares via sign-bias flips — all
exact.  The reference defines multi-bit parameter sets but has no
integer layer at all.

Run (CPU, ~4 min):  JAX_PLATFORMS=cpu python examples/integer_arithmetic_demo.py
"""

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


from zig_tfhe_jax import key as K  # noqa: E402
from zig_tfhe_jax import params as P  # noqa: E402
from zig_tfhe_jax.models import integer as I  # noqa: E402


def main():
    pname = sys.argv[1] if len(sys.argv) > 1 else "tiny_uint"
    params = P.PARAMS_BY_NAME[pname]
    a_val, b_val, c_val = 23, 45, 100
    print(f"=== Encrypted integer arithmetic on {pname}: "
          f"{a_val} * {b_val} + {c_val} ===\n")

    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)

    ca = I.encrypt_radix(jax.random.key(2), a_val, 2, params.tlwe_lv0.alpha,
                         sk.key_lv0)
    cb = I.encrypt_radix(jax.random.key(3), b_val, 2, params.tlwe_lv0.alpha,
                         sk.key_lv0)
    cc = I.encrypt_radix(jax.random.key(4), c_val, 4, params.tlwe_lv0.alpha,
                         sk.key_lv0)

    t0 = time.time()
    prod = I.radix_mul(ca, cb, ck)                  # 4 digits
    total = I.radix_add(prod, cc, ck)[:4]           # a*b + c < 8^4
    result = I.decrypt_radix(total, sk.key_lv0)
    dt = time.time() - t0

    expected = a_val * b_val + c_val
    status = "OK" if result == expected else "WRONG"
    print(f"decrypted: {result} (expected {expected}) -> {status} "
          f"[{dt:.1f}s]")

    # same computation through the high-level FheUint handles
    fa = I.FheUint(ca, ck)
    fb = I.FheUint(cb, ck)
    fc = I.FheUint(cc, ck)
    hi_result = (fa * fb + fc).decrypt(sk)
    hi_status = "OK" if hi_result == expected else "WRONG"
    print(f"FheUint:   (a * b + c).decrypt() = {hi_result} -> {hi_status}")

    # comparisons, min/max, division, signed values
    lt = (fa < fb).decrypt(sk)
    mx = fa.max(fb).decrypt(sk)
    q, r = divmod(fb, fa)
    qv, rv = q.decrypt(sk), r.decrypt(sk)
    print(f"compare:   (a < b) = {lt}, max = {mx}, "
          f"b // a = {qv} rem {rv}")
    sx = I.FheInt.encrypt(jax.random.key(5), -21, 2, sk, ck)
    sy = I.FheInt.encrypt(jax.random.key(6), 13, 2, sk, ck)
    ssum = (sx + sy).decrypt(sk)
    sq, sr = sx.div_rem(sy)
    sqv, srv = sq.decrypt(sk), sr.decrypt(sk)
    print(f"FheInt:    -21 + 13 = {ssum}, -21 div_rem 13 = ({sqv}, {srv})")
    extras_ok = (lt == 1 and mx == 45 and (qv, rv) == (1, 22)
                 and ssum == -8 and (sqv, srv) == (-1, -8))
    print("extras OK" if extras_ok else "extras WRONG")
    sys.exit(0 if (result == expected == hi_result and extras_ok) else 1)


if __name__ == "__main__":
    main()
