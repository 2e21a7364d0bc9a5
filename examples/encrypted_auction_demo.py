#!/usr/bin/env python
"""Sealed-bid auction on encrypted bids: max + per-bidder win bits.

The auctioneer never sees a bid: bidders submit FheUint ciphertexts,
the server computes the winning price with an encrypted max tree and
each bidder's "did I win" bit with encrypted equality — all exact
compositions of programmable bootstraps (models/integer.py).  Only the
final results decrypt.

Run (CPU, ~2 min):  JAX_PLATFORMS=cpu python examples/encrypted_auction_demo.py
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
from zig_tfhe_jax.models.integer import FheUint  # noqa: E402


def main():
    pname = sys.argv[1] if len(sys.argv) > 1 else "tiny_uint"
    params = P.PARAMS_BY_NAME[pname]
    bids = [23, 57, 41, 12]
    print(f"=== Encrypted sealed-bid auction on {pname}: bids {bids} ===\n")

    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)

    import jax.numpy as jnp
    import numpy as np

    # ONE batched ciphertext of all bids: every PBS round below runs all
    # lanes at once (the layer's batch-first discipline)
    cts = FheUint.encrypt(jax.random.key(10), np.array(bids), 2, sk, ck)

    t0 = time.time()
    # max tree, halving the batch per level (2 levels for 4 bidders)
    lo = FheUint(cts.digits[0:2], ck)
    hi = FheUint(cts.digits[2:4], ck)
    semi = lo.max(hi)                                  # [2, ...] batched max
    winning = FheUint(semi.digits[0:1], ck).max(FheUint(semi.digits[1:2], ck))
    # per-bidder win bit: all four equality checks in ONE batched eq
    bcast = FheUint(
        jnp.broadcast_to(winning.digits, cts.digits.shape), ck)
    wins = cts == bcast
    price = int(winning.decrypt(sk)[0])
    flags = [int(f) for f in wins.decrypt(sk)]
    dt = time.time() - t0

    expected_price = max(bids)
    expected_flags = [int(b == expected_price) for b in bids]
    print(f"winning price: {price} (expected {expected_price})")
    print(f"win flags:     {flags} (expected {expected_flags})")
    ok = price == expected_price and flags == expected_flags
    print(f"-> {'OK' if ok else 'WRONG'} [{dt:.1f}s]")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
