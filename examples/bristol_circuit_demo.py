#!/usr/bin/env python
"""Evaluate a Bristol-format boolean circuit homomorphically.

Synthesizes an 8-bit ripple-carry adder as old-style Bristol text
(header: `n_gates n_wires` / `n_in1 n_in2 n_out`; outputs are the last
n_out wires), parses and levels it with the native C++ scheduler
(native/circuit/scheduler.cc), then evaluates every level as one batched
heterogeneous bootstrap on encrypted inputs.

The reference has no circuit-file path at all — circuits are hand-written
gate calls (examples/add_two_numbers.zig:51-73); this demo is the
production "bring your own netlist" flow.

Run (CPU, ~1 min):  python examples/bristol_circuit_demo.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zig_tfhe_jax import key as K  # noqa: E402
from zig_tfhe_jax import params as P  # noqa: E402
from zig_tfhe_jax import tlwe  # noqa: E402
from zig_tfhe_jax.models import scheduler as S  # noqa: E402


def bristol_adder(nbits: int) -> str:
    """Old-format Bristol text for an nbits ripple-carry adder.

    Inputs: wires [0, nbits) = A (little-endian), [nbits, 2*nbits) = B.
    Outputs: the last nbits wires = SUM (carry-out dropped).
    """
    gates = []
    w = 2 * nbits          # next free wire

    def emit(op, *ins):
        nonlocal w
        out = w
        w += 1
        gates.append(f"{len(ins)} 1 {' '.join(map(str, ins))} {out} {op}")
        return out

    carry = None
    sums = []
    for i in range(nbits):
        a, b = i, nbits + i
        axb = emit("XOR", a, b)
        if carry is None:
            sums.append(axb)
            carry = emit("AND", a, b)
        else:
            sums.append(emit("XOR", axb, carry))
            t1 = emit("AND", a, b)
            t2 = emit("AND", axb, carry)
            carry = emit("OR", t1, t2)
    # route sum bits into the final nbits wires (outputs are last-by-index)
    for s_ in sums:
        emit("COPY", s_)
    header = f"{len(gates)} {w}\n{nbits} {nbits} {nbits}\n"
    return header + "\n".join(gates) + "\n"


def main():
    # DEMO_MULT=w evaluates the scheduler-scale Wallace-tree multiplier
    # netlist instead (models/netlists.py; w=64 is the ~27k-gate corpus
    # circuit — run it on the GPU via bench_circuit.py; w=8 is a ~1 min CPU
    # demo).  Default: the 8-bit adder below.
    mult_w = int(os.environ.get("DEMO_MULT", "0"))
    if mult_w:
        from zig_tfhe_jax.models.netlists import bristol_multiplier

        a_val, b_val = 202 % (1 << mult_w), 142 % (1 << mult_w)
        params = P.TEST_TINY
        print(f"{mult_w}x{mult_w} Bristol multiplier: {a_val} * {b_val}")
        text = bristol_multiplier(mult_w)
        plan = S.parse_bristol(text)
        print(f"scheduled: {plan.n_gates} gates in {plan.n_levels} levels")
        sk = K.SecretKey.generate(jax.random.key(0), params)
        ck = K.CloudKey.generate(jax.random.key(1), sk, params)
        bits = [(a_val >> i) & 1 for i in range(mult_w)] + \
               [(b_val >> i) & 1 for i in range(mult_w)]
        cts = tlwe.encrypt_bool(jax.random.key(2), jnp.asarray(bits, bool),
                                params.tlwe_lv0.alpha, sk.key_lv0)
        t0 = time.time()
        out = S.evaluate(plan, cts, ck)
        out_bits = np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))
        dt = time.time() - t0
        result = sum(int(b) << i for i, b in enumerate(out_bits))
        status = "OK" if result == a_val * b_val else "MISMATCH"
        print(f"decrypted product: {result} (expected {a_val * b_val}) -> "
              f"{status} [{dt:.1f}s, {dt/plan.n_levels*1e3:.0f} ms/level]")
        assert result == a_val * b_val
        return

    nbits = 8
    a_val, b_val = 157, 89
    params = P.TEST_TINY
    print(f"8-bit Bristol adder: {a_val} + {b_val} (params: {params.name})")

    text = bristol_adder(nbits)
    plan = S.parse_bristol(text)
    print(f"scheduled: {plan.n_gates} gates in {plan.n_levels} levels, "
          f"{plan.n_slots} wire slots")

    sk = K.SecretKey.generate(jax.random.key(0), params)
    ck = K.CloudKey.generate(jax.random.key(1), sk, params)

    bits = [(a_val >> i) & 1 for i in range(nbits)] + \
           [(b_val >> i) & 1 for i in range(nbits)]
    cts = tlwe.encrypt_bool(jax.random.key(2), jnp.asarray(bits, bool),
                            params.tlwe_lv0.alpha, sk.key_lv0)

    t0 = time.time()
    out = S.evaluate(plan, cts, ck)
    out_bits = np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))
    dt = time.time() - t0

    result = sum(int(b) << i for i, b in enumerate(out_bits))
    expect = (a_val + b_val) % (1 << nbits)
    status = "OK" if result == expect else "MISMATCH"
    print(f"decrypted sum: {result} (expected {expect}) -> {status} "
          f"[{dt:.1f}s, {plan.n_gates} gates]")
    assert result == expect


if __name__ == "__main__":
    main()
