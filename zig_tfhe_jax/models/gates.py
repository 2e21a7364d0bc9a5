"""Homomorphic boolean gates, batch-first.

Every two-input gate is a linear combination plus a bias constant followed
by one bootstrap (gates.zig:25-152).  The batch-first API evaluates a
**batch** of gates per call — homogeneous (``nand(a, b)`` over [B, n0+1]
arrays) or heterogeneous (``apply_gates(gate_ids, a, b)`` where each lane
evaluates its own gate type — the building block for circuit-level
scheduling; the reference's batch gate APIs are unimplemented placeholders,
gates.zig:244-295).

Gate algebra (coeff_a, coeff_b, bias as a fraction of the torus):
  NAND (-1,-1,+1/8)  OR  (+1,+1,+1/8)  AND (+1,+1,-1/8)  XOR (+1,+2,+1/4)
  XNOR (-1,-2,-1/4)  NOR (-1,-1,-1/8)  ANDNY(-1,+1,-1/8) ANDYN(+1,-1,-1/8)
  ORNY (-1,+1,+1/8)  ORYN (+1,-1,+1/8)      (gates.zig:48-121)
NOT/COPY/CONSTANT are bootstrap-free (gates.zig:132-151).
"""

from __future__ import annotations

import functools
import os

import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import bootstrap as _bootstrap
from zig_tfhe_jax.key import CloudKey
from zig_tfhe_jax.ops.keyswitch import identity_key_switch
from zig_tfhe_jax.utils.torus import (f64_to_torus, to_carrier, to_i32,
                                      torus_constant, torus_constant_w)

# gate id -> (coeff_a, coeff_b, bias_fraction)
GATE_DEFS = {
    "nand":  (-1, -1,  0.125),
    "or":    (+1, +1,  0.125),
    "and":   (+1, +1, -0.125),
    "xor":   (+1, +2,  0.25),
    # NOTE: the reference's xnorGate (gates.zig:78-82) computes a-2b-1/4,
    # which yields NOT(XNOR) for every input pair; it ships with no XNOR
    # truth-table test (gates.zig:374-544 covers NAND/AND/OR/XOR/NOR/MUX
    # only).  We use the correct balanced form -a-2b-1/4.
    "xnor":  (-1, -2, -0.25),
    "nor":   (-1, -1, -0.125),
    "andny": (-1, +1, -0.125),
    "andyn": (+1, -1, -0.125),
    "orny":  (-1, +1,  0.125),
    "oryn":  (+1, -1,  0.125),
}
GATE_NAMES = tuple(GATE_DEFS)
GATE_IDS = {name: i for i, name in enumerate(GATE_NAMES)}

_COEFF_A = np.array([GATE_DEFS[g][0] for g in GATE_NAMES], np.int32)
_COEFF_B = np.array([GATE_DEFS[g][1] for g in GATE_NAMES], np.int32)
_BIAS = np.array([int(np.uint32(f64_to_torus(GATE_DEFS[g][2])))
                  for g in GATE_NAMES], np.uint32).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _bias_table(width: int) -> np.ndarray:
    """Gate bias constants at the carrier width (== _BIAS at width 32)."""
    if width == 32:
        return _BIAS
    return np.array([to_carrier(torus_constant_w(GATE_DEFS[g][2], width),
                                width) for g in GATE_NAMES], np.int64)


def _linear_combo(ca, cb, bias, a, b, n0: int):
    out = ca * a + cb * b
    return out.at[..., n0].add(bias)


# The blind-rotate step's compiled tiling can have batch-size cliffs,
# where an innocent batch size silently costs throughput.  The gate path
# therefore pads every bootstrap batch up to the bucket policy below,
# exactly as the integer layer already does (models/integer.py:_bucket),
# so that only a few batch shapes ever compile.  Padded lanes bootstrap a
# zero ciphertext and are sliced away.  ZTFHE_PAD_BATCH=0 opts out
# (trace-time semantics: read when the jitted caller traces, like
# ZTFHE_FOLD).  The knees are hand-set and not yet measured on the GPU.
_KNEE = 2048  # 32-bit engine throughput knee, in lanes


_KNEE_SPLIT = 512  # split-engine throughput knee, in lanes


def _pad_policy(B: int, knee: int = _KNEE) -> int:
    """Padded batch size for a gate bootstrap of B lanes.

    <= the knee: next power of two (min 8 — tiny batches are scan-bound,
    the pad is free), with 1536 kept as-is on the 2048-knee 32-bit path.
    Above the knee: pad to the next knee multiple only when the pad is
    small (<= knee/4 lanes), since a large pad could cost more than the
    cliff it avoids.  The knee follows the engine (the split engine's is
    512).
    """
    if B <= 8:
        return 8
    if B <= knee:
        b = 8
        while b < B:
            b *= 2
        if knee == _KNEE and b == knee and B <= 3 * knee // 4:
            return 3 * knee // 4                      # 1536
        return b
    m = -(-B // knee) * knee
    return m if m - B <= knee // 4 else B


def _use_pad() -> bool:
    return os.environ.get("ZTFHE_PAD_BATCH", "") not in ("0", "false")


def _padded_bootstrap(combo, ck: CloudKey, to_lv1: bool = False):
    """Bootstrap an arbitrary-batch-shaped linear combo [..., n0+1] with
    the flattened batch padded past the tiling cliffs."""
    fn = _bootstrap.bootstrap_to_lv1 if to_lv1 else _bootstrap.bootstrap
    batch = combo.shape[:-1]
    B = int(np.prod(batch)) if batch else 1
    flat = combo.reshape(B, combo.shape[-1])
    knee = _KNEE_SPLIT if ck.params.split_ring else _KNEE
    Bp = _pad_policy(B, knee) if _use_pad() else B
    if Bp != B:
        flat = jnp.concatenate(
            [flat, jnp.zeros((Bp - B, flat.shape[-1]), flat.dtype)])
    out = fn(flat, ck)[:B]
    return out.reshape(batch + (out.shape[-1],))


def gate(name: str, a, b, ck: CloudKey):
    """Evaluate one gate type over a batch: a, b int32 [..., n0+1]."""
    ca, cb, frac = GATE_DEFS[name]
    w = ck.params.torus_bits
    combo = _linear_combo(jnp.int32(ca), jnp.int32(cb),
                          to_carrier(torus_constant_w(frac, w), w),
                          a, b, ck.params.n0)
    return _padded_bootstrap(combo, ck)


def apply_gates(gate_ids, a, b, ck: CloudKey):
    """Heterogeneous gate batch: lane i evaluates GATE_NAMES[gate_ids[i]].

    gate_ids: int32 [B]; a, b: int32 [B, n0+1].  One shared bootstrap.
    Extra trailing batch dims on a/b broadcast against gate_ids from the
    LEFT (e.g. ids [W] with a [W, B, n0+1] applies id w to every client).
    """
    gate_ids = jnp.asarray(gate_ids)
    extra = a.ndim - 1 - gate_ids.ndim          # broadcast dims beyond ids
    ca = jnp.take(jnp.asarray(_COEFF_A), gate_ids).reshape(
        gate_ids.shape + (1,) * (extra + 1))
    cb = jnp.take(jnp.asarray(_COEFF_B), gate_ids).reshape(
        gate_ids.shape + (1,) * (extra + 1))
    bias = jnp.take(jnp.asarray(_bias_table(ck.params.torus_bits)),
                    gate_ids).reshape(gate_ids.shape + (1,) * extra)
    combo = ca * a + cb * b
    combo = combo.at[..., ck.params.n0].add(bias)
    return _padded_bootstrap(combo, ck)


# Named wrappers (free-function parity with gates.zig:157-238).
nand = functools.partial(gate, "nand")
or_ = functools.partial(gate, "or")
and_ = functools.partial(gate, "and")
xor = functools.partial(gate, "xor")
xnor = functools.partial(gate, "xnor")
nor = functools.partial(gate, "nor")
andny = functools.partial(gate, "andny")
andyn = functools.partial(gate, "andyn")
orny = functools.partial(gate, "orny")
oryn = functools.partial(gate, "oryn")


def not_(a):
    """Bootstrap-free NOT (gates.zig:132-135)."""
    return -a


def copy(a):
    """Bootstrap-free COPY (gates.zig:138-141)."""
    return a


def constant(value: bool, params, batch=()):
    """Trivial (noiseless) ciphertext of a constant (gates.zig:144-151).

    Matches the reference exactly, including its quirky false-encoding
    ``1 -% mu`` (one ulp off -mu; decrypts identically).
    """
    w = params.torus_bits
    mu = torus_constant_w(0.125, w)
    val = mu if value else ((1 - mu) % (1 << w))
    from zig_tfhe_jax.utils.torus import carrier_dtype
    ct = jnp.zeros(batch + (params.n0 + 1,), carrier_dtype(w))
    return ct.at[..., params.n0].set(to_carrier(val, w))


def mux_naive(a, b, c, ck: CloudKey):
    """(a ? b : c) via OR(AND(a,b), AND(NOT a, c)) — 3 bootstraps
    (gates.zig:124-129).  The two ANDs share one batched bootstrap here.
    a, b, c: int32 [B, n0+1]."""
    both = gate_pair(("and", "andny"), (a, a), (b, c), ck)
    return gate("or", both[0], both[1], ck)


def gate_pair(names, lhs_pair, rhs_pair, ck: CloudKey):
    """Evaluate two (possibly different) gate types in ONE shared bootstrap.

    names: 2-tuple of gate names; lhs_pair/rhs_pair: 2-tuples of [B, n0+1].
    Returns int32 [2, B, n0+1].
    """
    B = lhs_pair[0].shape[0]
    ids = jnp.repeat(
        jnp.array([GATE_IDS[names[0]], GATE_IDS[names[1]]], jnp.int32), B)
    lhs = jnp.concatenate([lhs_pair[0], lhs_pair[1]], axis=0)
    rhs = jnp.concatenate([rhs_pair[0], rhs_pair[1]], axis=0)
    res = apply_gates(ids, lhs, rhs, ck)
    return res.reshape((2, B) + res.shape[1:])


def mux(a, b, c, ck: CloudKey):
    """Optimized homomorphic MUX: 2 blind rotates + 1 key switch.

    u1 = BR(a AND b), u2 = BR((NOT a) AND c), both left at lv1;
    out = KS(u1 + u2 + 1/8).  Same truth table as mux_naive with one fewer
    blind rotation and a single key switch (standard TFHE MUX; the
    reference only ships the naive 3-gate version).
    """
    n0 = ck.params.n0
    w = ck.params.torus_bits
    bias = to_carrier(torus_constant_w(-0.125, w), w)
    and_combo = _linear_combo(jnp.int32(1), jnp.int32(1), bias, a, b, n0)
    andny_combo = _linear_combo(jnp.int32(-1), jnp.int32(1), bias, a, c, n0)
    stacked = jnp.concatenate([and_combo, andny_combo], axis=0)
    lv1 = _padded_bootstrap(stacked, ck, to_lv1=True)
    half = lv1.shape[0] // 2
    u = lv1[:half] + lv1[half:]
    u = u.at[..., ck.params.n1].add(to_carrier(torus_constant_w(0.125, w), w))
    return identity_key_switch(u, ck.ksk1, ck.params)
