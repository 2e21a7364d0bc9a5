"""Encrypted integer circuits: bit codecs, adders.

bit_utils parity (bit_utils.zig:16-76): little-endian bit <-> int codecs and
"AsBits" encryption of u8/u16/u32/u64 values.  Circuit examples mirror
examples/add_two_numbers.zig (full adder, ripple-carry add) — but batch-first:
the width-W stage-1 gates of the adder run as ONE batched bootstrap, and a
Kogge-Stone adder is provided for log-depth carry propagation (the batched
way to spend batch width to cut sequential bootstrap rounds; no reference
analog — the reference evaluates strictly sequentially).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import tlwe as _tlwe
from zig_tfhe_jax.key import CloudKey, SecretKey
from zig_tfhe_jax.models import gates as G


def to_bits(value: int, width: int) -> np.ndarray:
    """Little-endian bits of ``value`` (bit_utils.zig:57-66)."""
    return np.array([(value >> i) & 1 for i in range(width)], bool)


def from_bits(bits) -> int:
    """Little-endian bits -> int (bit_utils.zig:16-23)."""
    return int(sum((1 << i) for i, b in enumerate(np.asarray(bits)) if b))


def encrypt_bits(key, value: int, width: int, sk: SecretKey, params):
    """Encrypt an integer as ``width`` TLWE bools [width, n0+1]
    (bit_utils.zig:32-52)."""
    bits = to_bits(value, width)
    return _tlwe.encrypt_bool(key, jnp.asarray(bits), params.tlwe_lv0.alpha,
                              sk.key_lv0, width=params.torus_bits)


def decrypt_bits(cts, sk: SecretKey) -> int:
    bits = np.asarray(_tlwe.decrypt_bool(cts, sk.key_lv0))
    return from_bits(bits)


class AsBits:
    """bit_utils.zig:32-76 parity: typed bit views of unsigned integers."""

    def __init__(self, width: int):
        self.width = width

    def to_bits(self, value: int) -> np.ndarray:
        return to_bits(value, self.width)

    def encrypt(self, key, value: int, sk: SecretKey, params):
        return encrypt_bits(key, value, self.width, sk, params)


U8AsBits = AsBits(8)
U16AsBits = AsBits(16)
U32AsBits = AsBits(32)
U64AsBits = AsBits(64)


def full_adder(a, b, c, ck: CloudKey):
    """One-bit full adder (add_two_numbers.zig:24-47), 3 bootstrap rounds
    (5 gates, but the two gates inside each of rounds 1-2 share a batch).

    Round 1 (one batched bootstrap): x = a XOR b, g = a AND b.
    Round 2 (one batched bootstrap): sum = x XOR c, t = x AND c.
    Round 3: carry = g OR t.
    a, b, c: [B, n0+1].  Returns (sum, carry).
    """
    xg = G.gate_pair(("xor", "and"), (a, a), (b, b), ck)
    x, g = xg[0], xg[1]
    st = G.gate_pair(("xor", "and"), (x, x), (c, c), ck)
    s, t = st[0], st[1]
    carry = G.gate("or", g, t, ck)
    return s, carry


def ripple_carry_add(a_bits, b_bits, cin, ck: CloudKey):
    """W-bit ripple-carry adder (add_two_numbers.zig:51-73), batch-first.

    a_bits, b_bits: [W, n0+1]; cin: [1, n0+1].
    Stage 1 computes all W XORs and W ANDs in ONE batched bootstrap; the
    carry chain then takes 2 bootstrap rounds per bit (vs 5 gates/bit
    sequential in the reference).  Returns (sum_bits [W, n0+1], carry).
    """
    W = a_bits.shape[0]
    # Stage 1: x_i = a_i XOR b_i, g_i = a_i AND b_i — one batched bootstrap.
    xg = G.gate_pair(("xor", "and"), (a_bits, a_bits), (b_bits, b_bits), ck)
    x, g = xg[0], xg[1]

    sums = []
    carry = cin
    for i in range(W):
        st = G.gate_pair(("xor", "and"),
                         (x[i:i + 1], x[i:i + 1]), (carry, carry), ck)
        sums.append(st[0])
        carry = G.gate("or", g[i:i + 1], st[1], ck)
    return jnp.concatenate(sums, axis=0), carry


def kogge_stone_add(a_bits, b_bits, ck: CloudKey):
    """W-bit carry-lookahead (Kogge-Stone) adder: ~2*log2(W)+2 bootstrap
    ROUNDS total, each a single wide batched bootstrap.

    Carry recurrences: (g, p) span composition
        G[i:j] = g_i OR (p_i AND g_j),  P[i:j] = p_i AND p_j
    computed in log2(W) doubling rounds with all lanes batched.
    """
    W = a_bits.shape[0]
    # Round 0: p = a XOR b, g = a AND b (one batched bootstrap).
    pg = G.gate_pair(("xor", "and"), (a_bits, a_bits), (b_bits, b_bits), ck)
    p, g = pg[0], pg[1]
    p0 = p  # save for the final sum

    dist = 1
    while dist < W:
        # Lanes i >= dist combine with (i - dist); others pass through.
        # Every round runs at FULL width W (pass-through lanes compute a
        # discarded gate) so all rounds share one compiled pipeline shape —
        # the W-dist shrinking form recompiled the whole blind-rotate scan
        # per round, and batched bootstrap cost is per-scan, not per-lane.
        g_shift = jnp.concatenate([g[:dist], g[:-dist]], axis=0)  # g[i-dist]
        p_shift = jnp.concatenate([p[:dist], p[:-dist]], axis=0)
        # t = p_i AND g_{i-dist} ; cand_p = p_i AND p_{i-dist}
        tp = G.gate_pair(("and", "and"), (p, p), (g_shift, p_shift), ck)
        cand_g = G.gate("or", g, tp[0], ck)
        keep = jnp.asarray(np.arange(W) >= dist).reshape(
            (W,) + (1,) * (g.ndim - 1))
        g = jnp.where(keep, cand_g, g)
        p = jnp.where(keep, tp[1], p)
        dist *= 2

    # carries into bit i are G[0:i-1]; sum_i = p0_i XOR carry_in_i
    zero = G.constant(False, ck.params, batch=(1,) + a_bits.shape[1:-1])
    carries_in = jnp.concatenate([zero, g[:-1]], axis=0)
    sums = G.gate("xor", p0, carries_in, ck)
    return sums, g[-1:]
