"""Encrypted integer circuits: bit codecs, full adder, ripple-carry and
Kogge-Stone adders (examples/add_two_numbers.zig analog: 402+304=706)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import circuits as C
from zig_tfhe_jax.models import gates as G


def test_bit_codecs():
    # bit_utils.zig:170-200
    assert C.from_bits(C.to_bits(5, 8)) == 5
    assert C.from_bits(C.to_bits(0b10101010, 8)) == 0b10101010
    for w, v in [(8, 0b10101010), (16, 0b1010101010101010), (32, 0xDEADBEEF),
                 (64, 0xDEADBEEFCAFEBABE)]:
        bits = C.to_bits(v, w)
        assert len(bits) == w
        assert bits[0] == bool(v & 1)
        assert C.from_bits(bits) == v


def test_encrypt_decrypt_bits(tiny, tiny_sk):
    ct = C.encrypt_bits(jax.random.key(80), 402, 16, tiny_sk, tiny)
    assert ct.shape == (16, tiny.n0 + 1)
    assert C.decrypt_bits(ct, tiny_sk) == 402


def test_full_adder(tiny, tiny_sk, tiny_ck):
    # all 8 combos at once (batch-first)
    combos = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    A = jnp.asarray([bool(x[0]) for x in combos])
    B = jnp.asarray([bool(x[1]) for x in combos])
    Cin = jnp.asarray([bool(x[2]) for x in combos])
    cta = tlwe.encrypt_bool(jax.random.key(81), A, 0.0, tiny_sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(82), B, 0.0, tiny_sk.key_lv0)
    ctc = tlwe.encrypt_bool(jax.random.key(83), Cin, 0.0, tiny_sk.key_lv0)
    s, cy = C.full_adder(cta, ctb, ctc, tiny_ck)
    sd = np.asarray(tlwe.decrypt_bool(s, tiny_sk.key_lv0)).astype(int)
    cd = np.asarray(tlwe.decrypt_bool(cy, tiny_sk.key_lv0)).astype(int)
    for i, (a, b, c) in enumerate(combos):
        assert sd[i] == (a + b + c) % 2
        assert cd[i] == (a + b + c) // 2


def test_add_402_304_kogge(tiny, tiny_sk, tiny_ck):
    # the reference's flagship example: 402 + 304 == 706 over 16 bits
    W = 16
    a = C.encrypt_bits(jax.random.key(84), 402, W, tiny_sk, tiny)
    b = C.encrypt_bits(jax.random.key(85), 304, W, tiny_sk, tiny)
    s, _ = C.kogge_stone_add(a, b, tiny_ck)
    assert C.decrypt_bits(s, tiny_sk) == 706


def test_ripple_carry_add_4bit(tiny, tiny_sk, tiny_ck):
    # ripple chain exercised at 4 bits (16 bits costs ~3 min of CPU compiles;
    # the 16-bit flagship runs through the Kogge-Stone test above)
    W = 4
    a = C.encrypt_bits(jax.random.key(84), 9, W, tiny_sk, tiny)
    b = C.encrypt_bits(jax.random.key(85), 8, W, tiny_sk, tiny)
    cin = G.constant(False, tiny, batch=(1,))
    s, carry = C.ripple_carry_add(a, b, cin, tiny_ck)
    assert C.decrypt_bits(s, tiny_sk) == (9 + 8) % 16
    assert bool(tlwe.decrypt_bool(carry, tiny_sk.key_lv0)[0])  # 17 >= 16


def test_kogge_stone_random_values(tiny, tiny_sk, tiny_ck, rng):
    W = 8
    x, y = 173, 201  # x+y = 374 > 255: exercises the carry-out
    a = C.encrypt_bits(jax.random.key(86), x, W, tiny_sk, tiny)
    b = C.encrypt_bits(jax.random.key(87), y, W, tiny_sk, tiny)
    s, cy = C.kogge_stone_add(a, b, tiny_ck)
    assert C.decrypt_bits(s, tiny_sk) == (x + y) % (1 << W)
    assert bool(tlwe.decrypt_bool(cy, tiny_sk.key_lv0)[0]) == ((x + y) >= (1 << W))


def test_kogge_stone_client_batch(tiny, tiny_sk, tiny_ck):
    """Adders accept extra trailing batch dims ([W, B, n0+1] — the serving
    shape): 8-bit Kogge-Stone over 4 clients in one pass, exact."""
    import numpy as _np
    rng = _np.random.default_rng(3)
    av = rng.integers(0, 256, 4)
    bv = rng.integers(0, 256, 4)
    abits = _np.zeros((8, 4), bool)
    bbits = _np.zeros((8, 4), bool)
    for i in range(8):
        abits[i] = (av >> i) & 1
        bbits[i] = (bv >> i) & 1
    ca = tlwe.encrypt_bool(jax.random.key(2), jnp.asarray(abits), 0.0,
                           tiny_sk.key_lv0)
    cb = tlwe.encrypt_bool(jax.random.key(3), jnp.asarray(bbits), 0.0,
                           tiny_sk.key_lv0)
    s, carry = C.kogge_stone_add(ca, cb, tiny_ck)
    dec = _np.asarray(tlwe.decrypt_bool(s, tiny_sk.key_lv0))
    got = sum(dec[i].astype(_np.int64) << i for i in range(8))
    got += _np.asarray(tlwe.decrypt_bool(carry, tiny_sk.key_lv0))[0] \
        .astype(_np.int64) << 8
    assert _np.array_equal(got, av + bv)
