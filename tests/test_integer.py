"""Encrypted radix-8 integer arithmetic (models/integer.py): exactness.

Runs on TEST_TINY_UINT (alpha=0, m=16 capable): every PBS is exact, so
add/mul must reproduce plain integer arithmetic digit-for-digit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax.models import integer as I

import os

# The three division/barrel-shift cases dominate the file's wall time
# (360/195/95 s of a ~20 min run); the CI production-params job runs
# them with ZTFHE_SLOW_TESTS=1 so the default lane stays fast.
slow = pytest.mark.skipif(
    os.environ.get("ZTFHE_SLOW_TESTS", "") in ("", "0"),
    reason="set ZTFHE_SLOW_TESTS=1 to run the slow divmod/shift cases")


@pytest.fixture(scope="module")
def ip():
    return P.TEST_TINY_UINT


@pytest.fixture(scope="module")
def isk(ip):
    return K.SecretKey.generate(jax.random.key(50), ip)


@pytest.fixture(scope="module")
def ick(ip, isk):
    return K.CloudKey.generate(jax.random.key(51), isk, ip)


def test_radix_codec_roundtrip(ip, isk):
    for v in (0, 1, 7, 8, 63, 64, 511, 4095):
        ct = I.encrypt_radix(jax.random.key(v + 1), v, 4, 0.0, isk.key_lv0)
        assert I.decrypt_radix(ct, isk.key_lv0) == v


def test_radix_add_exact(ip, isk, ick):
    rng = np.random.default_rng(3)
    cases = [(5, 6), (63, 1), (263, 441)]
    cases += [tuple(rng.integers(0, 512, 2)) for _ in range(3)]
    for a, b in cases:
        ca = I.encrypt_radix(jax.random.key(int(a)), int(a), 3, 0.0,
                             isk.key_lv0)
        cb = I.encrypt_radix(jax.random.key(1000 + int(b)), int(b), 3, 0.0,
                             isk.key_lv0)
        cs = I.radix_add(ca, cb, ick)
        assert I.decrypt_radix(cs, isk.key_lv0) == int(a) + int(b), (a, b)


def test_digit_mul_exact(ip, isk, ick):
    for x in (0, 1, 3, 5, 7):
        for y in (0, 2, 4, 7):
            cx = I.encrypt_radix(jax.random.key(10 + x), x, 1, 0.0,
                                 isk.key_lv0)
            cy = I.encrypt_radix(jax.random.key(20 + y), y, 1, 0.0,
                                 isk.key_lv0)
            lo, hi = I.digit_mul(cx[0], cy[0], ick)
            got = I.decrypt_radix(np.stack([lo, hi]), isk.key_lv0)
            assert got == x * y, (x, y, got)


def test_radix_mul_exact(ip, isk, ick):
    for a, b in [(23, 45), (63, 63), (7, 0), (40, 13)]:
        ca = I.encrypt_radix(jax.random.key(100 + a), a, 2, 0.0, isk.key_lv0)
        cb = I.encrypt_radix(jax.random.key(200 + b), b, 2, 0.0, isk.key_lv0)
        cp = I.radix_mul(ca, cb, ick)
        assert I.decrypt_radix(cp, isk.key_lv0) == a * b, (a, b)


def test_batched_radix_ops(ip, isk, ick):
    """Batch-first: a leading batch axis of independent integers flows
    through add/mul with every PBS round shared across the batch."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 64, 5)
    b = rng.integers(0, 64, 5)
    ca = I.encrypt_radix(jax.random.key(300), a, 2, 0.0, isk.key_lv0)
    cb = I.encrypt_radix(jax.random.key(301), b, 2, 0.0, isk.key_lv0)
    assert ca.shape[:2] == (5, 2)
    s = I.radix_add(ca, cb, ick)
    assert np.array_equal(I.decrypt_radix(s, isk.key_lv0), a + b)
    p = I.radix_mul(ca, cb, ick)
    assert np.array_equal(I.decrypt_radix(p, isk.key_lv0), a * b)


def test_multivalue_vs_per_lane_paths(ip, isk, ick, monkeypatch):
    """The multi-value fast path (default) and the plain per-lane path
    (ZTFHE_NO_MULTIVALUE=1) produce identical decrypts (alpha=0)."""
    a, b = 1234, 4321
    cta = I.encrypt_radix(jax.random.key(80), a, 5, 0.0, isk.key_lv0)
    ctb = I.encrypt_radix(jax.random.key(81), b, 5, 0.0, isk.key_lv0)
    out_mv = I.radix_add(cta, ctb, ick)
    assert I.decrypt_radix(out_mv, isk.key_lv0) == a + b
    monkeypatch.setenv("ZTFHE_NO_MULTIVALUE", "1")
    out_plain = I.radix_add(cta, ctb, ick)
    assert I.decrypt_radix(out_plain, isk.key_lv0) == a + b


def test_fheuint_operator_api(ip, isk, ick):
    """FheUint: operator-overloaded handles, mixed widths, plain-int
    mixing via trivial ciphertexts, batch values."""
    a = I.FheUint.encrypt(jax.random.key(90), 45, 2, isk, ick, alpha=0.0)
    b = I.FheUint.encrypt(jax.random.key(91), 19, 3, isk, ick, alpha=0.0)
    assert (a + b).decrypt(isk) == 64          # mixed width, widened result
    assert (a + 100).decrypt(isk) == 145       # plain-int coercion
    assert (3 * a).decrypt(isk) == 135         # __rmul__
    assert (a * b).decrypt(isk) == 855
    av = I.FheUint.encrypt(jax.random.key(92), np.array([5, 12, 63]), 2,
                           isk, ick, alpha=0.0)
    bv = I.FheUint.encrypt(jax.random.key(93), np.array([7, 30, 1]), 2,
                           isk, ick, alpha=0.0)
    assert list((av + bv).decrypt(isk)) == [12, 42, 64]
    with pytest.raises(ValueError, match="unsigned"):
        a + (-1)


def _enc(v, d, isk, ick, seed):
    return I.FheUint.encrypt(jax.random.key(seed), v, d, isk, ick, alpha=0.0)


def test_radix_sub_and_borrow(ip, isk, ick):
    for a, b in [(45, 19), (19, 45), (64, 64), (511, 0), (0, 1)]:
        ca = I.encrypt_radix(jax.random.key(a + 7), a, 3, 0.0, isk.key_lv0)
        cb = I.encrypt_radix(jax.random.key(b + 77), b, 3, 0.0, isk.key_lv0)
        diff, borrow = I.radix_sub(ca, cb, ick)
        assert I.decrypt_radix(diff, isk.key_lv0) == (a - b) % 512, (a, b)
        got_b = I.decrypt_radix(borrow[None], isk.key_lv0)
        assert got_b == (1 if a < b else 0), (a, b)


def test_fheuint_sub_wraps(ip, isk, ick):
    a = _enc(45, 2, isk, ick, 110)
    b = _enc(19, 2, isk, ick, 111)
    assert (a - b).decrypt(isk) == 26
    assert (b - a).decrypt(isk) == (19 - 45) % 64   # wrap mod 8^2
    assert (a - 5).decrypt(isk) == 40
    assert (60 - a).decrypt(isk) == 15              # __rsub__


def test_fheuint_comparisons(ip, isk, ick):
    a = _enc(45, 2, isk, ick, 120)
    b = _enc(19, 3, isk, ick, 121)                  # mixed width
    a2 = _enc(45, 2, isk, ick, 122)
    assert (a == a2).decrypt(isk) == 1
    assert (a == b).decrypt(isk) == 0
    assert (a != b).decrypt(isk) == 1
    assert (a < b).decrypt(isk) == 0
    assert (b < a).decrypt(isk) == 1
    assert (a <= a2).decrypt(isk) == 1
    assert (a >= b).decrypt(isk) == 1
    assert (a > 45).decrypt(isk) == 0
    assert (a >= 45).decrypt(isk) == 1
    # wide operand exercises the AND-reduce tree (D = 6 digit lanes)
    w1 = _enc(123456, 6, isk, ick, 123)
    w2 = _enc(123456, 6, isk, ick, 124)
    assert (w1 == w2).decrypt(isk) == 1
    assert (w1 == (w2 + 1)).decrypt(isk) == 0


def test_fheuint_select_min_max(ip, isk, ick):
    a = _enc(45, 2, isk, ick, 130)
    b = _enc(19, 2, isk, ick, 131)
    assert a.min(b).decrypt(isk) == 19
    assert a.max(b).decrypt(isk) == 45
    bit = a < b                                     # 0
    assert bit.select(a, b).decrypt(isk) == 19
    bit = b < a                                     # 1
    assert bit.select(a, b).decrypt(isk) == 45


def test_fheuint_bitwise(ip, isk, ick):
    rng = np.random.default_rng(17)
    for _ in range(3):
        x, y = (int(v) for v in rng.integers(0, 512, 2))
        cx = _enc(x, 3, isk, ick, 140 + x)
        cy = _enc(y, 3, isk, ick, 141 + y)
        assert (cx & cy).decrypt(isk) == (x & y), (x, y)
        assert (cx | cy).decrypt(isk) == (x | y), (x, y)
        assert (cx ^ cy).decrypt(isk) == (x ^ y), (x, y)


def test_fheuint_shifts(ip, isk, ick):
    x = 0o345                                       # 229
    cx = _enc(x, 3, isk, ick, 150)
    for s in (0, 1, 2, 3, 4, 7):
        assert (cx << s).decrypt(isk) == x << s, s
        assert (cx >> s).decrypt(isk) == x >> s, s
    assert (cx >> 12).decrypt(isk) == 0             # overshoot -> zero


@slow
def test_fheuint_encrypted_amount_shifts(ip, isk, ick):
    x = 37
    cx = _enc(x, 2, isk, ick, 240)
    for y in (0, 1, 3, 5, 7):
        cy = _enc(y, 1, isk, ick, 241 + y)
        assert (cx << cy).decrypt(isk) == (x << y) % 64, y   # fixed width
        assert (cx >> cy).decrypt(isk) == x >> y, y
    # batched amounts over a batched value
    xs = np.array([37, 5, 63])
    ys = np.array([1, 2, 6])
    cxs = _enc(xs, 2, isk, ick, 250)
    cys = _enc(ys, 1, isk, ick, 251)
    assert list((cxs << cys).decrypt(isk)) == [(37 << 1) % 64,
                                               (5 << 2) % 64, 0]
    assert list((cxs >> cys).decrypt(isk)) == [18, 1, 0]
    # signed arithmetic shift by an encrypted amount
    sx = I.FheInt.encrypt(jax.random.key(252), -100, 3, isk, ick, alpha=0.0)
    for y in (1, 4, 12):
        cy = _enc(y, 2, isk, ick, 253 + y)
        assert (sx >> cy).decrypt(isk) == -100 >> y, y


def test_gates_integer_bridge(ip, isk, ick):
    """Radix digits <-> boolean gate bits round-trip, and composition
    with the gate layer (bitwise AND through models/gates)."""
    from zig_tfhe_jax import tlwe
    from zig_tfhe_jax.models import gates as G
    v, w = 45, 19                                 # 6 bits, 2 digits
    ca = I.encrypt_radix(jax.random.key(260), v, 2, 0.0, isk.key_lv0)
    bits = I.to_bools(ca, ick)                    # [6, n0+1], +-1/8 codec
    got = np.asarray(tlwe.decrypt_bool(bits, isk.key_lv0)).astype(int)
    assert list(got) == [(v >> i) & 1 for i in range(6)]
    d2 = I.from_bools(bits, ick)
    assert I.decrypt_radix(d2, isk.key_lv0) == v
    wb = tlwe.encrypt_bool(
        jax.random.key(261),
        np.array([(w >> i) & 1 for i in range(6)], bool),
        0.0, isk.key_lv0)
    anded = G.gate("and", bits, wb, ick)          # boolean layer
    back = I.from_bools(anded, ick)
    assert I.decrypt_radix(back, isk.key_lv0) == (v & w)
    # partial top digit: 4 bits -> 2 digits
    d4 = I.from_bools(bits[:4], ick)
    assert I.decrypt_radix(d4, isk.key_lv0) == (v & 15)


def test_fheuint_batched_compare_select(ip, isk, ick):
    av = np.array([5, 30, 63])
    bv = np.array([7, 30, 1])
    ca = _enc(av, 2, isk, ick, 160)
    cb = _enc(bv, 2, isk, ick, 161)
    assert list((ca < cb).decrypt(isk)) == [1, 0, 0]
    assert list(ca.min(cb).decrypt(isk)) == [5, 30, 1]
    assert list(ca.max(cb).decrypt(isk)) == [7, 30, 63]
    assert list((ca ^ cb).decrypt(isk)) == [5 ^ 7, 0, 62]
    assert list((ca - cb).decrypt(isk)) == [(5 - 7) % 64, 0, 62]


@slow
def test_fheuint_divmod(ip, isk, ick):
    a = _enc(45, 2, isk, ick, 210)
    b = _enc(7, 1, isk, ick, 211)
    q, r = divmod(a, b)
    assert q.decrypt(isk) == 6
    assert r.decrypt(isk) == 3
    assert (a // 19).decrypt(isk) == 2
    assert (a % 19).decrypt(isk) == 7
    assert (100 // b).decrypt(isk) == 14         # __rfloordiv__
    zero = _enc(0, 1, isk, ick, 212)
    assert (a // zero).decrypt(isk) == 63        # div-by-zero -> all ones
    av = np.array([45, 10, 63])
    bv = np.array([6, 10, 1])
    ca, cb = _enc(av, 2, isk, ick, 213), _enc(bv, 2, isk, ick, 214)
    assert list((ca // cb).decrypt(isk)) == [7, 1, 63]
    assert list((ca % cb).decrypt(isk)) == [3, 0, 0]


def _senc(v, d, isk, ick, seed):
    return I.FheInt.encrypt(jax.random.key(seed), v, d, isk, ick, alpha=0.0)


def test_python_protocol_safety(ip, isk, ick):
    """Encrypted comparisons must not silently act as Python bools, and
    foreign-type equality must degrade to identity (NotImplemented)."""
    a = _enc(5, 1, isk, ick, 230)
    with pytest.raises(TypeError, match="decrypt"):
        bool(a == a)                       # would otherwise always be truthy
    with pytest.raises(TypeError, match="decrypt"):
        if a < 4:                          # same trap via ordered compare
            pass
    assert (a == None) is False            # noqa: E711 — identity fallback
    assert (a != "x") is True
    assert divmod(45, a)[0].decrypt(isk) == 9     # __rdivmod__
    s = I.FheInt.encrypt(jax.random.key(231), -3, 1, isk, ick, alpha=0.0)
    assert (s == object()) is False
    with pytest.raises(TypeError):
        s & 1.5                            # non-integral -> TypeError


def test_plain_operand_fast_paths(ip, isk, ick):
    """Plain-constant mul (per-digit mulc LUTs / shifts) and divmod by
    powers of two (shift + mask) must match the general encrypted
    paths."""
    a = _enc(45, 2, isk, ick, 290)
    for v in (0, 1, 2, 3, 7, 8, 10, 63):
        assert (a * v).decrypt(isk) == 45 * v, v
    assert (5 * a).decrypt(isk) == 225
    for v in (1, 2, 4, 8, 32):
        q, r = divmod(a, v)
        assert q.decrypt(isk) == 45 // v, v
        assert r.decrypt(isk) == 45 % v, v
    s = _senc(-21, 2, isk, ick, 291)
    assert (s * 2).decrypt(isk) == 22                  # -42 wraps at D=2
    assert (s * -1).decrypt(isk) == 21
    assert (s * 0).decrypt(isk) == 0
    assert (s * 3).decrypt(isk) == 1                   # -63 wraps to 1
    sv = _senc(np.array([-5, 12]), 2, isk, ick, 292)
    assert list((sv * 3).decrypt(isk)) == [-15, 36 - 64]


def test_scheduler_integer_roundtrip(ip, isk, ick):
    """FheUint -> bits (bridge) -> native C++-scheduled boolean circuit
    (3-bit ripple adder) -> bits -> FheUint: all three subsystems under
    one key."""
    from zig_tfhe_jax.models import scheduler as S
    c = S.Circuit()
    a_bits = [c.input() for _ in range(3)]
    b_bits = [c.input() for _ in range(3)]
    carry = None
    for i in range(3):
        s1 = c.gate("xor", a_bits[i], b_bits[i])
        g = c.gate("and", a_bits[i], b_bits[i])
        if carry is None:
            c.output(s1)
            carry = g
        else:
            c.output(c.gate("xor", s1, carry))
            carry = c.gate("or", g, c.gate("and", s1, carry))
    c.output(carry)
    plan = c.schedule()

    x, y = 5, 7
    cx = I.encrypt_radix(jax.random.key(280), x, 1, 0.0, isk.key_lv0)
    cy = I.encrypt_radix(jax.random.key(281), y, 1, 0.0, isk.key_lv0)
    in_bits = jnp.concatenate([I.to_bools(cx, ick), I.to_bools(cy, ick)])
    out_bits = S.evaluate(plan, in_bits, ick)          # [4, n0+1]
    total = I.from_bools(out_bits, ick)                # 4 bits -> 2 digits
    assert I.decrypt_radix(total, isk.key_lv0) == x + y


def test_overflowing_ops(ip, isk, ick):
    a = _enc(45, 2, isk, ick, 270)
    b = _enc(30, 2, isk, ick, 271)
    s, c = a.overflowing_add(b)              # 75 wraps at 6 bits
    assert s.decrypt(isk) == 75 - 64 and c.decrypt(isk) == 1
    s, c = b.overflowing_add(b)              # 60 fits
    assert s.decrypt(isk) == 60 and c.decrypt(isk) == 0
    d, br = b.overflowing_sub(a)
    assert d.decrypt(isk) == (30 - 45) % 64 and br.decrypt(isk) == 1
    # signed overflow: 20 + 20 = 40 > 31 overflows at D=2
    p = _senc(20, 2, isk, ick, 272)
    r, o = p.overflowing_add(p)
    assert r.decrypt(isk) == 40 - 64 and o.decrypt(isk) == 1
    n = _senc(-20, 2, isk, ick, 273)
    r, o = n.overflowing_add(n)              # -40 < -32 overflows
    assert r.decrypt(isk) == -40 + 64 and o.decrypt(isk) == 1
    r, o = p.overflowing_add(n)              # 0, no overflow
    assert r.decrypt(isk) == 0 and o.decrypt(isk) == 0
    r, o = p.overflowing_add(_senc(11, 2, isk, ick, 274))   # 31 fits
    assert r.decrypt(isk) == 31 and o.decrypt(isk) == 0




def test_digit_mul_tree_path_matches_classic(ip, isk, ick):
    """The stock uint-set CloudKey now builds the packing key by default
    (VERDICT r3 #3), routing digit_mul through the bivariate tree PBS;
    results must decrypt identically to the classic bit-decomposition
    pipeline, reached via an explicit packing_key=False opt-out (alpha=0:
    both are exact)."""
    ick_pk = ick                                   # default: tree path
    ick = K.CloudKey.generate(jax.random.key(51), isk, ip,
                              packing_key=False)   # classic opt-out
    assert ick_pk.pksk is not None and ick.pksk is None
    assert ick_pk.pksk_gadget == (ip.basebit, ip.iks_t)
    rng = np.random.default_rng(3)
    xs = rng.integers(0, 8, 6)
    ys = rng.integers(0, 8, 6)
    cx = I.encrypt_radix(jax.random.key(60), xs, 1, 0.0, isk.key_lv0)[..., 0, :]
    cy = I.encrypt_radix(jax.random.key(61), ys, 1, 0.0, isk.key_lv0)[..., 0, :]
    lo_c, hi_c = I.digit_mul(cx, cy, ick)          # classic
    lo_t, hi_t = I.digit_mul(cx, cy, ick_pk)       # tree
    for lo, hi in ((lo_c, hi_c), (lo_t, hi_t)):
        got = (np.asarray(I.decrypt_radix(lo[..., None, :], isk.key_lv0))
               + 8 * np.asarray(I.decrypt_radix(hi[..., None, :],
                                                isk.key_lv0)))
        assert np.array_equal(got, xs * ys)
    # end-to-end: a full FheUint multiply through the tree path (products
    # widen to the exact value, matching the classic-path semantics)
    a = I.FheUint.encrypt(jax.random.key(62), 45, 2, isk, ick_pk, alpha=0.0)
    b = I.FheUint.encrypt(jax.random.key(63), 7, 2, isk, ick_pk, alpha=0.0)
    assert (a * b).decrypt(isk) == 45 * 7


def test_digit_mul_pksk_gadget_guard(ip, isk, ick):
    """A packing key whose declared (basebit, t) contract differs from the
    parameter set must fail fast in digit_mul — same row count or not
    (ADVICE r3 #1: a same-t/different-basebit key has the RIGHT row count
    but would silently decode garbage)."""
    import dataclasses as dc

    assert ick.pksk is not None                    # uint default builds it
    cx = I.encrypt_radix(jax.random.key(70), 3, 1, 0.0, isk.key_lv0)[..., 0, :]
    cy = I.encrypt_radix(jax.random.key(71), 5, 1, 0.0, isk.key_lv0)[..., 0, :]
    # wrong basebit, same t: row count matches, contract does not
    bad = dc.replace(ick, pksk_gadget=(ip.basebit + 1, ip.iks_t))
    with pytest.raises(ValueError, match="basebit"):
        I.digit_mul(cx, cy, bad)
    # wrong row count (legacy guard still fires for undeclared keys)
    bad2 = dc.replace(ick, pksk=ick.pksk[: ip.n1], pksk_gadget=None)
    with pytest.raises(ValueError, match="rows"):
        I.digit_mul(cx, cy, bad2)
