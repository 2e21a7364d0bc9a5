"""Signed encrypted integers (FheInt): exactness.

Split out of test_integer.py so the two modules parallelize under
pytest-xdist --dist loadscope (the combined file was the suite's
critical path).  Same TEST_TINY_UINT (alpha=0) regime: every PBS is
exact, so signed arithmetic must reproduce two's-complement semantics
digit-for-digit.
"""

import os

import jax
import numpy as np
import pytest

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax.models import integer as I

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


def _senc(v, d, isk, ick, seed):
    return I.FheInt.encrypt(jax.random.key(seed), v, d, isk, ick, alpha=0.0)

def test_fheint_arith(ip, isk, ick):
    a = _senc(-21, 2, isk, ick, 170)
    b = _senc(13, 2, isk, ick, 171)
    assert (a + b).decrypt(isk) == -8
    assert (a - b).decrypt(isk) == 30                  # -34 wraps mod 64 (D=2 -> [-32,32))
    assert (b - a).decrypt(isk) == (13 + 21) - 64      # 34 wraps to -30
    assert (-a).decrypt(isk) == 21
    assert (a * b).decrypt(isk) == (-21 * 13) % 64 - 64  # low 6 bits, signed
    with pytest.raises(ValueError, match="range"):
        _senc(40, 2, isk, ick, 172)                    # 40 >= 8^2/2

def test_fheint_compare_minmax(ip, isk, ick):
    a = _senc(-21, 2, isk, ick, 180)
    b = _senc(13, 2, isk, ick, 181)
    a2 = _senc(-21, 2, isk, ick, 182)
    assert (a < b).decrypt(isk) == 1
    assert (b < a).decrypt(isk) == 0
    assert (a == a2).decrypt(isk) == 1
    assert (a != b).decrypt(isk) == 1
    assert (a <= a2).decrypt(isk) == 1
    assert (a >= b).decrypt(isk) == 0
    assert (a < 0).decrypt(isk) == 1
    assert (b > -1).decrypt(isk) == 1
    assert a.min(b).decrypt(isk) == -21
    assert a.max(b).decrypt(isk) == 13
    # mixed widths: sign extension of the narrower ciphertext
    w = _senc(-100, 3, isk, ick, 183)
    assert (w < a).decrypt(isk) == 1
    assert (a + w).decrypt(isk) == -121
    assert w.max(a).decrypt(isk) == -21

def test_fheint_shifts_bitwise(ip, isk, ick):
    a = _senc(-100, 3, isk, ick, 190)
    for s in (0, 1, 2, 3, 4, 7):
        assert (a >> s).decrypt(isk) == -100 >> s, s   # arithmetic shift
    assert (a >> 12).decrypt(isk) == -1                # overshoot -> sign
    p = _senc(100, 3, isk, ick, 191)
    assert (p >> 2).decrypt(isk) == 25
    assert (p >> 12).decrypt(isk) == 0
    assert (a << 1).decrypt(isk) == -200
    assert (p << 3).decrypt(isk) == (100 << 3) - 1024  # wraps at 9 bits
    b = _senc(37, 3, isk, ick, 192)
    m = (1 << 9) - 1
    assert ((a & b).decrypt(isk)) % 512 == ((-100 & 37) & m)
    assert ((a ^ b).decrypt(isk)) % 512 == ((-100 ^ 37) & m)

@slow
def test_fheint_abs_divrem(ip, isk, ick):
    a = _senc(-21, 2, isk, ick, 220)
    b = _senc(13, 2, isk, ick, 221)
    assert a.abs().decrypt(isk) == 21
    assert b.abs().decrypt(isk) == 13
    q, r = a.div_rem(b)                      # truncating: -21 = 13*(-1) - 8
    assert q.decrypt(isk) == -1
    assert r.decrypt(isk) == -8
    q, r = b.div_rem(a)                      # 13 = -21*0 + 13
    assert q.decrypt(isk) == 0
    assert r.decrypt(isk) == 13
    q, r = (-b).div_rem(-a)                  # -13 / 21 -> 0 rem -13
    assert q.decrypt(isk) == 0
    assert r.decrypt(isk) == -13
    m = _senc(-32, 2, isk, ick, 222)         # INT_MIN edge
    q, r = m.div_rem(_senc(2, 2, isk, ick, 223))
    assert q.decrypt(isk) == -16
    assert r.decrypt(isk) == 0

def test_fheint_batched(ip, isk, ick):
    av = np.array([-5, 30, -32])
    bv = np.array([7, -30, 1])
    ca = _senc(av, 2, isk, ick, 200)
    cb = _senc(bv, 2, isk, ick, 201)
    assert list((ca + cb).decrypt(isk)) == [2, 0, -31]
    assert list((ca < cb).decrypt(isk)) == [1, 0, 1]
    assert list(ca.min(cb).decrypt(isk)) == [-5, -30, -32]
