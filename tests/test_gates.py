"""Gate truth tables with a real cloud key — decrypt-exact
(gates.zig:374-544 analog, extended to ALL gates + heterogeneous batches)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import gates as G

from tests.conftest import TRUTH_TABLES

# rows evaluate the shared truth-table lambdas over (a, b) in
# [(0,0), (0,1), (1,0), (1,1)] — one source of gate semantics for all suites
TRUTH = {name: [int(f(bool(a), bool(b)))
                for a, b in [(0, 0), (0, 1), (1, 0), (1, 1)]]
         for name, f in TRUTH_TABLES.items()}


@pytest.fixture(scope="module")
def ab(tiny, tiny_sk):
    A = jnp.asarray([False, False, True, True])
    B = jnp.asarray([False, True, False, True])
    a = tlwe.encrypt_bool(jax.random.key(21), A, tiny.tlwe_lv0.alpha, tiny_sk.key_lv0)
    b = tlwe.encrypt_bool(jax.random.key(22), B, tiny.tlwe_lv0.alpha, tiny_sk.key_lv0)
    return a, b


@pytest.mark.parametrize("name", sorted(TRUTH))
def test_gate_truth_table(name, ab, tiny_sk, tiny_ck):
    a, b = ab
    out = G.gate(name, a, b, tiny_ck)
    dec = np.asarray(tlwe.decrypt_bool(out, tiny_sk.key_lv0)).astype(int)
    assert list(dec) == TRUTH[name], name


def test_heterogeneous_gate_batch(ab, tiny_sk, tiny_ck):
    # every gate type in ONE bootstrap call, 4 input combos each
    a, b = ab
    names = sorted(TRUTH)
    ids = jnp.asarray(np.repeat([G.GATE_IDS[n] for n in names], 4).astype(np.int32))
    A = jnp.tile(a, (len(names), 1))
    B = jnp.tile(b, (len(names), 1))
    out = G.apply_gates(ids, A, B, tiny_ck)
    dec = np.asarray(tlwe.decrypt_bool(out, tiny_sk.key_lv0)).astype(int)
    expected = np.concatenate([TRUTH[n] for n in names])
    assert np.array_equal(dec, expected)


def test_not_copy_constant(ab, tiny, tiny_sk):
    a, _ = ab
    dec_not = np.asarray(tlwe.decrypt_bool(G.not_(a), tiny_sk.key_lv0)).astype(int)
    assert list(dec_not) == [1, 1, 0, 0]
    assert np.array_equal(np.asarray(G.copy(a)), np.asarray(a))
    ct_t = G.constant(True, tiny)
    ct_f = G.constant(False, tiny)
    assert bool(tlwe.decrypt_bool(ct_t, tiny_sk.key_lv0))
    assert not bool(tlwe.decrypt_bool(ct_f, tiny_sk.key_lv0))


def test_mux_both_variants(tiny, tiny_sk, tiny_ck):
    # all 8 combos of (a, b, c)
    combos = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    A = jnp.asarray([bool(x[0]) for x in combos])
    B = jnp.asarray([bool(x[1]) for x in combos])
    C = jnp.asarray([bool(x[2]) for x in combos])
    expect = [b if a else c for a, b, c in combos]
    cta = tlwe.encrypt_bool(jax.random.key(31), A, 0.0, tiny_sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(32), B, 0.0, tiny_sk.key_lv0)
    ctc = tlwe.encrypt_bool(jax.random.key(33), C, 0.0, tiny_sk.key_lv0)
    for fn in (G.mux, G.mux_naive):
        out = fn(cta, ctb, ctc, tiny_ck)
        dec = np.asarray(tlwe.decrypt_bool(out, tiny_sk.key_lv0)).astype(int)
        assert list(dec) == expect, fn.__name__


def test_bootstrap_refreshes_noise(tiny, tiny_sk, tiny_ck):
    # bootstrap output phase is within margin of +-1/8 exactly (alpha=0 pipeline)
    from zig_tfhe_jax import bootstrap as BS
    bits = jnp.asarray([True, False])
    ct = tlwe.encrypt_bool(jax.random.key(41), bits, 0.0, tiny_sk.key_lv0)
    out = BS.bootstrap(ct, tiny_ck)
    ph = np.asarray(tlwe.phase(out, tiny_sk.key_lv0)).astype(np.int64)
    target = np.where(np.asarray(bits), 1 << 29, -(1 << 29))
    err = np.abs(ph - target)
    # design bound at alpha=0: modswitch phase error <= (n0+1)/(4N) of the
    # torus (params.py) plus the key-switch decomposition rounding
    # n0 * 2^(32 - basebit*iks_t - 1) — a structural bound, not a
    # seed-dependent constant
    p = tiny
    bound = ((p.n0 + 1) * (1 << 32)) // (4 * p.N)         + p.n0 * (1 << (32 - p.basebit * p.iks_t - 1))
    assert np.all(err <= bound), (ph, target, bound)
