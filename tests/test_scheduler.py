"""Native C++ circuit scheduler + batched level evaluator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zig_tfhe_jax import tlwe
from zig_tfhe_jax.models import circuits as C
from zig_tfhe_jax.models import gates as G
from zig_tfhe_jax.models import scheduler as S


def _full_adder_circuit():
    c = S.Circuit()
    a, b, cin = c.input(), c.input(), c.input()
    x = c.gate("xor", a, b)
    g = c.gate("and", a, b)
    s = c.gate("xor", x, cin)
    t = c.gate("and", x, cin)
    cout = c.gate("or", g, t)
    c.output(s)
    c.output(cout)
    return c


def test_schedule_structure():
    plan = _full_adder_circuit().schedule()
    assert plan.n_gates == 5
    # ASAP levels: {xor, and} | {xor, and} | {or}
    assert plan.n_levels == 3
    assert [len(l) for l in plan.levels] == [2, 2, 1]
    assert len(plan.input_slots) == 3
    assert len(plan.output_slots) == 2
    # slot reuse keeps the arena small
    assert plan.n_slots <= 8


def test_evaluate_full_adder(tiny, tiny_sk, tiny_ck):
    plan = _full_adder_circuit().schedule()
    for a, b, cin in [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1)]:
        bits = jnp.asarray([bool(a), bool(b), bool(cin)])
        cts = tlwe.encrypt_bool(jax.random.key(a * 4 + b * 2 + cin), bits, 0.0,
                                tiny_sk.key_lv0)
        out = S.evaluate(plan, cts, tiny_ck)
        dec = np.asarray(tlwe.decrypt_bool(out, tiny_sk.key_lv0)).astype(int)
        assert dec[0] == (a + b + cin) % 2, (a, b, cin)
        assert dec[1] == (a + b + cin) // 2, (a, b, cin)


def test_evaluate_with_not_copy_const_mux(tiny, tiny_sk, tiny_ck):
    c = S.Circuit()
    a, b = c.input(), c.input()
    na = c.not_(a)
    cb = c.copy(b)
    one = c.const(True)
    m = c.mux(na, cb, one)       # (!a) ? b : 1
    c.output(m)
    c.output(na)
    plan = c.schedule()
    for a_v, b_v in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        cts = tlwe.encrypt_bool(jax.random.key(a_v * 2 + b_v),
                                jnp.asarray([bool(a_v), bool(b_v)]), 0.0,
                                tiny_sk.key_lv0)
        out = S.evaluate(plan, cts, tiny_ck)
        dec = np.asarray(tlwe.decrypt_bool(out, tiny_sk.key_lv0)).astype(int)
        expect_m = b_v if not a_v else 1
        assert dec[0] == expect_m, (a_v, b_v)
        assert dec[1] == (1 - a_v)


BRISTOL_FA = """\
5 8
2 1 1
2 1 0 1 3 XOR
2 1 0 1 4 AND
2 1 3 2 5 XOR
2 1 3 2 6 AND
2 1 4 6 7 OR
"""
# wires: 0=a, 1=b, 2=cin, outputs: 7 (just carry, n_out=1)


def test_bristol_parse_and_eval(tiny, tiny_sk, tiny_ck):
    plan = S.parse_bristol(BRISTOL_FA)
    assert plan.n_gates == 5 and plan.n_levels == 3
    assert len(plan.input_slots) == 3 and len(plan.output_slots) == 1
    bits = jnp.asarray([True, True, False])  # a=1,b=1,cin=0 -> carry=1
    cts = tlwe.encrypt_bool(jax.random.key(99), bits, 0.0, tiny_sk.key_lv0)
    out = S.evaluate(plan, cts, tiny_ck)
    assert bool(tlwe.decrypt_bool(out, tiny_sk.key_lv0)[0])


def test_bristol_errors():
    with pytest.raises(ValueError, match="parse error"):
        S.parse_bristol("garbage")
    with pytest.raises(ValueError, match="unsupported gate"):
        S.parse_bristol("1 4\n2 1 1\n2 1 0 1 3 FROB\n")


def test_cycle_detection():
    # valid DAG schedules fine
    c = S.Circuit()
    a = c.input()
    w1 = c.gate("and", a, a)
    _ = c.gate("or", w1, a)
    plan = c.schedule()
    assert plan.n_gates == 2
    # a self-referential gate (reads its own output wire) is a cycle
    with pytest.raises(ValueError, match="cycle"):
        S.parse_bristol("1 3\n2 0 1\n2 1 0 2 2 AND\n")
    # an output wire written twice is rejected
    with pytest.raises(ValueError, match="written twice"):
        S.parse_bristol("2 3\n2 0 1\n2 1 0 1 2 AND\n2 1 1 0 2 OR\n")


def test_duplicate_operand_slot_reuse(tiny, tiny_sk, tiny_ck):
    """A gate reading the same wire twice at that wire's last use must free
    its slot ONCE: the old double-free handed the same arena slot to two
    simultaneously-live wires, silently corrupting downstream gates."""
    c = S.Circuit()
    i0, i1 = c.input(), c.input()
    w2 = c.gate("and", i0, i1)
    w3 = c.gate("and", w2, w2)      # last use of w2, same wire twice
    w4 = c.not_(w3)
    w5 = c.gate("and", w3, i0)      # w4 and w5 are simultaneously live
    w6 = c.gate("and", w4, w5)
    # output w4 and w5 DIRECTLY (not just a derived w6, whose value here
    # is constant-False and would mask some aliasing corruptions)
    for w in (w4, w5, w6):
        c.output(w)
    plan = c.schedule()
    # structural invariant: within a level, gate outputs get distinct slots
    for lvl in plan.levels:
        souts = [int(g[4]) for g in lvl]
        assert len(souts) == len(set(souts)), lvl
    for bits in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        x0, x1 = map(bool, bits)
        v3 = x0 and x1
        v4, v5 = (not v3), (v3 and x0)
        expected = [v4, v5, v4 and v5]
        cts = tlwe.encrypt_bool(jax.random.key(7), jnp.asarray(bits, bool),
                                0.0, tiny_sk.key_lv0)
        out = S.evaluate(plan, cts, tiny_ck)
        dec = [bool(v) for v in
               np.asarray(tlwe.decrypt_bool(out, tiny_sk.key_lv0))]
        assert dec == expected, (bits, dec, expected)


def test_malformed_bristol_is_an_error_not_a_crash():
    # out-of-range input wire (previously an OOB read/write -> SIGSEGV)
    with pytest.raises(ValueError, match="out of range"):
        S.parse_bristol("1 3\n2 0 1\n2 1 0 99999999 2 AND\n")
    # negative arity (previously std::length_error -> std::terminate)
    with pytest.raises(ValueError, match="arity"):
        S.parse_bristol("1 3\n2 0 1\n-5 1 0 1 2 AND\n")
    # unreasonable header counts
    with pytest.raises(ValueError, match="unreasonable"):
        S.parse_bristol("1 999999999999\n2 0 1\n2 1 0 1 2 AND\n")
    # output wire never produced (previously emitted a -1 slot that JAX
    # would wrap to the trash row)
    with pytest.raises(ValueError, match="never written"):
        S.parse_bristol("1 4\n2 0 2\n2 1 0 1 2 AND\n")


def test_random_circuits_match_boolean_simulation(tiny, tiny_sk, tiny_ck):
    """Fuzz: random DAGs through parse-free Circuit building, scheduled and
    evaluated homomorphically, must match a plain boolean simulation.
    Exercises slot reuse, level batching, every gate type, NOT/COPY/CONST
    and MUX lanes together."""
    rng = np.random.default_rng(1234)
    for trial in range(4):
        c = S.Circuit()
        n_in = 4
        wires = [c.input() for _ in range(n_in)]

        # plain-python mirror: wire id -> lambda over input bits
        sim = {w: (lambda bits, i=i: bits[i]) for i, w in enumerate(wires)}
        from tests.conftest import TRUTH_TABLES as _TT
        two_in = list(G.GATE_NAMES)
        all_wires = list(wires)
        for _ in range(14):
            kind = rng.integers(0, 8)
            if kind <= 4:  # two-input gate (biased: most common)
                name = two_in[rng.integers(0, len(two_in))]
                a, b = rng.choice(all_wires, 2)
                w = c.gate(name, int(a), int(b))
                sim[w] = (lambda bits, f=_TT[name], wa=a, wb=b:
                          f(sim[wa](bits), sim[wb](bits)))
            elif kind == 5:
                a = int(rng.choice(all_wires))
                w = c.not_(a)
                sim[w] = (lambda bits, wa=a: not sim[wa](bits))
            elif kind == 6:
                v = bool(rng.integers(0, 2))
                w = c.const(v)
                sim[w] = (lambda bits, vv=v: vv)
            else:
                s_, t_, f_ = rng.choice(all_wires, 3)
                w = c.mux(int(s_), int(t_), int(f_))
                sim[w] = (lambda bits, ws=s_, wt=t_, wf=f_:
                          sim[wt](bits) if sim[ws](bits) else sim[wf](bits))
            all_wires.append(w)
        outs = [int(w) for w in rng.choice(all_wires[n_in:], 3)]
        for w in outs:
            c.output(w)
        plan = c.schedule()

        for bits in [(0, 1, 1, 0), (1, 1, 0, 1)]:
            expected = [sim[w](list(map(bool, bits))) for w in outs]
            cts = tlwe.encrypt_bool(
                jax.random.key(trial), jnp.asarray(bits, bool), 0.0,
                tiny_sk.key_lv0)
            got = S.evaluate(plan, cts, tiny_ck)
            dec = [bool(x) for x in
                   np.asarray(tlwe.decrypt_bool(got, tiny_sk.key_lv0))]
            assert dec == expected, (trial, bits, dec, expected)


def test_evaluate_batched_serving_mode(tiny, tiny_sk, tiny_ck):
    """The same plan over a batch of client input sets ([n_inputs, B,
    n0+1]): all 8 full-adder input combinations evaluated in ONE pass,
    decrypts exact per client."""
    plan = _full_adder_circuit().schedule()
    combos = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    bits = jnp.asarray(np.array(combos, bool).T)          # [3, 8]
    cts = tlwe.encrypt_bool(jax.random.key(9), bits, 0.0,
                            tiny_sk.key_lv0)              # [3, 8, n0+1]
    out = S.evaluate(plan, cts, tiny_ck)                  # [2, 8, n0+1]
    assert out.shape == (2, 8, tiny.n0 + 1)
    dec = np.asarray(tlwe.decrypt_bool(out, tiny_sk.key_lv0)).astype(int)
    for i, (a, b, c) in enumerate(combos):
        assert dec[0, i] == (a + b + c) % 2, (a, b, c)
        assert dec[1, i] == (a + b + c) // 2, (a, b, c)
    # single-instance mode still returns the unbatched shape
    single = S.evaluate(plan, cts[:, 0], tiny_ck)
    assert single.shape == (2, tiny.n0 + 1)


def test_random_circuit_batched_matches_unbatched(tiny, tiny_sk, tiny_ck):
    """Fuzz the serving path: a random DAG evaluated over a batch of input
    sets must decrypt identically to per-instance evaluation (alpha=0)."""
    rng = np.random.default_rng(77)
    from tests.conftest import TRUTH_TABLES as _TT
    c = S.Circuit()
    n_in = 3
    wires = [c.input() for _ in range(n_in)]
    all_wires = list(wires)
    for _ in range(10):
        kind = rng.integers(0, 7)
        if kind <= 4:
            name = list(G.GATE_NAMES)[rng.integers(0, 10)]
            a, b = rng.choice(all_wires, 2)
            w = c.gate(name, int(a), int(b))
        elif kind == 5:
            w = c.not_(int(rng.choice(all_wires)))
        else:
            s_, t_, f_ = rng.choice(all_wires, 3)
            w = c.mux(int(s_), int(t_), int(f_))
        all_wires.append(w)
    for w in rng.choice(all_wires[n_in:], 2):
        c.output(int(w))
    plan = c.schedule()

    B = 8
    bits = rng.integers(0, 2, (n_in, B)).astype(bool)
    cts = tlwe.encrypt_bool(jax.random.key(5), jnp.asarray(bits), 0.0,
                            tiny_sk.key_lv0)                # [n_in, B, n0+1]
    batched = S.evaluate(plan, cts, tiny_ck)
    dec_b = np.asarray(tlwe.decrypt_bool(batched, tiny_sk.key_lv0))
    for j in range(B):
        single = S.evaluate(plan, cts[:, j], tiny_ck)
        dec_s = np.asarray(tlwe.decrypt_bool(single, tiny_sk.key_lv0))
        assert list(dec_b[:, j]) == list(dec_s), j


def test_bristol_multiplier_netlist_encrypted(tiny, tiny_sk, tiny_ck):
    """The generated Wallace-tree multiplier netlist (models/netlists.py —
    the scheduler-scale Bristol corpus, VERDICT r3 #7) evaluates exactly
    under encryption at w=8 (491 gates, ~30 levels); the plain evaluator
    is the oracle."""
    from zig_tfhe_jax.models.netlists import bristol_multiplier, \
        eval_bristol_plain

    w = 8
    text = bristol_multiplier(w)
    plan = S.parse_bristol(text)
    assert plan.n_gates > 400 and plan.n_levels > 10
    a, b = 202, 142
    bits = [(a >> i) & 1 for i in range(w)] + [(b >> i) & 1 for i in range(w)]
    assert sum(v << i for i, v in enumerate(
        eval_bristol_plain(text, bits))) == a * b
    cts = tlwe.encrypt_bool(jax.random.key(31), jnp.asarray(
        np.asarray(bits, bool)), 0.0, tiny_sk.key_lv0)
    out = S.evaluate(plan, cts, tiny_ck)
    dec = np.asarray(tlwe.decrypt_bool(out, tiny_sk.key_lv0))
    got = sum(int(v) << i for i, v in enumerate(dec))
    assert got == a * b, got


def test_chunked_levels_match_unchunked(tiny, tiny_sk, tiny_ck, monkeypatch):
    """Knee chunking (_chunk_level) is a pure dispatch partition: forcing
    tiny chunks (several dispatches per level, B > chunk) must decrypt
    identically to the unchunked evaluation.  Guards the round-4 fix for
    wide levels running one giant past-the-knee rotation (ROADMAP)."""
    from zig_tfhe_jax.models.netlists import bristol_multiplier

    plan = S.parse_bristol(bristol_multiplier(4))
    rng = np.random.default_rng(5)
    B = 3
    vals = rng.integers(0, 16, (2, B))
    bits = np.zeros((8, B), bool)
    for j in range(B):
        for i in range(4):
            bits[i, j] = (vals[0, j] >> i) & 1
            bits[4 + i, j] = (vals[1, j] >> i) & 1
    cts = tlwe.encrypt_bool(jax.random.key(9), jnp.asarray(bits), 0.0,
                            tiny_sk.key_lv0)
    monkeypatch.setenv("ZTFHE_LEVEL_CHUNK", "0")
    ref = np.asarray(tlwe.decrypt_bool(
        S.evaluate(plan, cts, tiny_ck), tiny_sk.key_lv0))
    monkeypatch.setenv("ZTFHE_LEVEL_CHUNK", "4")
    got = np.asarray(tlwe.decrypt_bool(
        S.evaluate(plan, cts, tiny_ck), tiny_sk.key_lv0))
    assert np.array_equal(ref, got)
    for j in range(B):
        prod = sum(int(got[i, j]) << i for i in range(8))
        assert prod == vals[0, j] * vals[1, j], j


def test_engine_aware_knee_defaults(monkeypatch):
    """The dispatch knees follow the engine: 2048 rotation lanes on the
    32-bit path, 512 on the split engine (round-5 B sweeps); env
    overrides win."""
    from zig_tfhe_jax import params as P
    from zig_tfhe_jax.models import lut as L
    from zig_tfhe_jax.models.gates import _pad_policy
    from zig_tfhe_jax.models.scheduler import _level_chunk_lanes

    monkeypatch.delenv("ZTFHE_LEVEL_CHUNK", raising=False)
    assert _level_chunk_lanes(P.SECURITY_128_BIT) == 2048
    assert _level_chunk_lanes(P.SECURITY_128_BIT_T64) == 512
    assert _level_chunk_lanes(None) == 2048
    monkeypatch.setenv("ZTFHE_LEVEL_CHUNK", "64")
    assert _level_chunk_lanes(P.SECURITY_128_BIT_T64) == 64
    assert L._rotation_knee(P.SECURITY_128_BIT) == 2048
    assert L._rotation_knee(P.SECURITY_128_BIT_T64) == 512
    # pad policy: 1536 special-case only on the 2048-knee path
    assert _pad_policy(1100) == 1536
    # above the 512 knee: next knee multiple when the pad is small
    assert _pad_policy(1100, knee=512) == 1100  # pad 436 > knee/4: keep
    assert _pad_policy(1500, knee=512) == 1536  # pad 36 <= 128: round up
    assert _pad_policy(400, knee=512) == 512
    assert _pad_policy(600, knee=512) == 600  # pad 424 > 128: keep
    assert _pad_policy(9, knee=512) == 16


def test_evaluate_full_adder_split64():
    """The arena follows the set's carrier dtype (ADVICE r4): a 64-bit
    split-ring circuit evaluates end-to-end with exact decrypts — before
    the fix the int32 arena silently downcast the int64 inputs and the
    first level died in blind_rotate's width check."""
    from zig_tfhe_jax import key as K
    from zig_tfhe_jax import params as P

    ps = P.TEST_TINY_SPLIT
    sk = K.SecretKey.generate(jax.random.key(7), ps)
    ck = K.CloudKey.generate(jax.random.key(8), sk, ps)
    plan = _full_adder_circuit().schedule()
    for a, b, cin in [(0, 0, 0), (1, 0, 1), (1, 1, 1)]:
        bits = jnp.asarray([bool(a), bool(b), bool(cin)])
        cts = tlwe.encrypt_bool(jax.random.key(a * 4 + b * 2 + cin), bits,
                                0.0, sk.key_lv0, width=64)
        assert cts.dtype == jnp.int64
        out = S.evaluate(plan, cts, ck)
        assert out.dtype == jnp.int64
        dec = np.asarray(tlwe.decrypt_bool(out, sk.key_lv0)).astype(int)
        assert dec[0] == (a + b + cin) % 2, (a, b, cin)
        assert dec[1] == (a + b + cin) // 2, (a, b, cin)
