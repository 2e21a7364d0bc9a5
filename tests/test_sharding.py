"""Mesh sharding: batch-sharded gate evaluation must be BIT-EXACT vs
single-device evaluation (the invariant SURVEY.md §5 assigns to the
distributed design).  Runs on the 8-device virtual CPU mesh (conftest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as Pspec

from zig_tfhe_jax import key as K, tlwe
from zig_tfhe_jax.models import gates as G
from zig_tfhe_jax.parallel import mesh as M


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 cpu devices"
    return M.make_mesh(n_data=4, n_model=2)


def test_mesh_construction(mesh8):
    assert mesh8.shape == {"data": 4, "model": 2}


def test_sharded_gates_bit_exact(tiny, tiny_sk, tiny_ck, mesh8, rng):
    B = 16
    bits_a = jnp.asarray(rng.integers(0, 2, B).astype(bool))
    bits_b = jnp.asarray(rng.integers(0, 2, B).astype(bool))
    cta = tlwe.encrypt_bool(jax.random.key(101), bits_a, 0.0, tiny_sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(102), bits_b, 0.0, tiny_sk.key_lv0)
    ids = jnp.asarray(rng.integers(0, len(G.GATE_NAMES), B).astype(np.int32))

    # single-device reference
    ref = np.asarray(G.apply_gates(ids, cta, ctb, tiny_ck))

    # sharded: batch over data, KSK rows over model (psum contraction)
    batch_sh = NamedSharding(mesh8, Pspec("data"))
    repl = NamedSharding(mesh8, Pspec())
    ck_sh = K.CloudKey(
        testvec=jax.device_put(tiny_ck.testvec, repl),
        ksk1=jax.device_put(tiny_ck.ksk1, NamedSharding(mesh8, Pspec("model", None))),
        bsk_ntt=(jax.device_put(tiny_ck.bsk_ntt, repl)
                 if tiny_ck.bsk_ntt is not None else None),
        bsk_ext_limbs=(jax.device_put(tiny_ck.bsk_ext_limbs, repl)
                       if tiny_ck.bsk_ext_limbs is not None else None),
        params=tiny,
        bsk_ntt_drop=tiny_ck.bsk_ntt_drop,
        bsk_group=tiny_ck.bsk_group,
    )
    ids_s, cta_s, ctb_s = (jax.device_put(x, batch_sh) for x in (ids, cta, ctb))
    step = jax.jit(lambda i, a, b: G.apply_gates(i, a, b, ck_sh))
    with mesh8:
        out = step(ids_s, cta_s, ctb_s)
    assert np.array_equal(np.asarray(out), ref)  # bit-exact across placements


def test_shard_batch_helper(tiny, tiny_sk, mesh8):
    B = 8
    ct = tlwe.encrypt_bool(jax.random.key(103), jnp.zeros(B, bool), 0.0,
                           tiny_sk.key_lv0)
    sharded = M.shard_batch(mesh8, ct)
    assert sharded.sharding.spec == Pspec("data")
    repl = M.replicate(mesh8, ct)
    assert repl.sharding.spec == Pspec()


def test_shard_map_gates(tiny, tiny_sk, tiny_ck, mesh8):
    """Explicit shard_map evaluation matches the single-device result."""
    B = 16
    rng = np.random.default_rng(5)
    bits_a = jnp.asarray(rng.integers(0, 2, B).astype(bool))
    bits_b = jnp.asarray(rng.integers(0, 2, B).astype(bool))
    cta = tlwe.encrypt_bool(jax.random.key(201), bits_a, 0.0, tiny_sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(202), bits_b, 0.0, tiny_sk.key_lv0)
    ids = jnp.asarray(rng.integers(0, len(G.GATE_NAMES), B).astype(np.int32))

    ref = np.asarray(G.apply_gates(ids, cta, ctb, tiny_ck))
    run = M.shard_map_gates(mesh8, tiny_ck)
    out = np.asarray(run(*(M.shard_batch(mesh8, x) for x in (ids, cta, ctb))))
    assert np.array_equal(out, ref)  # bit-exact across placements


def test_sharded_integer_ops_bit_exact(mesh8):
    """The integer layer's radix ops are batch-first like gates: a
    data-sharded batch must be BIT-EXACT vs single-device (the bucket
    padding keeps the flattened batch divisible across the axis)."""
    from zig_tfhe_jax import params as P
    from zig_tfhe_jax.models import integer as I

    params = P.TEST_TINY_UINT
    sk = K.SecretKey.generate(jax.random.key(300), params)
    ck = K.CloudKey.generate(jax.random.key(301), sk, params)
    rng = np.random.default_rng(11)
    B = 8
    av = rng.integers(0, 64, B)
    bv = rng.integers(0, 64, B)
    ca = I.encrypt_radix(jax.random.key(302), av, 2, 0.0, sk.key_lv0)
    cb = I.encrypt_radix(jax.random.key(303), bv, 2, 0.0, sk.key_lv0)

    ref_add = np.asarray(I.radix_add(ca, cb, ck))
    ref_lt = np.asarray(I.radix_lt(ca, cb, ck))

    batch_sh = NamedSharding(mesh8, Pspec("data"))
    repl = NamedSharding(mesh8, Pspec())
    ck_r = jax.tree.map(lambda x: jax.device_put(x, repl), ck)
    ca_s = jax.device_put(ca, batch_sh)
    cb_s = jax.device_put(cb, batch_sh)
    with mesh8:
        out_add = np.asarray(I.radix_add(ca_s, cb_s, ck_r))
        out_lt = np.asarray(I.radix_lt(ca_s, cb_s, ck_r))
    assert np.array_equal(out_add, ref_add)
    assert np.array_equal(out_lt, ref_lt)
    assert np.array_equal(I.decrypt_radix(out_add, sk.key_lv0), av + bv)


def test_sharded_split_gates_bit_exact(mesh8):
    """The 64-bit split-ring engine under a data-sharded batch must be
    BIT-EXACT vs single-device (VERDICT r4 #6: the scan/gather/fold
    pipeline of ops/split_ring.py had no multi-chip coverage).  Covers
    the hi-plane int32 scan (drop=32 default) across placements."""
    from zig_tfhe_jax import params as P

    params = P.TEST_TINY_SPLIT
    sk = K.SecretKey.generate(jax.random.key(500), params)
    ck = K.CloudKey.generate(jax.random.key(501), sk, params,
                             packing_key=False)
    rng = np.random.default_rng(12)
    B = 8
    bits_a = jnp.asarray(rng.integers(0, 2, B).astype(bool))
    bits_b = jnp.asarray(rng.integers(0, 2, B).astype(bool))
    cta = tlwe.encrypt_bool(jax.random.key(502), bits_a, 0.0, sk.key_lv0,
                            width=64)
    ctb = tlwe.encrypt_bool(jax.random.key(503), bits_b, 0.0, sk.key_lv0,
                            width=64)
    ids = jnp.asarray(rng.integers(0, len(G.GATE_NAMES), B).astype(np.int32))

    ref = np.asarray(G.apply_gates(ids, cta, ctb, ck))

    batch_sh = NamedSharding(mesh8, Pspec("data"))
    repl = NamedSharding(mesh8, Pspec())
    ck_r = jax.tree.map(lambda x: jax.device_put(x, repl), ck)
    ids_s, cta_s, ctb_s = (jax.device_put(x, batch_sh)
                           for x in (ids, cta, ctb))
    with mesh8:
        out = step_out = jax.jit(
            lambda i, a, b: G.apply_gates(i, a, b, ck_r))(ids_s, cta_s,
                                                          ctb_s)
    assert np.array_equal(np.asarray(out), ref)
    dec = np.asarray(tlwe.decrypt_bool(step_out, sk.key_lv0))
    assert dec.shape == (B,)


def test_sharded_radix_lut_bit_exact(mesh8):
    """The radix tree-PBS (multi-value mid layer + packing key switch +
    select rotation) under a data-sharded batch must be BIT-EXACT vs
    single-device — the whole route is batch-leading ops, so sharding
    the lo/hi digit batches shards every stage."""
    from zig_tfhe_jax import params as P
    from zig_tfhe_jax.models import lut as L
    from zig_tfhe_jax.ops.packing_keyswitch import gen_packing_ksk

    params = P.TEST_TINY_UINT
    sk = K.SecretKey.generate(jax.random.key(400), params)
    ck = K.CloudKey.generate(jax.random.key(401), sk, params)
    pksk = gen_packing_ksk(jax.random.key(402), sk.key_lv1, params)
    m = 64
    f = lambda x: (x * 3 + 5) % m
    msgs = np.arange(8) * 8 % m
    cts = L.encrypt_radix_message(jax.random.key(403), msgs, m, 0.0,
                                  sk.key_lv0)
    ref = tuple(np.asarray(o)
                for o in L.bootstrap_lut_radix(*cts, f, m, ck, pksk))

    batch_sh = NamedSharding(mesh8, Pspec("data"))
    repl = NamedSharding(mesh8, Pspec())
    ck_r = jax.tree.map(lambda x: jax.device_put(x, repl), ck)
    pksk_r = jax.device_put(pksk, repl)
    cts_s = tuple(jax.device_put(c, batch_sh) for c in cts)
    with mesh8:
        out = L.bootstrap_lut_radix(*cts_s, f, m, ck_r, pksk_r)
    assert np.array_equal(np.asarray(out[0]), ref[0])
    assert np.array_equal(np.asarray(out[1]), ref[1])
    assert list(np.asarray(L.decrypt_radix_message(out, m, sk.key_lv0))) \
        == [f(int(x)) for x in msgs]
