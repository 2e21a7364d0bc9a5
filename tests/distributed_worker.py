"""Worker process for the two-process distributed test.

Run (by tests/test_distributed.py, one per process):
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
    python tests/distributed_worker.py <pid> <nprocs> <port> <tmpdir>

Flow (the SURVEY §5 multi-host design, real processes — not virtual
devices): jax.distributed connect -> process 0 generates + serializes the
CloudKey -> barrier (the cross-host key broadcast) -> all load/replicate -> global
8-device mesh -> batched gates over a globally batch-sharded array ->
each process decrypts ITS local shards and checks them bit-exactly.
Prints "DISTRIBUTED_OK pid=<i>" on success.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import jax

# the two-process test runs on virtual CPU devices: pin the backend
# BEFORE distributed/device init
jax.config.update("jax_platforms", "cpu")


def main():
    pid, nprocs, port, tmpdir = (int(sys.argv[1]), int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    from zig_tfhe_jax.parallel import distributed as D

    D.initialize(f"localhost:{port}", nprocs, pid)
    assert jax.process_index() == pid
    n_local = len(jax.local_devices())
    n_global = len(jax.devices())
    assert n_global == nprocs * n_local, (n_global, nprocs, n_local)

    import numpy as np
    import jax.numpy as jnp

    from zig_tfhe_jax import key as K
    from zig_tfhe_jax import params as P
    from zig_tfhe_jax import tlwe
    from zig_tfhe_jax.models import gates as G
    from zig_tfhe_jax.parallel import mesh as M
    from zig_tfhe_jax.utils import serialization as ser

    params = P.TEST_TINY
    key_path = os.path.join(tmpdir, "cloud_key.npz")
    sk_path = os.path.join(tmpdir, "secret_key.npz")

    ck = None
    if pid == 0:
        sk = K.SecretKey.generate(jax.random.key(0), params)
        ck = K.CloudKey.generate(jax.random.key(1), sk, params)
        ser.save_secret_key(sk_path, sk, params)
    ck = D.broadcast_cloud_key(key_path, ck)
    sk, _ = ser.load_secret_key(sk_path)  # test-only: decrypt locally

    # global mesh over every device of every process
    mesh = M.make_mesh(devices=jax.devices())
    ck_g = D.replicate_global(mesh, ck)

    # per-process local quarter of the batch: different data per process
    B_local = 8
    rng = np.random.default_rng(100 + pid)
    bits_a = rng.integers(0, 2, B_local).astype(bool)
    bits_b = rng.integers(0, 2, B_local).astype(bool)
    ids = rng.integers(0, 4, B_local).astype(np.int32)  # nand/or/and/xor
    truth = {"nand": lambda a, b: not (a and b), "or": lambda a, b: a or b,
             "and": lambda a, b: a and b, "xor": lambda a, b: a != b}
    names = [G.GATE_NAMES[i] for i in ids]
    expected = np.array([truth[n](bool(a), bool(b))
                         for n, a, b in zip(names, bits_a, bits_b)])

    cta = tlwe.encrypt_bool(jax.random.key(200 + pid), jnp.asarray(bits_a),
                            params.tlwe_lv0.alpha, sk.key_lv0)
    ctb = tlwe.encrypt_bool(jax.random.key(300 + pid), jnp.asarray(bits_b),
                            params.tlwe_lv0.alpha, sk.key_lv0)

    g_ids = D.global_batch(mesh, ids)
    g_a = D.global_batch(mesh, np.asarray(cta))
    g_b = D.global_batch(mesh, np.asarray(ctb))

    run = D.distributed_gates(mesh, ck_g)
    out = run(g_ids, g_a, g_b)

    local = D.local_shards(out)                      # this process's rows
    dec = np.asarray(tlwe.decrypt_bool(jnp.asarray(local), sk.key_lv0))
    assert local.shape == (B_local, params.n0 + 1), local.shape
    assert np.array_equal(dec, expected), (dec, expected)

    D.barrier("ztfhe_done")
    print(f"DISTRIBUTED_OK pid={pid}", flush=True)


if __name__ == "__main__":
    main()
