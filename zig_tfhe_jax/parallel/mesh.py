"""Device mesh + sharding for batched FHE evaluation.

The reference's entire parallel surface is a 16-thread ``parMap`` over
independent blind rotations (parallel/thread_pool.zig:39-128).  The
replacement is layered:

  kernel level — int8 matmuls inside each CMux (ops/blind_rotate.py);
  device level — the batch axis B of ciphertexts (vmap is implicit: every op
                 is written batch-first);
  mesh level   — shard the batch axis over a ``jax.sharding.Mesh`` ("data"
                 axis) and optionally split the key-switch/external-product
                 contraction over a "model" axis.  Keys are replicated;
                 gate evaluation is embarrassingly parallel over lanes, so
                 the only collectives are the psums of model-sharded
                 matmuls and ciphertext all-gathers between circuit stages.

Every shard must (and does) produce bit-exact int32 torus results
regardless of placement — the invariant the reference's semantics define.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices: Sequence | None = None) -> Mesh:
    """Build a (data, model) mesh over available devices."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if n_data is None:
        n_data = len(devices) // n_model
    arr = np.array(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(arr, (BATCH_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Ciphertext batches: leading axis over the data axis."""
    return NamedSharding(mesh, P(BATCH_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Keys: replicated everywhere."""
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, x):
    """Place a [B, ...] array with B sharded over the data axis."""
    return jax.device_put(x, batch_sharding(mesh))


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (e.g. a CloudKey) across the mesh."""
    return jax.device_put(tree, replicated(mesh))


def shard_map_gates(mesh: Mesh, ck):
    """Explicit-SPMD batched gate evaluation via shard_map.

    Returns ``f(gate_ids, ct_a, ct_b) -> ct_out`` where the ciphertext
    batch is split over the data axis and the CloudKey is replicated; each
    shard runs the full blind-rotate scan locally with NO collectives
    (gates are independent), so scaling is linear in mesh size.  The
    GSPMD path (jit + NamedSharding, tests/test_sharding.py) produces the
    same partitioning automatically; this explicit version pins it.
    """
    from zig_tfhe_jax.models import gates as G

    ck_r = replicate(mesh, ck)

    def local(ids, a, b, k):
        return G.apply_gates(ids, a, b, k)

    f = shard_map(
        local, mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(BATCH_AXIS), P(BATCH_AXIS), P()),
        out_specs=P(BATCH_AXIS),
    )
    jf = jax.jit(f)

    def run(gate_ids, ct_a, ct_b):
        with mesh:
            return jf(gate_ids, ct_a, ct_b, ck_r)

    return run


def gspmd_gates(mesh: Mesh, ck):
    """Batched gate evaluation by GSPMD (jit over sharded inputs).

    Returns ``f(gate_ids, ct_a, ct_b) -> ct_out``.  The ciphertext batch
    is placed over the data axis and the key-switching key's rows over
    the model axis, so the key-switch matmul contracts over a sharded
    dimension and XLA inserts a psum over "model"; the bootstrapping key
    and test vector are replicated.  On a mesh whose model axis has size
    one this is plain data parallelism.
    """
    from zig_tfhe_jax.models import gates as G

    ck_s = dataclasses.replace(
        replicate(mesh, ck),
        ksk1=jax.device_put(ck.ksk1, NamedSharding(mesh, P(MODEL_AXIS, None))))
    jf = jax.jit(G.apply_gates)

    def run(gate_ids, ct_a, ct_b):
        with mesh:
            return jf(shard_batch(mesh, gate_ids), shard_batch(mesh, ct_a),
                      shard_batch(mesh, ct_b), ck_s)

    return run
