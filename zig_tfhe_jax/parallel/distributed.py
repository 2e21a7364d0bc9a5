"""Multi-process (multi-host) distributed evaluation.

The reference is strictly single-process (SURVEY.md §5: no network or
multi-process code anywhere; its parallel surface is a 16-thread parMap,
parallel/thread_pool.zig:39-128).  Across hosts the design is:

  * ``jax.distributed.initialize`` connects the processes; the global
    device set forms one ``Mesh`` (parallel/mesh.py axes);
  * the CLOUD KEY is broadcast host-to-host out of band — process 0
    serializes it (utils/serialization.py carries the full parameter
    manifest) onto a shared filesystem / object store, the others load it
    after a barrier (the cross-host key broadcast) — then each
    process replicates it onto its local devices;
  * ciphertext batches are process-local data joined into one global
    array sharded over the batch axis; gate evaluation is embarrassingly
    parallel, so the jitted computation needs NO collectives and scaling
    is linear;
  * every shard produces bit-exact int32 torus results regardless of
    placement (the invariant tests/test_distributed.py asserts across
    process boundaries).

Works on any backend; tests run 2 CPU processes x 4 virtual devices.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from zig_tfhe_jax.parallel import mesh as _mesh


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Connect this process to the job (jax.distributed under the hood).

    Must run before any device/backend use in the process.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def barrier(name: str = "ztfhe_barrier") -> None:
    """Block until every process reaches this point."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def broadcast_cloud_key(path, ck=None):
    """Key distribution: process 0 writes, everyone else reads.

    ``path`` must be visible to all processes (shared fs / object store —
    the cross-host broadcast channel).  Process 0 passes the key; others pass
    None and receive the loaded key.  Returns the CloudKey on every
    process.
    """
    from zig_tfhe_jax.utils import serialization as ser

    if jax.process_index() == 0:
        if ck is None:
            raise ValueError("process 0 must provide the cloud key")
        ser.save_cloud_key(path, ck)
    barrier("ztfhe_key_broadcast")
    if jax.process_index() != 0:
        ck = ser.load_cloud_key(path)
    return ck


def replicate_global(mesh, tree):
    """Replicate a pytree (CloudKey) across ALL processes' devices.

    Requires the host data to be identical on every process (guaranteed
    by broadcast_cloud_key).
    """
    sharding = NamedSharding(mesh, P())

    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def global_batch(mesh, local_x):
    """Join per-process local [B_local, ...] data into one global array
    sharded over the mesh's batch ("data") axis."""
    sharding = NamedSharding(mesh, P(_mesh.BATCH_AXIS))
    return jax.make_array_from_process_local_data(sharding, np.asarray(local_x))


def local_shards(global_x) -> np.ndarray:
    """This process's rows of a batch-sharded global array, stacked in
    device order (the inverse of global_batch for contiguous shardings)."""
    shards = sorted(global_x.addressable_shards, key=lambda s: s.index[0].start)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def distributed_gates(mesh, ck_global):
    """Batched heterogeneous gate evaluation over the global mesh.

    Returns ``run(gate_ids, ct_a, ct_b) -> global out`` where all inputs
    are global batch-sharded arrays (see global_batch).  The jit is
    computation-follows-sharding: each device evaluates only its lanes,
    no cross-device communication.
    """
    from zig_tfhe_jax.models import gates as G

    jf = jax.jit(G.apply_gates)

    def run(gate_ids, ct_a, ct_b):
        with mesh:
            return jf(gate_ids, ct_a, ct_b, ck_global)

    return run
