"""Two-PROCESS distributed evaluation (SURVEY §5's multi-host design).

Unlike tests/test_sharding.py (virtual devices in one process), this
spawns two real OS processes connected via jax.distributed, broadcasts
the serialized CloudKey through the filesystem (the cross-host broadcast stand-in), forms
one global 8-device mesh (2 processes x 4 CPU devices), and checks that
batched gates over a globally batch-sharded array decrypt bit-exactly on
BOTH processes.  This is the path a pod-scale deployment uses; the
reference has no analog (single process, thread_pool.zig only).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gates_bit_exact(tmp_path):
    # bounded by the communicate(timeout=540) below (pytest-timeout is not
    # a dependency)
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)        # worker pins cpu in code
    env["JAX_COMPILATION_CACHE_DIR"] = "/tmp/ztfhe_jax_cache"
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", str(port),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"distributed workers timed out; partial output: {outs}")
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"DISTRIBUTED_OK pid={pid}" in out, out
