"""Test configuration: the CPU backend with an 8-device virtual mesh.

Tests run on the CPU unless JAX_PLATFORMS names another backend, so they
are fast, deterministic, and can exercise multi-device sharding via
--xla_force_host_platform_device_count (SURVEY.md §4's recommendation).
Tests marked ``chip`` need a GPU and skip without one; run them on the
card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m chip
"""

import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ON_CPU = os.environ.get("JAX_PLATFORMS", "").strip().lower() in ("", "cpu")

if ON_CPU:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")
# int64 carriers for the 64-bit-torus pipeline (tests/test_torus64.py).
# The 32-bit paths are dtype-explicit throughout (int32/int16/int8), so
# enabling x64 suite-wide changes nothing for them — and one uniform
# config beats an import-order-dependent flip inside one test module.
jax.config.update("jax_enable_x64", True)
# persistent compile cache: repeated suite runs skip most XLA compiles
jax.config.update("jax_compilation_cache_dir",
                  os.environ.get("JAX_COMPILATION_CACHE_DIR")
                  or os.path.join(REPO, ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

# The suite's compiled executables mmap ~900 new vmas/minute on the
# 8-device CPU client; at the kernel default vm.max_map_count = 65530
# pytest SEGFAULTS mid-suite once mmap starts failing (measured: the
# crash moved with total compile volume, landing in XLA's compile or
# cache-deserialize paths — both mmap JIT code pages).  Fail fast with
# the fix instead of a mystery segv 30 minutes in.
try:
    with open("/proc/sys/vm/max_map_count") as f:
        _max_maps = int(f.read())
    if _max_maps < 262144:
        # self-heal when privileged (root CI containers, dev boxes after
        # a reboot reset the sysctl), else warn loudly.  The write mutates
        # HOST-GLOBAL kernel state, so it is opt-out (ZTFHE_FIX_MAX_MAP_COUNT=0
        # on shared boxes), announced when it fires, and re-read to confirm
        # it actually took effect rather than assumed.
        if os.environ.get("ZTFHE_FIX_MAX_MAP_COUNT", "1") not in ("0", "false"):
            _old_maps = _max_maps
            try:
                with open("/proc/sys/vm/max_map_count", "w") as f:
                    f.write("1048576")
                with open("/proc/sys/vm/max_map_count") as f:
                    _max_maps = int(f.read())
                import sys

                print(f"[conftest] raised vm.max_map_count {_old_maps} -> "
                      f"{_max_maps} (host-global; set "
                      "ZTFHE_FIX_MAX_MAP_COUNT=0 to disable)",
                      file=sys.stderr)
            except (OSError, ValueError):
                pass
    if _max_maps < 262144:
        import warnings

        warnings.warn(
            f"vm.max_map_count = {_max_maps}: a FULL suite run exhausts "
            "the kernel default after ~30 min and segfaults inside XLA "
            "(small subsets are fine). Fix with: "
            "sudo sysctl -w vm.max_map_count=1048576", stacklevel=1)
except (OSError, ValueError):  # non-Linux / restricted /proc
    pass

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from zig_tfhe_jax import params as P  # noqa: E402
from zig_tfhe_jax import key as K  # noqa: E402


@pytest.fixture(scope="session")
def tiny():
    return P.TEST_TINY


@pytest.fixture(scope="session")
def tiny_sk(tiny):
    return K.SecretKey.generate(jax.random.key(7), tiny)


@pytest.fixture(scope="session")
def tiny_ck(tiny, tiny_sk):
    return K.CloudKey.generate(jax.random.key(8), tiny_sk, tiny)


@pytest.fixture()
def gpu():
    """The first GPU device; skips the test where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev


@pytest.fixture()
def rng():
    # function-scoped: each test draws from a fresh seeded stream, so a
    # failure reproduces in isolation regardless of which tests ran before
    return np.random.default_rng(42)


# Plain-boolean truth tables for the 10 two-input gates (single source;
# test_gates/test_multibit/test_scheduler all assert against this).
import operator  # noqa: E402

TRUTH_TABLES = {
    "nand": lambda x, y: not (x and y), "or": operator.or_,
    "and": operator.and_, "xor": operator.xor,
    "xnor": lambda x, y: x == y, "nor": lambda x, y: not (x or y),
    "andny": lambda x, y: (not x) and y, "andyn": lambda x, y: x and not y,
    "orny": lambda x, y: (not x) or y, "oryn": lambda x, y: x or not y,
}
