"""zig_tfhe_jax — a TFHE framework in JAX for accelerators.

A from-scratch re-design of the capabilities of thedonutfactory/zig-tfhe for
batched accelerator execution: batch-first ciphertext arrays, exact mod-2^32
arithmetic via signed int8-limb matmuls (no float FFT), one-matmul key
switching, lax.scan blind rotation, and mesh sharding over the gate batch.

Quick start::

    import jax
    from zig_tfhe_jax import params, key, models

    sk = key.SecretKey.generate(jax.random.key(0), params.SECURITY_128_BIT)
    ck = key.CloudKey.generate(jax.random.key(1), sk, params.SECURITY_128_BIT)
    ...
"""

from zig_tfhe_jax import params
from zig_tfhe_jax import utils
from zig_tfhe_jax import ops
from zig_tfhe_jax import tlwe
from zig_tfhe_jax import trlwe
from zig_tfhe_jax import trgsw
from zig_tfhe_jax import key
from zig_tfhe_jax import bootstrap
from zig_tfhe_jax import models
from zig_tfhe_jax import parallel

__version__ = "0.5.0"


def get_info() -> dict:
    """Library info (main.zig:85-97 analog)."""
    import jax

    return {
        "name": "zig_tfhe_jax",
        "version": __version__,
        "backend": jax.default_backend(),
        "devices": len(jax.devices()),
        "default_security": params.DEFAULT_SECURITY.name,
    }


def print_info() -> None:
    for k, v in get_info().items():
        print(f"{k}: {v}")
