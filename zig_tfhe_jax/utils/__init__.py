from zig_tfhe_jax.utils import torus
from zig_tfhe_jax.utils import rng
