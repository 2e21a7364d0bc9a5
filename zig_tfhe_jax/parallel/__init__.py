from zig_tfhe_jax.parallel import mesh
from zig_tfhe_jax.parallel import distributed
