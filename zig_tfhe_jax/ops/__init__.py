from zig_tfhe_jax.ops import poly
from zig_tfhe_jax.ops import decomposition
from zig_tfhe_jax.ops import blind_rotate
from zig_tfhe_jax.ops import keyswitch
