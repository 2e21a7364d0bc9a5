from zig_tfhe_jax.models import gates
from zig_tfhe_jax.models import lut
from zig_tfhe_jax.models import proxy_reenc
from zig_tfhe_jax.models import circuits
from zig_tfhe_jax.models import integer
