#!/usr/bin/env python
"""Microbenchmark of blind-rotation step components on the current device.

Standalone op timings would measure dispatch more than the op.  Each
component is
timed as a K-iteration ``lax.scan`` inside ONE jit, with a carried data
dependency so XLA cannot hoist or DCE the body; per-iteration cost is the
slope between a K and a 2K run (cancels dispatch + scan setup overhead).

Usage: BENCH_BATCH=1024 BENCH_K=20 python bench_components.py [params]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# persistent compilation cache: repeat runs skip the compiles
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"))

import jax

import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import params as P
from zig_tfhe_jax.ops import blind_rotate as BR
from zig_tfhe_jax.ops import poly
from zig_tfhe_jax.utils.profiling import time_op
from zig_tfhe_jax.utils.torus import i32_to_i8_limbs

pname = sys.argv[1] if len(sys.argv) > 1 else "128bit"
params = P.PARAMS_BY_NAME[pname]
B = int(os.environ.get("BENCH_BATCH", "1024"))
K = int(os.environ.get("BENCH_K", "20"))
N, L = params.N, params.L
rng = np.random.default_rng(0)

bsk_i = jnp.asarray(rng.integers(-128, 128, (4, 2 * L, 2, 2 * N)).astype(np.int8))
acc = jnp.asarray(rng.integers(-2**31, 2**31, (B, 2, N)).astype(np.int32))
a_col = jnp.asarray(rng.integers(-2**31, 2**31, B).astype(np.int32))
digits = jnp.asarray(rng.integers(-32, 32, (B, 2 * L * N)).astype(np.int8))
mats = jnp.asarray(rng.integers(-128, 128, (4, 2 * L * N, 2 * N)).astype(np.int8))


def scan_time(body, init, k):
    """Seconds for a k-iteration scan of body (one jit dispatch)."""
    def run(x):
        def step(c, i):
            return body(c, i), None
        c, _ = jax.lax.scan(step, x, jnp.arange(k, dtype=jnp.int32))
        return c
    return time_op(jax.jit(run), init)


def report(name, body, init, flops=None):
    t1 = scan_time(body, init, K)
    t2 = scan_time(body, init, 2 * K)
    dt = max((t2 - t1) / K, 1e-9)
    extra = f"  ({flops/dt/1e12:.1f} TOPS)" if flops else ""
    print(f"{name:28s} {dt*1e3:8.3f} ms/iter{extra}", flush=True)
    return dt


print(f"device={jax.devices()[0]}, params={pname}, B={B}, K={K}")

# perturb the carry each iter so nothing is loop-invariant
report("toeplitz build (1 step)",
       lambda c, i: (c + BR._trgsw_matrices(c, params)[:, 0, 0]
                     .reshape(-1, 1, 1, 1).astype(jnp.int8)),
       bsk_i)
report("rotate acc",
       lambda c, i: poly.negacyclic_rotate(c, BR.modswitch(a_col + i, params)),
       acc)
report("decompose",
       lambda c, i: BR._decompose_to_rows(c + i, params)[..., :2, :].astype(jnp.int32)
                    .sum(-2, keepdims=True) + c,
       acc)
report("limb recode",
       lambda c, i: c + i32_to_i8_limbs(c + i, 1)[..., 0].astype(jnp.int32),
       acc)
mm_flops = 4 * 2 * B * (2 * L * N) * (2 * N)
report("4x limb matmul",
       lambda c, i: jnp.tile(sum(
           jax.lax.dot_general((c + i.astype(jnp.int8)), mats[j],
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
           for j in range(4)), (1, (2 * L * N) // (2 * N))).astype(jnp.int8),
       digits, flops=mm_flops)


def one_step(acc, i):
    a_tilda = BR.modswitch(a_col + i, params)
    rotated = poly.negacyclic_rotate(acc, a_tilda)
    m = BR._trgsw_matrices(bsk_i, params)
    return acc + BR._external_product_from_mats(m, rotated - acc, params)


if os.environ.get("BENCH_TOEPLITZ"):
    dt_step = report("one full step (xla)", one_step, acc)
    print(f"=> projected scan ({params.n0} steps): {dt_step*params.n0*1e3:.0f} ms "
          f"-> {B/(dt_step*params.n0):.0f} gates/s")

# ---------------------------------------------------------------------------
# NTT engine step components
# ---------------------------------------------------------------------------
from zig_tfhe_jax.ops import ntt as NTT

drop = NTT.default_drop_bits(params)
plan = NTT.plan_for_params(params, drop)
print(f"\nNTT engine: primes={plan.primes}, drop={drop}")
dbound = 1 << (params.bgbit - 1)
bsk_i_ntt = jnp.asarray(
    rng.integers(-6000, 6000, (plan.n_primes, 2 * L, 2, N)).astype(np.int16))
t_col = jnp.asarray(rng.integers(0, 2 * N, B).astype(np.int32))
rows_i32 = jnp.asarray(rng.integers(-dbound, dbound, (B, 2 * L, N)).astype(np.int32))

fwd_flops = 2 * plan.n_primes * 2 * B * 2 * L * N * N * params.digit_limbs
report("ntt fwd (digits)",
       lambda c, i: jnp.stack(NTT.ntt_forward(c + i, plan, params.digit_limbs,
                                              dbound), -1)[..., 0] % dbound - c,
       rows_i32, flops=fwd_flops)

u_hats = [jnp.asarray(rng.integers(-p // 2, p // 2, (B, 2, N)).astype(np.int32))
          for p in plan.primes]


report("ntt pointwise extprod",
       lambda c, i: c + jnp.stack(
           NTT.pointwise_extprod([c[:, :2 * L] + i for _ in plan.primes],
                                 bsk_i_ntt, plan), 0).sum(0)[:, :1] * 0,
       jnp.asarray(rng.integers(-6000, 6000, (B, 2 * L, N)).astype(np.int32)))

report("ntt rotate_diag",
       lambda c, i: c + jnp.stack(NTT.rotate_diag(
           [c for _ in plan.primes], (t_col + i) % (2 * N), plan), 0).sum(0) * 0,
       u_hats[0])

inv_flops = 2 * plan.n_primes * 4 * B * 2 * N * N
report("ntt inverse+crt",
       lambda c, i: c + NTT.ntt_inverse_to_crt(
           [jnp.clip(c + i, -p // 2, p // 2) for p in plan.primes], plan) * 0,
       u_hats[0], flops=inv_flops)


def ntt_step(acc_c, i):
    t = BR.modswitch(a_col + i, params)
    rows = BR._decompose_to_rows(acc_c, params)
    d_hat = NTT.ntt_forward(rows, plan, params.digit_limbs, dbound)
    u_hat = NTT.pointwise_extprod(d_hat, bsk_i_ntt, plan)
    v_hat = NTT.rotate_diag(u_hat, t, plan, minus_one=True)
    delta = NTT.ntt_inverse_to_crt(v_hat, plan)
    if drop:
        delta = jax.lax.shift_left(delta, jnp.int32(drop))
    return acc_c + delta


dt_ntt = report("one full NTT step", ntt_step, acc)
print(f"=> projected scan ({params.n0} steps): {dt_ntt*params.n0*1e3:.0f} ms "
      f"-> {B/(dt_ntt*params.n0):.0f} gates/s")
