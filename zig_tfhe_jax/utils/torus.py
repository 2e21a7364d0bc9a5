"""Discretized-torus numerics.

Torus elements are 32-bit integers.  We carry them as ``int32`` everywhere:
two's-complement add/sub/mul wrap exactly like the reference's ``u32``
wrapping ops (tlwe.zig:120-239), and signed carriers are what signed int8
matmuls and elementwise integer ops want.  ``uint32`` views are provided for serialization
and codec work.

Reference semantics implemented here:
  - f64ToTorus: ``trunc(clamp(mod(d,1)*2^32, 0, 2^32-1))``  (utils.zig:28-33)
  - torusToF64: ``u32(t) / 2^32``                            (utils.zig:36-38)
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np


_TWO32 = float(1 << 32)


def f64_to_torus(d) -> np.int32:
    """Host-side exact conversion of a float (or array) to a torus int32.

    Mirrors utils.zig:28-33: wrap into [0,1), scale by 2^32, clamp to
    [0, 2^32-1], truncate toward zero.
    """
    d = np.asarray(d, dtype=np.float64)
    normalized = np.mod(d, 1.0)
    t = normalized * _TWO32
    t = np.clip(t, 0.0, float((1 << 32) - 1))
    return np.uint32(np.trunc(t)).astype(np.int32)


def torus_to_f64(t) -> np.float64:
    """Host-side torus -> float in [0, 1) (utils.zig:36-38)."""
    u = np.asarray(t).astype(np.int64) & 0xFFFFFFFF
    return u.astype(np.float64) / _TWO32


def torus_constant(d: float) -> int:
    """Python-int torus encoding of a float constant (for traced code)."""
    return int(f64_to_torus(float(d)).astype(np.uint32))


def to_i32(x: int) -> np.int32:
    """Wrap a Python int into an int32 bit pattern (mod 2^32)."""
    return np.int32(np.uint32(x & 0xFFFFFFFF))


# ---------------------------------------------------------------------------
# Width-generalized codecs (torus_bits in {32, 64}).
#
# The reference pins Torus=u32 at comptime (params.zig:21-30); parameter
# sets here carry ``torus_bits`` instead (the N=2048 door needs lv1 noise
# ~2^-50 of the torus, underflowing u32 — docs/TORUS64.md).  The 32-bit
# helpers above remain THE hot path; these generalizations serve the
# width-parameterized pipeline.  64-bit carriers are int64 and require
# jax_enable_x64 (require_width checks loudly).
# ---------------------------------------------------------------------------


def require_width(bits: int) -> None:
    """Fail fast (with the fix) when 64-bit carriers are unavailable."""
    if bits == 32:
        return
    assert bits == 64, bits
    if jnp.zeros((), jnp.int64).dtype != jnp.int64:
        raise RuntimeError(
            "this parameter set uses a 64-bit torus, which needs int64 "
            "carriers: run jax.config.update('jax_enable_x64', True) "
            "before building arrays (or set JAX_ENABLE_X64=1)")


def carrier_dtype(bits: int):
    """jnp dtype of a torus carrier at the given width."""
    return jnp.int32 if bits == 32 else jnp.int64


def torus_constant_w(d: float, bits: int) -> int:
    """Python-int torus encoding of a float constant at width ``bits``.

    Same semantics as the 32-bit codec (wrap into [0,1), scale by 2^bits,
    truncate): dyadic constants (gate biases, PBS bins) encode exactly;
    generic floats round at f64 precision, which is the codec definition.
    """
    if bits == 32:
        return torus_constant(d)
    normalized = float(d) % 1.0
    t = int(normalized * float(1 << bits))
    return min(max(t, 0), (1 << bits) - 1)


def to_carrier(x: int, bits: int):
    """Wrap a Python int into the carrier bit pattern (mod 2^bits)."""
    if bits == 32:
        return to_i32(x)
    return np.int64(np.uint64(x & 0xFFFFFFFFFFFFFFFF))


# ---------------------------------------------------------------------------
# Traced (jnp) helpers.  All operate on int32 carriers.
# ---------------------------------------------------------------------------


def shift_right_logical(x, amount: int):
    """Logical (zero-fill) right shift of torus carriers (any int width —
    lax requires the shift amount dtype to match the operand's)."""
    return jax.lax.shift_right_logical(
        x, jnp.asarray(amount, x.dtype) if x.dtype != jnp.int32
        else jnp.int32(amount))


def as_uint32(x):
    """Bitcast int32 carrier -> uint32 (serialization / codec)."""
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def as_int32(x):
    """Bitcast uint32 -> int32 carrier."""
    return jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.uint32), jnp.int32)


def torus_to_float(x, dtype=jnp.float32):
    """Traced torus int32 -> float in [0, 1)."""
    # int32 < 0 means top bit set: add 2^32 after float conversion.
    f = x.astype(dtype)
    f = jnp.where(x < 0, f + jnp.array(_TWO32, dtype), f)
    return f / jnp.array(_TWO32, dtype)


def torus_to_float_w(x, bits: int, dtype=None):
    """Traced torus carrier (width ``bits``) -> float in [0, 1).

    64-bit carriers convert at f64 (needs x64; relative error 2^-53 —
    far inside every decode margin)."""
    if bits == 32:
        return torus_to_float(x, dtype or jnp.float32)
    dtype = dtype or jnp.float64
    two_w = float(1 << bits)
    f = x.astype(dtype)
    f = jnp.where(x < 0, f + jnp.array(two_w, dtype), f)
    return f / jnp.array(two_w, dtype)


def i32_to_i8_limbs(x, n_limbs: int = 4):
    """Recode integer carriers into ``n_limbs`` signed int8 limbs,
    little-endian: value == sum_k limbs[k] * 2^(8k) (mod 2^(8*n_limbs)),
    each limb in [-128, 127].  This is the carrier format for exact
    modular arithmetic on int8 matmuls.  Works on int32
    (n_limbs <= 4, the hot path) and int64 carriers (n_limbs <= 8, the
    64-bit-torus pipeline).  Stacks limbs on a new trailing axis.
    """
    limbs = []
    r = x
    eight = jnp.asarray(8, x.dtype)
    for k in range(n_limbs):
        l = ((r + 128) & 255) - 128  # centered remainder in [-128, 127]
        limbs.append(l.astype(jnp.int8))
        if k + 1 < n_limbs:
            # (r - l) is divisible by 256; arithmetic shift == exact division.
            r = jax.lax.shift_right_arithmetic(r - l, eight)
    return jnp.stack(limbs, axis=-1)


def i8_limbs_combine(parts, shifts, width: int = 32):
    """Combine int32 partial results: sum_i parts[i] << shifts[i]
    (mod 2^width).

    Shifts >= width contribute nothing mod 2^width and must be filtered by
    the caller (we assert here to catch waste).  width=64 lifts the int32
    partials onto int64 carriers before shifting (elementwise: every
    64-bit contraction routes through int8-limb matmuls + this combine;
    see ops/poly.py:small_matmul_torus).
    """
    dtype = carrier_dtype(width)
    out = None
    for p, s in zip(parts, shifts):
        assert s < width, f"shift >= {width} is a wasted matmul pass"
        p = p.astype(dtype)
        term = jax.lax.shift_left(p, jnp.asarray(s, dtype)) if s else p
        out = term if out is None else out + term
    return out
