"""Programmable (LUT) bootstrapping: encoder, generator, lookup tables.

Mirrors the reference's lut/ package (encoder.zig, generator.zig,
lookup_table.zig) and — unlike the reference, whose documented
``bootstrapLut`` does not exist as code (lut.zig:42) — ships the end-to-end
``bootstrap_lut`` as a first-class batched op.

Testvec construction is host-side numpy (cheap, key-independent); evaluation
is the batched blind-rotation pipeline.  Per-gate testvecs are supported:
a batch can evaluate a *different* function per lane.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import bootstrap as _bootstrap
from zig_tfhe_jax import tlwe as _tlwe
from zig_tfhe_jax.key import CloudKey
from zig_tfhe_jax.params import SecurityParams
from zig_tfhe_jax.utils.torus import torus_constant_w


def div_round(a: int, b: int) -> int:
    """(a + b/2) // b (generator.zig:253-255)."""
    return (a + b // 2) // b


@dataclasses.dataclass(frozen=True)
class Encoder:
    """Message <-> torus codec with scale 1/(2m) (encoder.zig:29-116).

    ``width`` generalizes the codec to the 64-bit torus (the reference
    pins u32, params.zig:21-30): encodings are unsigned Python ints mod
    2^width.  Dyadic scales (every power-of-two modulus) encode exactly
    at either width.
    """

    message_modulus: int
    scale: float
    width: int = 32

    @classmethod
    def new(cls, message_modulus: int, width: int = 32) -> "Encoder":
        return cls(message_modulus, 1.0 / (2.0 * message_modulus), width)

    @classmethod
    def with_scale(cls, message_modulus: int, scale: float,
                   width: int = 32) -> "Encoder":
        return cls(message_modulus, scale, width)

    @property
    def _mask(self) -> int:
        return (1 << self.width) - 1

    def encode(self, message: int) -> int:
        """Torus encoding (unsigned Python int mod 2^width)."""
        m = message % self.message_modulus
        return torus_constant_w(m * self.scale, self.width) & self._mask

    def encode_with_scale(self, message: int, scale: float) -> int:
        """Encode with a per-call scale override (encoder.zig:83-93)."""
        m = message % self.message_modulus
        return torus_constant_w(m * scale, self.width) & self._mask

    def decode(self, torus_value: int) -> int:
        f = (int(torus_value) & self._mask) / float(1 << self.width)
        return int(f / self.scale + 0.5) % self.message_modulus

    def decode_bool(self, torus_value: int) -> bool:
        return self.decode(torus_value) != 0


@dataclasses.dataclass
class LookupTable:
    """A trivial TRLWE (a=0) whose body encodes the function
    (lookup_table.zig:16-77).  ``poly``: int32 [2, N] (int64 on the
    64-bit torus)."""

    poly: np.ndarray

    @classmethod
    def new(cls, N: int, width: int = 32) -> "LookupTable":
        return cls(np.zeros((2, N), np.int32 if width == 32 else np.int64))

    @classmethod
    def from_poly(cls, poly) -> "LookupTable":
        """Wrap an existing TRLWE [2, N] as a LUT (lookup_table.zig:33-36).

        Unlike ``new``, the testvec may be a real (non-trivial, a != 0)
        TRLWE — e.g. a previous bootstrap's output re-used as a table.
        The carrier width follows the input dtype (int64 in, int64 kept).
        """
        arr = np.asarray(poly)
        arr = np.array(arr, arr.dtype if arr.dtype == np.int64 else np.int32,
                       copy=True)
        if arr.ndim != 2 or arr.shape[0] != 2:
            raise ValueError(f"LUT poly must be [2, N], got {arr.shape}")
        return cls(arr)

    def get_poly(self) -> np.ndarray:
        """The underlying TRLWE polynomial (lookup_table.zig:38-48)."""
        return self.poly

    def is_empty(self) -> bool:
        return not np.any(self.poly)

    def clear(self) -> None:
        self.poly[:] = 0

    def copy_from(self, other: "LookupTable") -> None:
        self.poly[:] = other.poly

    def as_jax(self):
        return jnp.asarray(self.poly)


@dataclasses.dataclass
class Generator:
    """Builds LUT testvecs from functions (generator.zig:15-227).

    The codec width follows the parameter set (``params.torus_bits``):
    64-bit sets (the N=2048 split-ring door) get int64 tables, so a
    single-shot PBS covers message moduli the u32 reference cannot."""

    encoder: Encoder
    poly_degree: int
    lookup_table_size: int

    @classmethod
    def new(cls, message_modulus: int, params: SecurityParams) -> "Generator":
        return cls(Encoder.new(message_modulus, params.torus_bits),
                   params.N, params.N)

    @classmethod
    def with_scale(cls, message_modulus: int, scale: float,
                   params: SecurityParams) -> "Generator":
        return cls(Encoder.with_scale(message_modulus, scale,
                                      params.torus_bits),
                   params.N, params.N)

    def _build(self, encoded: Sequence[int]) -> LookupTable:
        """Shared tail of generateLookupTable*Assign (generator.zig:85-191):
        fill per-message ranges, rotate left by N/(2m), two's-complement
        negate the wrapped tail, store as trivial TRLWE body."""
        n = self.lookup_table_size
        m = self.encoder.message_modulus
        w = self.encoder.width
        udt = np.uint32 if w == 32 else np.uint64
        sdt = np.int32 if w == 32 else np.int64
        raw = np.zeros(n, udt)
        for x in range(m):
            start = div_round(x * n, m)
            end = div_round((x + 1) * n, m)
            raw[start:end] = udt(encoded[x])
        offset = div_round(n, 2 * m)
        rotated = np.roll(raw, -offset)  # rotated[i] = raw[(i+offset) % n]
        rotated[n - offset:] = (~rotated[n - offset:] + udt(1))
        lut = LookupTable.new(self.poly_degree, w)
        lut.poly[1, :] = rotated.astype(sdt)
        return lut

    def generate_lookup_table(self, f: Callable[[int], int]) -> LookupTable:
        """LUT of f: message -> message (generator.zig:63-135)."""
        m = self.encoder.message_modulus
        return self._build([self.encoder.encode(f(x)) for x in range(m)])

    def generate_lookup_table_full(self, f: Callable[[int], int]) -> LookupTable:
        """LUT of f: message -> raw Torus value (generator.zig:155-191)."""
        m = self.encoder.message_modulus
        mask = (1 << self.encoder.width) - 1
        return self._build([int(f(x)) & mask for x in range(m)])

    def generate_lookup_table_custom(self, f: Callable[[int], int],
                                     message_modulus: int, scale: float) -> LookupTable:
        """Custom modulus/scale variant (generator.zig:202-212)."""
        tmp = Generator(Encoder.with_scale(message_modulus, scale,
                                           self.encoder.width),
                        self.poly_degree, self.lookup_table_size)
        return tmp.generate_lookup_table(f)

    def mod_switch(self, x: int) -> int:
        """Torus -> [0, lookup_table_size) (generator.zig:223-227)."""
        w = self.encoder.width
        mask = (1 << w) - 1
        scaled = ((int(x) & mask) / float(mask)) * self.lookup_table_size
        return int(scaled + 0.5) % self.lookup_table_size

    @property
    def message_modulus(self) -> int:
        return self.encoder.message_modulus


def encrypt_message(key, message, message_modulus: int, alpha: float, sk,
                    width: int = 32):
    """Batched PBS-codec encrypt (tlwe.zig:74-88).  width=64 for the
    64-bit-torus sets (params.torus_bits)."""
    return _tlwe.encrypt_message(key, message, message_modulus, alpha, sk,
                                 width)


def decrypt_message(ct, message_modulus: int, sk, width: int = 32):
    return _tlwe.decrypt_message(ct, message_modulus, sk, width)


def bootstrap_lut(ct_batch, lut, ck: CloudKey):
    """Programmable bootstrap: apply a LUT to a batch of ciphertexts.

    ct_batch: int32 [B, n0+1] encrypted with the PBS message codec.
    lut: a LookupTable (shared), an int32 [2, N] array, or [B, 2, N]
         per-lane testvecs (heterogeneous function batch).
    Returns refreshed int32 [B, n0+1] encrypting f(message).

    This is the wired-up pipeline the reference documents but does not ship
    (lut.zig:42): blindRotateWithTestvec (trgsw.zig:336-400) ->
    sampleExtractIndex (trlwe.zig:146) -> identityKeySwitching
    (trgsw.zig:471).
    """
    tv = lut.as_jax() if isinstance(lut, LookupTable) else jnp.asarray(lut)
    return _bootstrap.bootstrap_with_testvec(ct_batch, tv, ck)


# ---------------------------------------------------------------------------
# Multi-value bootstrapping (CIM17 factoring): K LUTs, ONE blind rotation
# ---------------------------------------------------------------------------
#
# Any Generator-built testvec tv over a power-of-two message modulus m
# factors as  tv = T0 * q  in Z_2^32[X]/(X^N + 1), where
#   T0 = s * (1 + X + ... + X^(N-1)),  s = 2^32 / (4m),
#   q  = tv * (1 - X) / (2s)           (integer coefficients, SPARSE:
#                                       nonzero only at the ~m bin edges).
# Proof: T0 * (1 - X) = s * (1 - X^N) = 2s  mod X^N + 1.
#
# So K LUTs of the same encrypted input cost ONE blind rotation (with T0)
# plus, per LUT, a handful of static negacyclic rotations of the rotated
# accumulator (X^j multiplies, ops/poly.py:negacyclic_rotate) — instead of
# K full blind rotations.  No reference analog (the reference has no
# bootstrapLut at all); the technique is Carpov-Izabachene-Mollimard 2017.
#
# Noise: the factored evaluation multiplies the blind-rotation output's
# AMPLITUDE error — encryption noise AND gadget-truncation error alike —
# by ||q||_1 (<= ~m * max-jump; reported by factor_lut).  It therefore
# needs a parameter set whose gadget precision is deep relative to the
# 1/(4m) bin half-width: the uint family (bgbit >= 10, tiny lv1 alpha,
# drop 0) has ample margin (validated at uint4 real noise in
# tests/test_production_params.py and exactly at TEST_TINY_UINT), while
# the boolean sets' 12-18-bit effective gadget precision makes plain
# bootstrap_lut the safer choice at m >= 8.


def multi_lut_base(message_modulus: int, N: int, width: int = 32) -> np.ndarray:
    """The shared testvec T0 (trivial TRLWE [2, N]) for modulus m at the
    given torus width (int32 carrier at 32, int64 at 64)."""
    m = message_modulus
    if m & (m - 1) or not 1 <= m <= (1 << 30):
        raise ValueError(f"multi-value LUT needs power-of-two modulus, got {m}")
    s = (1 << width) // (4 * m)          # < 2^(width-2): fits the carrier
    dt = np.int32 if width == 32 else np.int64
    tv = np.zeros((2, N), dt)
    tv[1, :] = np.int64(s).astype(dt)
    return tv


def factor_lut(lut, message_modulus: int):
    """Factor a Generator-built LUT: returns (offsets, coeffs, norm1).

    offsets: int tuple (ascending); coeffs: int tuple (centered, |c| < m);
    the factored identity  tv == T0 * sum_j c_j X^(o_j)  is verified
    exactly here (host-side schoolbook, mod 2^32) before returning.
    Raises ValueError for tables that don't factor (non-trivial a-part,
    non-power-of-two modulus, or coefficients off the encode grid).
    """
    m = message_modulus
    tv = lut.get_poly() if isinstance(lut, LookupTable) else np.asarray(lut)
    if tv.ndim != 2 or tv.shape[0] != 2:
        raise ValueError(f"LUT poly must be [2, N], got {tv.shape}")
    if np.any(tv[0]):
        raise ValueError("multi-value factoring needs a trivial (a=0) LUT")
    if m & (m - 1) or not 1 <= m <= (1 << 30):
        raise ValueError(f"multi-value LUT needs power-of-two modulus, got {m}")
    width = 64 if np.asarray(tv).dtype == np.int64 else 32
    tv = np.ascontiguousarray(tv, np.int32 if width == 32 else np.int64)
    return _factor_lut_cached(tv[1].tobytes(), tv.shape[1], m, width)


@functools.lru_cache(maxsize=1024)
def _factor_lut_cached(b_bytes: bytes, N: int, m: int, width: int = 32):
    """factor_lut's host-side factorization + O(nnz*N) exactness check,
    cached on the table bytes so repeated traces (e.g. every radix_add /
    digit_mul specialization calling bootstrap_multi_lut) pay it once.

    Two coefficient constructions, both verified exactly:
      1. centered mod-2m quotients of the first difference — the smallest
         ||q||_1, but AMBIGUOUS when a true jump's magnitude reaches m
         (e.g. across the anti-periodic tail of a steep table);
      2. TRUE integer differences of the canonical grid lifts
         g = tv/delta in [0, 2m), wrap term c_0 = g_0 + g_{N-1}.  Always
         exact for on-grid tables: with S_k the prefix sums,
         (T0*q)_k = s*(2 S_k - C) and S_k - S_0 = g_k - g_0 telescopes
         exactly, while c_0 = g_0 + g_{N-1} satisfies the wrap relation
         c_0 = g_0 + g_{N-1} (mod 4m).  Larger ||q||_1 (<= ~2m per
         boundary), used only when (1)'s verification fails.
    """
    if width == 64:
        # same algebra mod 2^64 on uint64 wrap (numpy uint64 add/sub/mul
        # wrap exactly; quotients and coefficients stay small)
        b = np.frombuffer(b_bytes, np.int64).view(np.uint64)
        d = np.empty(N, np.uint64)
        # wrap-exact scalar add (numpy warns on uint64 SCALAR overflow
        # even though array ops wrap silently)
        d[0] = np.uint64((int(b[0]) + int(b[N - 1])) & ((1 << 64) - 1))
        d[1:] = b[1:] - b[:-1]
        delta = np.uint64((1 << 64) // (2 * m))
        if np.any(d % delta):
            raise ValueError(
                "LUT values are not on the 1/(2m) encode grid; only "
                "generate_lookup_table outputs (power-of-two m) factor")
        s = np.uint64(int(delta) // 2)
        ones = np.full(N, s, np.uint64)
    else:
        b = np.frombuffer(b_bytes, np.int32).astype(np.int64) & 0xFFFFFFFF
        # d = (1-X)*tv (negacyclic): d_0 = tv_0 + tv_{N-1}, d_j = tv_j - tv_{j-1}
        d = np.empty(N, np.int64)
        d[0] = b[0] + b[N - 1]
        d[1:] = b[1:] - b[:-1]
        d &= 0xFFFFFFFF
        delta = (1 << 32) // (2 * m)                 # = 2s
        if np.any(d % delta):
            raise ValueError(
                "LUT values are not on the 1/(2m) encode grid; only "
                "generate_lookup_table outputs (power-of-two m) factor")
        s = delta // 2
        ones = np.full(N, s, np.int64)

    def _verify(offsets, coeffs):
        # exact check: T0 * q == tv (schoolbook negacyclic, mod 2^width)
        if width == 64:
            recon = np.zeros(N, np.uint64)
            for j, cj in zip(offsets, coeffs):
                rot = (np.concatenate([np.uint64(0) - ones[N - j:],
                                       ones[:N - j]]) if j else ones)
                recon += np.uint64(cj % (1 << 64)) * rot
            return not np.any(recon - b)
        recon = np.zeros(N, np.int64)
        for j, cj in zip(offsets, coeffs):
            rot = np.concatenate([-ones[N - j:], ones[:N - j]]) if j else ones
            recon += cj * rot
        return not np.any((recon - b) & 0xFFFFFFFF)

    def _pack(c):
        nz = np.nonzero(c)[0]
        return (tuple(int(j) for j in nz), tuple(int(c[j]) for j in nz))

    c = (d // delta).astype(np.int64)                # quotients mod 2m
    c = np.where(c >= m, c - 2 * m, c)               # centered lift
    offsets, coeffs = _pack(c)
    if not _verify(offsets, coeffs):
        g = (b // delta).astype(np.int64)            # canonical lifts [0, 2m)
        c2 = np.empty(N, np.int64)
        c2[1:] = g[1:] - g[:-1]
        c2[0] = g[0] + g[N - 1]
        offsets, coeffs = _pack(c2)
        if not _verify(offsets, coeffs):
            raise ValueError(
                "internal: multi-value factorization check failed")
    return offsets, coeffs, int(np.abs(np.asarray(coeffs)).sum())


def apply_factored(acc, offsets, coeffs):
    """Multiply a rotated accumulator TRLWE batch [..., 2, N] by the
    factored q = sum_j c_j X^(o_j): static negacyclic rotations + int32
    wrapping adds (exact; fuses into a few XLA elementwise kernels)."""
    from zig_tfhe_jax.ops.poly import negacyclic_rotate

    out = None
    for j, c in zip(offsets, coeffs):
        term = negacyclic_rotate(acc, j) if j else acc
        term = term * jnp.asarray(c, acc.dtype)
        out = term if out is None else out + term
    if out is None:                                   # q == 0: the zero LUT
        out = jnp.zeros_like(acc)
    return out


# ---------------------------------------------------------------------------
# Radix (carry-decomposed) PBS: message moduli beyond the modswitch capacity
# ---------------------------------------------------------------------------
#
# Single-shot PBS at N = 1024 is modswitch-limited to ~m <= 32
# (docs/NOISE.md §8) — the uint7/uint8 parameter sets DEFINE m = 128/256
# but no single blind rotation can decode them reliably (the reference
# defines the same sets and never executes them at all,
# params.zig:386-416).  The production route, standard in mainstream TFHE
# libraries, is carry decomposition: encrypt x as two digits
# (x_lo = x mod 16 at modulus 16, x_hi = x // 16 at modulus m/16 — both
# deep inside the modswitch budget), and evaluate an arbitrary
# f: [0,m) -> [0,m) with a two-layer tree PBS:
#
#   1. mid layer — ONE multi-value blind rotation of ct_lo (CIM17,
#      docs/NOISE.md §9) evaluates, for every hypothesis h of the hi
#      digit, the two output-digit tables g_h_lo(x_lo) = f(16h + x_lo)
#      mod 16 and g_h_hi(x_lo) = f(16h + x_lo) // 16 via cheap factored
#      multiplications of the one rotated accumulator (kept at lv1 — no
#      key switch);
#   2. pack — each family's m_hi candidate TLWEs pack into one TRLWE
#      testvec, candidate h's value occupying the coefficient block
#      centered on h * (N/m_hi) (ops/packing_keyswitch.py);
#   3. select — ONE batched blind rotation over ct_hi (modulus m_hi <= 16)
#      rotates the packed testvec so the true h's block lands on
#      coefficient 0; sample-extract + key switch yield the output digits.
#
# Total: 2 batched blind-rotation calls (1 + F=2 lanes) per batch of
# evaluations, every PBS input at modulus <= 16.


def encrypt_radix_message(key, message, message_modulus: int, alpha: float,
                          sk, width: int = 32):
    """Encrypt messages of modulus m > 16 as (lo, hi) digit ciphertexts.

    lo = message mod 16 at modulus 16; hi = message // 16 at modulus m/16.
    message: int or int array [B].  Returns (ct_lo, ct_hi), each
    carrier [B, n0+1] (scalars get a singleton batch axis).  width=64
    for the 64-bit-torus sets (params.torus_bits).
    """
    m = message_modulus
    if m & (m - 1) or not 32 <= m <= 256:
        raise ValueError(
            f"radix encoding needs a power-of-two modulus in 32..256, "
            f"got {m} (the hi-digit tables must sit on the 1/32 factoring "
            f"grid and the packing blocks must divide N)")
    msg = jnp.atleast_1d(jnp.asarray(message, jnp.int32)) % m
    k_lo, k_hi = jax.random.split(key)
    ct_lo = _tlwe.encrypt_message(k_lo, msg % 16, 16, alpha, sk, width)
    ct_hi = _tlwe.encrypt_message(k_hi, msg // 16, m // 16, alpha, sk, width)
    return ct_lo, ct_hi


def decrypt_radix_message(cts, message_modulus: int, sk, width: int = 32):
    """Inverse of encrypt_radix_message: (ct_lo, ct_hi) -> int [B]."""
    m = message_modulus
    ct_lo, ct_hi = cts
    lo = _tlwe.decrypt_message(ct_lo, 16, sk, width)
    hi = _tlwe.decrypt_message(ct_hi, m // 16, sk, width)
    return (lo + 16 * hi) % m


@functools.lru_cache(maxsize=256)
def radix_lut_testvecs(f: Callable[[int], int], message_modulus: int,
                       params: SecurityParams) -> np.ndarray:
    """The mid layer's 2 * m_hi testvecs: int32 [2, m_hi, 2, N].

    [0, h] is g_h_lo (f's low output digit, modulus-16 encoding);
    [1, h] is g_h_hi (high digit, modulus-m_hi encoding).

    Cached per (f, m, params): rebuilding 2*m_hi Generator tables is a
    host-side O(m_hi * N) Python loop paid at every trace otherwise
    (VERDICT r3 #4) — pass a STABLE function object (module-level def or
    a cached lambda) to hit the cache; a fresh lambda per call misses by
    identity, which is correct-but-slower."""
    m = message_modulus
    m_hi = m // 16
    gen = Generator.new(16, params)
    tvs = np.zeros((2, m_hi, 2, params.N),
                   np.int32 if params.torus_bits == 32 else np.int64)
    for h in range(m_hi):
        lo = gen.generate_lookup_table(
            lambda xl, h=h: f(16 * h + xl) % 16)
        hi = gen.generate_lookup_table_custom(
            lambda xl, h=h: (f(16 * h + xl) % m) // 16, 16, 1.0 / (2 * m_hi))
        tvs[0, h] = lo.poly
        tvs[1, h] = hi.poly
    tvs.setflags(write=False)           # cached: callers must not mutate
    return tvs


def bootstrap_lut_radix(ct_lo, ct_hi, f: Callable[[int], int],
                        message_modulus: int, ck: CloudKey, pksk,
                        pksk_basebit: int | None = None,
                        pksk_t: int | None = None):
    """Evaluate f: [0, m) -> [0, m) on radix-encoded inputs
    (m a power of two in 32..256).

    ct_lo/ct_hi: int32 [B, n0+1] from encrypt_radix_message.
    pksk: packing key from ops/packing_keyswitch.py:gen_packing_ksk
          (generated once per secret key).  pksk_basebit/pksk_t must
          match the key's build contract when it used custom values
          (serialization.load_packing_ksk returns them); None = the
          parameter set's defaults, matching gen_packing_ksk's.
    Returns (out_lo, out_hi) — the same radix encoding, so evaluations
    chain.  Every constituent PBS runs at message modulus <= 16, so
    accuracy is uint4-grade (vs the ~38%/29% single-shot uint7/uint8
    envelope, docs/NOISE.md §8).
    """
    from zig_tfhe_jax import trlwe as _trlwe
    from zig_tfhe_jax.ops.blind_rotate import blind_rotate
    from zig_tfhe_jax.ops.keyswitch import identity_key_switch
    from zig_tfhe_jax.ops.packing_keyswitch import pack_tlwes_blocks

    m = message_modulus
    m_hi = m // 16
    if m & (m - 1) or not 2 <= m_hi <= 16:
        raise ValueError(
            f"radix LUT supports power-of-two m = 32..256, got {m}")
    tvs = radix_lut_testvecs(f, m, ck.params)                 # [2, mh, 2, N]
    out = tree_pbs(ct_lo, ct_hi, tvs, m_hi, ck, pksk,
                   pksk_basebit=pksk_basebit, pksk_t=pksk_t)  # [B, 2, n0+1]
    return out[:, 0], out[:, 1]


def _use_interleave() -> bool:
    """Family-interleaved select packing (default on where the margin
    holds; ZTFHE_NO_INTERLEAVE=1 forces one select lane per family).
    Trace-time semantics like ZTFHE_FOLD."""
    import os
    return os.environ.get("ZTFHE_NO_INTERLEAVE", "") not in ("1", "true")


def _rotation_knee(params: SecurityParams) -> int:
    """Per-engine blind-rotation throughput knee, in lanes: 2048 for the
    32-bit path, 512 for the split engine (hand-set; not yet measured on
    the GPU)."""
    return 512 if params.split_ring else 2048


def _chunked_blind_rotate(ct, tv, ck: CloudKey):
    """blind_rotate with the flat batch split into knee-sized dispatches.

    The tree-PBS mid layer's dedicated lanes multiply out to D*B
    rotations (32 tables x B at m=256) — one giant dispatch would run
    deep past the engine knee.  The
    tail pads to the chunk so every dispatch shares one compile
    signature (pad lanes rotate lane 0, sliced away).
    """
    from zig_tfhe_jax.ops.blind_rotate import blind_rotate

    params = ck.params
    total = ct.shape[0]
    chunk = _rotation_knee(params)
    if total <= chunk:
        return blind_rotate(ct, tv, ck, params)
    pad = (-total) % chunk
    if pad:
        ct = jnp.concatenate([ct, jnp.broadcast_to(ct[:1], (pad,) + ct.shape[1:])])
        tv = jnp.concatenate([tv, jnp.broadcast_to(tv[:1], (pad,) + tv.shape[1:])])
    parts = [blind_rotate(ct[i:i + chunk], tv[i:i + chunk], ck, params)
             for i in range(0, total + pad, chunk)]
    return jnp.concatenate(parts)[:total]


def mid_norm1_budget(ck: CloudKey) -> float:
    """Max ||q||_1 a factored (CIM17) mid-layer table may carry in
    tree_pbs before its lane falls back to a dedicated blind rotation.

    The factored route multiplies the mid rotation's AMPLITUDE error by
    ||q||_1, and that product lands on the packed VALUE the select
    rotation decodes against the modulus-16 half-bin (2^-6 of the
    torus).  Two truncation terms make up that amplitude (docs/NOISE.md
    §6 pins both; the t64 bisect reproduced the a-term live: a steep
    ||q||_1 = 86 table flips bins on the alpha=0 tiny split set exactly
    as the model predicts):

        sigma_b = 2^-(e*lb+1) * sqrt(steps)            (bare b-remainder)
        sigma_a = 2^-(e*la+1) * sqrt(N/6) * sqrt(steps) (a-remainder,
                  key-convolved: the ~sqrt(N/2) binary-key amplification)

    CALIBRATION (128bit_t64, m=256 radix; the arithmetic is exact, so
    the accuracy does not depend on the device):
    real noise failed 3/64 evals through factored hi-tables of norm1
    14..20 — an amplified per-unit-||q||_1 sigma of ~2^-11.3 vs the
    formulas' 2^-12.7.  The 2.6x gap is the multi-bit subset structure:
    the group-2 combiner applies (X^t1 - 1)(X^t2 - 1) to the m=3
    subset's remainder (x4 amplitude on that term) where the formula
    prices a bare (X^t - 1).  MID_SIGMA_CAL = 4 covers the measured
    factor with margin (all-dedicated re-measure: accuracy 1.0).

    Budget: after reserving the pipeline's fixed noise (the lv1->lv0
    key switch, sigma_KS = sqrt(n1 * t * B^2/12) * ksk_alpha — the
    dominant fixed term at every secure set) out of a 4.5-sigma target,

        budget = sqrt((2^-6 / 4.5)^2 - sigma_KS^2)
                 / (MID_SIGMA_CAL * sqrt(sigma_a^2 + sigma_b^2)).

    32-bit sets return inf: their measured-exact radix envelope runs on
    the uint family's deep parameter gadgets (e*lb >= 22, sigma_b ~
    2^-17) where every table factors with orders-of-magnitude margin —
    the budget machinery exists for the 64-bit sets' coarser bg8/(3,2)
    engine gadget (sigma_b ~ 2^-12.7 at SECURITY_128_BIT_T64: identity/
    carry tables with ||q||_1 <= ~21 still ride the single shared
    rotation; steep multiply tables get exact dedicated lanes).
    ZTFHE_MID=factored|dedicated overrides (trace-time semantics).
    """
    import math
    import os

    mode = os.environ.get("ZTFHE_MID", "")
    if mode == "factored":
        return math.inf
    if mode == "dedicated":
        return -1.0
    params = ck.params
    if params.torus_bits == 32:
        return math.inf
    e = ck.bsk_bgbit if ck.bsk_bgbit is not None else params.bgbit
    levels = ck.bsk_levels
    la = levels[0] if levels is not None else params.L
    lb = levels[1] if levels is not None else params.L
    steps = -(-params.n0 // max(ck.bsk_group, 1))
    MID_SIGMA_CAL = 4.0           # measured 2.6x + margin; see docstring
    sigma_b = 2.0 ** -(e * lb + 1) * math.sqrt(steps)
    sigma_a = (2.0 ** -(e * la + 1) * math.sqrt(params.N / 6.0)
               * math.sqrt(steps))
    sigma_b = MID_SIGMA_CAL * math.hypot(sigma_a, sigma_b)
    base = 1 << params.basebit
    sigma_ks = math.sqrt(params.n1 * params.iks_t * base * base / 12.0) \
        * params.ksk_alpha
    target = (1.0 / 64.0) / 4.5
    avail_sq = target * target - sigma_ks * sigma_ks
    if avail_sq <= 0:
        return -1.0
    return math.sqrt(avail_sq) / sigma_b


def tree_pbs(ct_in, ct_sel, tvs, n_blocks: int, ck: CloudKey, pksk,
             pksk_basebit: int | None = None, pksk_t: int | None = None):
    """Generic two-layer tree PBS: F output families, H hypotheses.

    tvs: int32 [F, H, 2, N] — Generator-built (modulus-16 grid) testvecs;
    table [fam, h] is the family's LUT of ct_in under hypothesis h of the
    selector.  ct_in: int32 [B, n0+1] modulus-16 codec; ct_sel: int32
    [B, n0+1] at modulus n_blocks (power of two; H <= n_blocks — unused
    blocks are packed as zero samples).  Returns int32 [B, F, n0+1].

    Mid layer: all F*H tables are LUTs of the SAME input on the 1/32
    encode grid, so CIM17 multi-value factoring applies — ONE blind
    rotation of ct_in against the all-ones base, then a cheap factored
    multiplication per table (docs/NOISE.md §9; steep tables factor via
    the true-difference fallback).  Pack layer: each family's candidates
    land on the selector's coefficient blocks via the packing key switch.

    Select layer, two shapes (VERDICT r3 #4):
      * INTERLEAVED (default when F == 2 and 2*n_blocks*64 <= N): both
        families pack into ONE testvec — family fam's hypothesis h on the
        block centered at (2h + fam) * N/(2*n_blocks) — so ONE rotation
        lane serves both families; family 0 extracts at coefficient 0,
        family 1 at N/(2*n_blocks).  The route is 1 + 1 rotation lanes
        instead of 1 + 2.  Margin: the block half-width halves to
        N/(4*n_blocks) >= 32 under the guard — the SAME select margin as
        the measured-exact m_hi=16 route (uint8 radix, accuracy 1.000 at
        real noise), so uint5/6/7 inherit a validated envelope.  The r3
        ledger refuted interleaving only at m_hi = 16 (width 32), which
        the guard excludes.
      * PER-FAMILY (fallback): one select lane per family (F*B lanes).
    """
    from zig_tfhe_jax import trlwe as _trlwe
    from zig_tfhe_jax.ops.blind_rotate import blind_rotate
    from zig_tfhe_jax.ops.keyswitch import identity_key_switch
    from zig_tfhe_jax.ops.packing_keyswitch import pack_tlwes_blocks

    params = ck.params
    N = params.N
    tvs = np.asarray(tvs)
    F, H = tvs.shape[0], tvs.shape[1]
    if n_blocks & (n_blocks - 1) or not 2 <= n_blocks <= 16:
        raise ValueError(f"selector modulus must be a power of two in "
                         f"2..16, got {n_blocks}")
    if H > n_blocks:
        raise ValueError(f"{H} hypotheses exceed {n_blocks} selector blocks")
    B = ct_in.shape[0]
    interleave = (F == 2 and 2 * n_blocks * 64 <= N and _use_interleave())

    factored = [factor_lut(tvs[fam, h], 16)
                for fam in range(F) for h in range(H)]
    # Mid-layer routing (the 64-bit door): CIM17 amplifies the rotation's
    # amplitude error by ||q||_1, so tables beyond the budget take an
    # exact dedicated rotation lane instead (mid_norm1_budget; on 32-bit
    # sets the budget is inf and this is the shipped factored-only path).
    budget = mid_norm1_budget(ck)
    use_fact = [norm1 <= budget for _, _, norm1 in factored]
    acc = None
    if any(use_fact):
        base = jnp.asarray(multi_lut_base(16, N, params.torus_bits))
        acc = blind_rotate(ct_in, base, ck, params)           # [B, 2, N]
    ded_idx = [i for i, u in enumerate(use_fact) if not u]
    ded_out = None
    if ded_idx:
        D = len(ded_idx)
        tvs_flat = tvs.reshape(F * H, 2, N)
        tv_ded = jnp.asarray(np.stack([tvs_flat[i] for i in ded_idx]))
        tv_rep = jnp.broadcast_to(tv_ded[:, None], (D, B, 2, N))
        ct_rep = jnp.broadcast_to(ct_in[None], (D,) + ct_in.shape)
        ded_out = _chunked_blind_rotate(
            ct_rep.reshape(D * B, -1), tv_rep.reshape(D * B, 2, N),
            ck).reshape(D, B, 2, N)
    pos = {i: k for k, i in enumerate(ded_idx)}
    lanes = [apply_factored(acc, factored[i][0], factored[i][1])
             if use_fact[i] else ded_out[pos[i]]
             for i in range(F * H)]
    outs = jnp.stack(lanes, axis=1)                           # [B, F*H, 2, N]
    lv1 = _trlwe.sample_extract(outs.reshape(B * F * H, 2, N), 0)
    lv1 = lv1.reshape(B, F, H, N + 1)
    if H < n_blocks:                                          # pad blocks
        pad = jnp.zeros((B, F, n_blocks - H, N + 1), lv1.dtype)
        lv1 = jnp.concatenate([lv1, pad], axis=2)

    if interleave:
        # [B, 2*n_blocks, N+1]: slot 2h + fam holds family fam, hypothesis h
        mixed = jnp.swapaxes(lv1, 1, 2).reshape(B, 2 * n_blocks, N + 1)
        packed = pack_tlwes_blocks(mixed, 2 * n_blocks, pksk, params,
                                   basebit=pksk_basebit, t=pksk_t)  # [B,2,N]
        tr2 = blind_rotate(ct_sel, packed, ck, params)        # ONE lane/pair
        delta2 = N // (2 * n_blocks)
        out0 = _trlwe.sample_extract(tr2, 0)
        out1 = _trlwe.sample_extract(tr2, delta2)
        out = identity_key_switch(jnp.stack([out0, out1], axis=1),
                                  ck.ksk1, params)            # [B, 2, n0+1]
        return out

    packed = pack_tlwes_blocks(lv1, n_blocks, pksk, params,
                               basebit=pksk_basebit, t=pksk_t)  # [B,F,2,N]

    sel_rep = jnp.repeat(ct_sel, F, axis=0)                   # [B*F, n0+1]
    tr2 = blind_rotate(sel_rep, packed.reshape(B * F, 2, N), ck, params)
    out = identity_key_switch(_trlwe.sample_extract(tr2, 0), ck.ksk1, params)
    return out.reshape(B, F, -1)


def bootstrap_lut_bivariate(ct_x, ct_y, f2: Callable[[int, int], int],
                            ck: CloudKey, pksk,
                            y_modulus: int = 16,
                            out_modulus: int = 16):
    """Bivariate PBS: out = f2(x, y) for two modulus-16-encoded inputs.

    A direct corollary of the radix tree-PBS: x is the tree's input and
    y its selector, with one hypothesis table per y value.  No reference
    analog (tfhe-rs calls this a bivariate PBS); cost = 2 blind-rotation
    lanes (one multi-value mid rotation + one single-family select).

    ct_x: int32 [B, n0+1], modulus-16 codec; ct_y: same at y_modulus
    (power of two, 2..16).  Returns int32 [B, n0+1] encrypting
    f2(x, y) mod out_modulus at the modulus-16 codec (out_modulus <= 16).
    """
    if out_modulus > 16:
        raise ValueError(f"bivariate output modulus <= 16, got {out_modulus}")
    params = ck.params
    gen = Generator.new(16, params)
    tvs = np.zeros((1, y_modulus, 2, params.N),
                   np.int32 if params.torus_bits == 32 else np.int64)
    for h in range(y_modulus):
        tvs[0, h] = gen.generate_lookup_table(
            lambda x, h=h: f2(x, h) % out_modulus).poly
    return tree_pbs(ct_x, ct_y, tvs, y_modulus, ck, pksk)[:, 0]


def bootstrap_multi_lut(ct_batch, luts, message_modulus: int, ck: CloudKey):
    """K LUTs of the same inputs for ONE blind rotation.

    ct_batch: int32 [B, n0+1] (PBS message codec, modulus m).
    luts: sequence of K LookupTable / [2, N] arrays (Generator-built,
          power-of-two m).
    Returns int32 [K, B, n0+1]: row k encrypts f_k(message).

    Decrypt-equivalent to K bootstrap_lut calls (exactly so at alpha=0
    sets; see the noise note above for real-noise sets) at ~1/K the
    blind-rotation cost.

    ||q||_1 ROUTING (same budget as the tree-PBS mid layer,
    mid_norm1_budget): tables whose factored norm exceeds the cloud
    key's amplification budget take a dedicated rotation lane instead
    of the shared factored one — on the 64-bit sets' bg8/(3,2) gadget
    the amplified truncation otherwise flips bins (measured live:
    the t64 integer layer's first real-noise run scored 0.33 through
    factored mod/div tables).  32-bit sets (budget inf) keep the
    shipped single-rotation behavior.
    """
    from zig_tfhe_jax import trlwe as _trlwe
    from zig_tfhe_jax.ops.blind_rotate import blind_rotate
    from zig_tfhe_jax.ops.keyswitch import identity_key_switch

    params = ck.params
    factored = [factor_lut(t, message_modulus) for t in luts]
    budget = mid_norm1_budget(ck)
    use_fact = [norm1 <= budget for _, _, norm1 in factored]
    K = len(luts)
    B = ct_batch.shape[0]
    N = params.N
    acc = None
    if any(use_fact):
        base = jnp.asarray(multi_lut_base(message_modulus, N,
                                          params.torus_bits))
        acc = blind_rotate(ct_batch, base, ck, params)      # [B, 2, N]
    ded_idx = [i for i, u in enumerate(use_fact) if not u]
    ded_out = None
    if ded_idx:
        D = len(ded_idx)
        tv = jnp.stack([(luts[i].as_jax() if isinstance(luts[i], LookupTable)
                         else jnp.asarray(luts[i])) for i in ded_idx])
        tv_rep = jnp.broadcast_to(tv[:, None], (D, B, 2, N))
        ct_rep = jnp.broadcast_to(ct_batch[None], (D,) + ct_batch.shape)
        ded_out = _chunked_blind_rotate(
            ct_rep.reshape(D * B, -1), tv_rep.reshape(D * B, 2, N),
            ck).reshape(D, B, 2, N)
    pos = {i: k for k, i in enumerate(ded_idx)}
    outs = jnp.stack([apply_factored(acc, factored[i][0], factored[i][1])
                      if use_fact[i] else ded_out[pos[i]]
                      for i in range(K)])
    lv1 = _trlwe.sample_extract(outs.reshape(K * B, 2, N), 0)
    out = identity_key_switch(lv1, ck.ksk1, params)
    return out.reshape(K, B, -1)
