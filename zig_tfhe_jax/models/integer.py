"""Encrypted radix integer arithmetic on programmable bootstraps.

Multi-digit homomorphic add/sub/mul, comparisons (eq/lt and friends),
mux/min/max, bitwise and/or/xor, and shifts, built purely from the LUT
machinery
(models/lut.py) — a capability layer the reference does not have (its
multi-bit parameter sets exist but nothing ever composes them;
SURVEY.md §2 #10 notes even bootstrapLut is missing there).

Representation: little-endian base-B digits, each digit a PBS message
with modulus M = 2*B.  The factor-2 headroom makes every intermediate
fit the message space exactly:

  * add:   digit + digit + carry <= M - 1     (one PBS splits mod/div B)
  * mul:   a digit product x*y (x,y < B) is computed EXACTLY via the
           packing trick  w = x + B*bit_k(y) <= M - 1 : a single
           univariate LUT of w recovers (w mod B) * (w div B) * 2^k =
           x*y_k*2^k, pre-split into its low/high base-B parts;
           log2(B) bit-planes + carry normalizations assemble the
           2-digit product.

The radix is centralized in ``radix_spec``: B=8 / M=16 at every width
(base-16 digits on the 64-bit set were refuted on composed-op noise
grounds — see radix_spec's docstring); all machinery below is
parametric in the spec, so a future higher-margin set flips one line.

All heterogeneous LUT lanes of a round run as ONE batched bootstrap
(per-lane testvecs, models/lut.py:bootstrap_lut), so the sequential
depth is small: an add is 1 PBS round per digit; a digit mul is 5 PBS
rounds.  Rounds that apply several LUTs to the SAME input (mod/div of a
sum, the three bit-planes, each partial product's lo/hi split) use
multi-value bootstrapping (models/lut.py:bootstrap_multi_lut): one blind
rotation serves all the round's LUTs, halving the dominant cost of both
add (2 LUT lanes -> 1 rotation per digit) and mul (14 lanes -> 7
rotations); ZTFHE_NO_MULTIVALUE=1 restores plain per-lane bootstraps.
Every step is exact (no message-capacity rounding), verified
digit-for-digit in tests/test_integer.py.

Works on any parameter set whose PBS is reliable at m=16 (uint4,
TEST_TINY_UINT; see docs/NOISE.md §8 for the capacity analysis).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import tlwe as _tlwe
from zig_tfhe_jax.key import CloudKey
from zig_tfhe_jax.models import lut as L
from zig_tfhe_jax.params import SecurityParams
from zig_tfhe_jax.utils import torus as _torus

BASE = 8          # radix of the encrypted integers (32-bit sets)
M = 16            # PBS message modulus per digit (headroom factor 2)


def radix_spec(width: int) -> tuple[int, int, int]:
    """(base_bits, base, message_modulus) for a torus width.

    Base 8 / M=16 at BOTH widths.  Base-16 digits on the 64-bit set
    (25% fewer digits) were considered and REFUTED on noise grounds:
    the measured m<=32-exact envelope (docs/TORUS64.md §9) is a
    SINGLE-op statement, but the radix machinery composes — a digit add
    sums 3 PBS outputs (~3.0 sigma of the m=32 half-bin at the t64
    set's sigma_KS 2^-9.4 / modswitch 2^-9.2 floor, ~1e-3/digit) and
    the eq AND-reduce sums up to 15 (~1.3 sigma — double-digit failure
    rates).  The 32-bit machine's deepest op runs at 3.1 sigma on
    uint-grade keys; matching that at m=32 needs ~2 bits more KS margin
    than the modswitch floor allows.  The machinery below is fully
    parametric in this spec, so a future parameter set with the margin
    (e.g. N=4096) flips one line.
    """
    del width
    return (3, 8, 16)


def _spec_params(params: SecurityParams) -> tuple[int, int, int]:
    return radix_spec(params.torus_bits)


def _spec_like(x) -> tuple[int, int, int]:
    """Spec from a ciphertext's carrier dtype."""
    return radix_spec(64 if x.dtype == jnp.int64 else 32)


# ---------------------------------------------------------------------------
# LUT bank (static per parameter set)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _luts(params: SecurityParams):
    """The LUT bank, parametric in the set's radix spec.

    Names keep their historical base-8 spellings ("eq8", "x8", "div8",
    "sign7", "bit{k}"...) at every base — the digits 8/7 in a name mean
    "the base" / "base - 1", not a literal.
    """
    bb, base, m = _spec_params(params)
    sbit = bb - 1                 # sign-bit index within a digit
    gen = L.Generator.new(m, params)
    bank = {
        "mod": gen.generate_lookup_table(lambda t: t % base),
        "div": gen.generate_lookup_table(lambda t: t // base),
        # div at the base-x packing scale (select bit for division's mux,
        # rides the same rotation as mod/div)
        "div8": gen.generate_lookup_table(lambda t: base * (t // base)),
    }
    for k in range(bb):  # base = 2^bb bit-planes
        # outputs base*bit directly so the packing add w = x + bits never
        # scales a ciphertext (scalar-multiplying a PBS output by base
        # would amplify its noise base-x and break real-noise sets)
        bank[f"bit{k}"] = gen.generate_lookup_table(
            lambda y, k=k: base * ((y >> k) & 1))
        # unit-scale bits (for shift-in during division)
        bank[f"ubit{k}"] = gen.generate_lookup_table(
            lambda y, k=k: ((y % base) >> k) & 1)
        # w = x + base*b packs (x, b); the LUT returns x*b*2^k split base-B
        bank[f"pp{k}lo"] = gen.generate_lookup_table(
            lambda w, k=k: ((w % base) * (w // base) << k) % base)
        bank[f"pp{k}hi"] = gen.generate_lookup_table(
            lambda w, k=k: ((w % base) * (w // base) << k) // base)
        # bitwise ops on the packing w = x + base*bit_k(y): combine x's
        # k-th bit with the (already extracted) k-th bit of y, repositioned
        bank[f"and{k}"] = gen.generate_lookup_table(
            lambda w, k=k: (((w % base) >> k) & 1 & (w // base)) << k)
        bank[f"or{k}"] = gen.generate_lookup_table(
            lambda w, k=k: ((((w % base) >> k) & 1) | (w // base)) << k)
        bank[f"xor{k}"] = gen.generate_lookup_table(
            lambda w, k=k: ((((w % base) >> k) & 1) ^ (w // base)) << k)
    # gates <-> integer bridge: the k-th digit bit emitted at the BOOLEAN
    # gate codec (+-1/8) so outputs feed models/gates directly
    for k in range(bb):
        bank[f"boolbit{k}"] = gen.generate_lookup_table_full(
            lambda t, k=k: _torus.torus_constant_w(
                0.125 if ((t % base) >> k) & 1 else -0.125,
                params.torus_bits))
    # comparisons / selection
    bank["eq8"] = gen.generate_lookup_table(lambda t: 1 if t == base else 0)
    bank["iszero"] = gen.generate_lookup_table(lambda t: 1 if t == 0 else 0)
    bank["x8"] = gen.generate_lookup_table(lambda t: base * (t & 1))
    # signed (two's complement) support: sign-bit bias flip for ordered
    # compares, sign digit/boundary fill for arithmetic right shift
    bank["flipsign"] = gen.generate_lookup_table(
        lambda t: (t % base) ^ (base // 2))
    bank["sign7"] = gen.generate_lookup_table(
        lambda t: (base - 1) * ((t % base) >> sbit))
    bank["sign1"] = gen.generate_lookup_table(lambda t: (t % base) >> sbit)
    # signed-overflow rule on packed v = sa + 2*sb + 4*sr: operands agree
    # in sign and the result sign differs
    bank["sovf"] = gen.generate_lookup_table(
        lambda v: 1 if ((v & 1) == ((v >> 1) & 1)
                        and ((v >> 2) & 1) != (v & 1)) else 0)
    # plain-constant fast paths: digit x known digit c products (the
    # encrypted path would waste a rotation extracting KNOWN bits), and
    # low-bit masks for divmod by powers of two
    for c in range(2, base):
        bank[f"mulc{c}lo"] = gen.generate_lookup_table(
            lambda t, c=c: ((t % base) * c) % base)
        bank[f"mulc{c}hi"] = gen.generate_lookup_table(
            lambda t, c=c: ((t % base) * c) // base)
    # sub-digit shifts (r in [1, bb); digit-aligned shifts need no LUT)
    for r in range(1, bb):
        bank[f"signfill{r}"] = gen.generate_lookup_table(
            lambda t, r=r: (base - (1 << (bb - r))) * ((t % base) >> sbit))
        bank[f"masklow{r}"] = gen.generate_lookup_table(
            lambda t, r=r: (t % base) & ((1 << r) - 1))
        bank[f"shl{r}lo"] = gen.generate_lookup_table(
            lambda t, r=r: ((t % base) << r) % base)
        bank[f"shl{r}hi"] = gen.generate_lookup_table(
            lambda t, r=r: ((t % base) << r) // base)
        bank[f"shr{r}"] = gen.generate_lookup_table(
            lambda t, r=r: (t % base) >> r)
        bank[f"low{r}"] = gen.generate_lookup_table(
            lambda t, r=r: ((t % base) & ((1 << r) - 1)) << (bb - r))
    return bank


def _bucket(B: int) -> int:
    """Smallest power of two >= B (min 8).

    Every distinct flattened batch size compiles its own copy of the
    whole blind-rotate scan; the integer ops generate MANY distinct
    sizes (lane counts x digit widths x batch dims).  Bucketing pads to
    a power of two so they collapse onto a handful of compiled
    executables — the same discipline a serving deployment needs to
    avoid per-request recompiles.  The padded lanes bootstrap a zero
    ciphertext and are sliced away; the overhead is bounded by 2x at
    tiny sizes and vanishes at production batches.
    """
    b = 8
    while b < B:
        b *= 2
    return b


def _pad_to_bucket(x, B: int | None = None):
    """Zero-pad x's leading axis to its power-of-two bucket (pass B to
    pad to an explicit target instead).  Inverse is a [:orig] slice."""
    B0 = x.shape[0]
    Bp = _bucket(B0) if B is None else B
    if Bp == B0:
        return x
    return jnp.concatenate(
        [x, jnp.zeros((Bp - B0,) + x.shape[1:], x.dtype)])


def _bootstrap_lut_bucketed(flat, tv, ck: CloudKey):
    """bootstrap_lut with the flattened batch padded to a bucket size.

    Above the engine's rotation knee (models/lut.py:_rotation_knee —
    512 lanes on the split engine) the padded batch dispatches in
    knee-sized chunks instead of one giant rotation past the knee, and
    the pow2 bucket is always a multiple of the knee so every chunk
    shares one compile signature."""
    B = flat.shape[0]
    Bp = _bucket(B)
    if Bp != B:
        flat = _pad_to_bucket(flat)
        if tv.ndim == 3:            # per-lane testvecs ride the batch axis
            tv = jnp.concatenate(
                [tv, jnp.broadcast_to(tv[:1], (Bp - B,) + tv.shape[1:])])
    knee = L._rotation_knee(ck.params)
    if Bp > knee:
        outs = [L.bootstrap_lut(flat[i:i + knee],
                                tv[i:i + knee] if tv.ndim == 3 else tv, ck)
                for i in range(0, Bp, knee)]
        return jnp.concatenate(outs)[:B]
    return L.bootstrap_lut(flat, tv, ck)[:B]


def _pbs(cts, table_names, ck: CloudKey):
    """One batched heterogeneous bootstrap: lane i of ``cts`` [B, n0+1]
    gets the LUT named table_names[i] (a single shared name is allowed)."""
    bank = _luts(ck.params)
    if isinstance(table_names, str):
        tv = bank[table_names].as_jax()
    else:
        tv = jnp.stack([bank[n].as_jax() for n in table_names])
    return _bootstrap_lut_bucketed(cts, tv, ck)


def _pbs_rows(rows, table_names, ck: CloudKey):
    """Batched multi-lane bootstrap: rows [L, ..., n0+1], one LUT per lane
    broadcast over the batch dims.  Returns [L, ..., n0+1].

    This is the batch-first workhorse: ALL lanes of ALL batch elements run
    as one bootstrap (the per-gate cost amortizes to the batched rate
    instead of one scan per value)."""
    bank = _luts(ck.params)
    Lanes = rows.shape[0]
    batch = rows.shape[1:-1]
    n1 = rows.shape[-1]
    B = int(np.prod(batch)) if batch else 1
    flat = rows.reshape(Lanes * B, n1)
    tv = jnp.stack([bank[n].as_jax() for n in table_names])    # [L, 2, N]
    tv = jnp.repeat(tv, B, axis=0)                             # [L*B, 2, N]
    out = _bootstrap_lut_bucketed(flat, tv, ck)
    return out.reshape((Lanes,) + batch + (n1,))


def _use_mv() -> bool:
    """Multi-value bootstrapping for the shared-input LUT rounds (default
    on; ZTFHE_NO_MULTIVALUE=1 forces one blind rotation per lane)."""
    import os
    return os.environ.get("ZTFHE_NO_MULTIVALUE", "") not in ("1", "true")


@functools.lru_cache(maxsize=None)
def _factored(params: SecurityParams, name: str):
    return L.factor_lut(_luts(params)[name], _spec_params(params)[2])


def _pbs_mv(ct, table_names, ck: CloudKey):
    """K LUTs of the SAME input for one blind rotation (multi-value
    bootstrap, models/lut.py:bootstrap_multi_lut): ct [..., n0+1] ->
    [K, ..., n0+1].  Falls back to one-rotation-per-lane when disabled."""
    if not _use_mv():
        rows = jnp.broadcast_to(ct[None], (len(table_names),) + ct.shape)
        return _pbs_rows(rows, table_names, ck)
    batch = ct.shape[:-1]
    B = int(np.prod(batch)) if batch else 1
    flat = _pad_to_bucket(ct.reshape(B, ct.shape[-1]))
    bank = _luts(ck.params)
    out = L.bootstrap_multi_lut(flat, [bank[n] for n in table_names],
                                _spec_params(ck.params)[2], ck)
    out = out[:, :B]
    return out.reshape((len(table_names),) + batch + (ct.shape[-1],))


def _pbs_mv_groups(rows, name_groups, ck: CloudKey):
    """Grouped multi-value bootstrap: rows [G, ..., n0+1]; group g's input
    feeds the K LUTs named in name_groups[g].  ONE blind rotation over the
    flattened G*B batch (shared T0 testvec), then per-group factored
    applies.  Returns [G, K, ..., n0+1] (K equal across groups)."""
    from zig_tfhe_jax import trlwe as _trlwe
    from zig_tfhe_jax.ops.blind_rotate import blind_rotate
    from zig_tfhe_jax.ops.keyswitch import identity_key_switch

    G = rows.shape[0]
    K = len(name_groups[0])
    assert all(len(g) == K for g in name_groups), name_groups
    # ||q||_1 budget (models/lut.py:mid_norm1_budget — the 64-bit sets'
    # gadget cannot absorb the CIM17 amplification of steep tables; the
    # t64 integer layer's first real-noise run measured 0.33 through
    # them): any over-budget table demotes the whole call to dedicated
    # per-lane rotations
    budget = L.mid_norm1_budget(ck)
    mv_ok = all(_factored(ck.params, n)[2] <= budget
                for g in name_groups for n in g)
    if not _use_mv() or not mv_ok:
        flat_names = [n for g in name_groups for n in g]
        rep = jnp.repeat(rows, K, axis=0)          # [G*K, ..., n0+1]
        out = _pbs_rows(rep, flat_names, ck)
        return out.reshape((G, K) + rows.shape[1:])
    params = ck.params
    batch = rows.shape[1:-1]
    B0 = int(np.prod(batch)) if batch else 1
    B = _bucket(B0)                       # collapse compile variants
    grid = rows.reshape(G, B0, rows.shape[-1])
    if B != B0:
        grid = jnp.moveaxis(
            _pad_to_bucket(jnp.moveaxis(grid, 1, 0), B), 0, 1)
    flat = grid.reshape(G * B, rows.shape[-1])
    base = jnp.asarray(L.multi_lut_base(_spec_params(params)[2], params.N,
                                        params.torus_bits))
    acc = blind_rotate(flat, base, ck, params).reshape(G, B, 2, params.N)
    outs = jnp.stack([
        jnp.stack([L.apply_factored(acc[g], *_factored(params, n)[:2])
                   for n in name_groups[g]])
        for g in range(G)
    ])                                             # [G, K, B, 2, N]
    lv1 = _trlwe.sample_extract(outs.reshape(G * K * B, 2, params.N), 0)
    out = identity_key_switch(lv1, ck.ksk1, params)
    out = out.reshape(G, K, B, -1)[:, :, :B0]      # drop bucket padding
    return out.reshape((G, K) + batch + (rows.shape[-1],))


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------


def encrypt_radix(key, value, n_digits: int, alpha: float, sk,
                  width: int = 32):
    """Encrypt value(s) as n_digits little-endian radix digits
    (base 8 / M=16 at every width — see radix_spec, which carries the
    refutation of wider base-16 digits on the 64-bit sets).

    value: python int or int array [...].  Returns int32 [..., n_digits,
    n0+1] (batch-first: a batch of integers is just a leading axis);
    width=64 encrypts int64 carriers for the 64-bit-torus sets.
    Digit extraction runs in host int64 so values beyond 2^31 encode
    correctly (int32 shifts would silently truncate them).
    """
    bb, base, m = radix_spec(width)
    v = np.asarray(value, np.int64)
    shifts = bb * np.arange(n_digits, dtype=np.int64)
    digits = jnp.asarray(((v[..., None] >> shifts) & (base - 1))
                         .astype(np.int32))
    return _tlwe.encrypt_message(key, digits, m, alpha, sk, width)


def decrypt_radix(ct_digits, sk):
    """[..., D, n0+1] -> int or int64 array [...] (width follows dtype)."""
    w = 64 if ct_digits.dtype == jnp.int64 else 32
    bb, base, m = radix_spec(w)
    msgs = np.asarray(_tlwe.decrypt_message(ct_digits, m, sk, w)) % base
    D = msgs.shape[-1]
    weights = (1 << (bb * np.arange(D, dtype=np.int64)))
    out = (msgs.astype(np.int64) * weights).sum(axis=-1)
    return int(out) if out.ndim == 0 else out


def _zeros_like_digit(d):
    return jnp.zeros_like(d)


def _trivial_digit(value: int, like):
    """Noiseless (a = 0) ciphertext of ``value`` at the PBS codec scale
    1/(2M), shaped like the digit ciphertext ``like`` [..., n0+1].  Used
    for the additive constants of sub/compare (exact, adds no noise)."""
    w = 64 if like.dtype == jnp.int64 else 32
    m = radix_spec(w)[2]
    assert 0 <= value < m, value
    z = jnp.zeros_like(like)
    return z.at[..., -1].set(
        jnp.asarray(((1 << w) // (2 * m)) * value, like.dtype))


def _trivial_radix(value: int, D: int, like_digits):
    """Noiseless D-digit radix encoding of a non-negative Python int,
    batch-shaped like ``like_digits`` [..., Dl, n0+1].  Digits are
    extracted with Python ints so arbitrary-width constants work (int32
    shifts would fail beyond 2^31)."""
    dt = like_digits.dtype
    w = 64 if dt == jnp.int64 else 32
    bb, base, m = radix_spec(w)
    digits = jnp.asarray([(value >> (bb * i)) & (base - 1)
                          for i in range(D)], dt)
    ct = jnp.zeros(like_digits.shape[:-2] + (D, like_digits.shape[-1]), dt)
    enc = jnp.asarray((1 << w) // (2 * m), dt) * digits  # PBS codec: x/(2M)
    return ct.at[..., :, -1].set(jnp.broadcast_to(enc, ct.shape[:-1]))


# ---------------------------------------------------------------------------
# Addition
# ---------------------------------------------------------------------------


def radix_add(a_digits, b_digits, ck: CloudKey):
    """Exact homomorphic addition: [..., D, n0+1] x2 -> [..., D+1, n0+1].

    Sequential carry chain over digits; each digit position is one
    batched 2-lane bootstrap over the whole batch (sum = t mod 8,
    carry = t div 8 with t = a + b + carry <= 15).
    """
    D = a_digits.shape[-2]
    carry = _zeros_like_digit(a_digits[..., 0, :])
    out = []
    for i in range(D):
        t = a_digits[..., i, :] + b_digits[..., i, :] + carry
        both = _pbs_mv(t, ("mod", "div"), ck)    # 1 rotation, 2 LUTs
        out.append(both[0])
        carry = both[1]
    out.append(carry)
    return jnp.stack(out, axis=-2)


# ---------------------------------------------------------------------------
# Subtraction / comparison / selection
# ---------------------------------------------------------------------------


def radix_sub(a_digits, b_digits, ck: CloudKey, emit_ge8: bool = False):
    """Exact homomorphic subtraction with borrow chain.

    [..., D, n0+1] x2 (equal widths; pad first) -> (diff [..., D, n0+1],
    borrow [..., n0+1]) with a - b = diff - borrow * 8^D, i.e. diff is the
    wrapping difference and borrow is the encrypted (a < b) bit.

    Per digit: t = a_i - b_i - borrow + B in [0, 2B-1]; diff_i = t mod B
    and t div B = 1 iff no borrow, so the next borrow is the LINEAR flip
    1 - div (a trivial constant minus a fresh PBS output — no extra
    rotation, no noise amplification).  Same cost as radix_add: one
    2-LUT multi-value rotation per digit position over the whole batch.

    emit_ge8=True adds a div8 LUT to the LAST digit's rotation and
    returns (diff, borrow, ge8) where ge8 = B*(a >= b) — the pre-scaled
    select bit radix_select(sel8=...) consumes without its own x8
    rotation (division's inner loop).
    """
    D = a_digits.shape[-2]
    assert b_digits.shape[-2] == D, (a_digits.shape, b_digits.shape)
    base = _spec_like(a_digits)[1]
    eight = _trivial_digit(base, a_digits[..., 0, :])
    one = _trivial_digit(1, a_digits[..., 0, :])
    borrow = _zeros_like_digit(a_digits[..., 0, :])
    out = []
    ge8 = None
    for i in range(D):
        t = a_digits[..., i, :] - b_digits[..., i, :] - borrow + eight
        names = ("mod", "div", "div8") if (emit_ge8 and i == D - 1) \
            else ("mod", "div")
        res = _pbs_mv(t, names, ck)              # 1 rotation, 2-3 LUTs
        out.append(res[0])
        borrow = one - res[1]
        if len(res) == 3:
            ge8 = res[2]
    diff = jnp.stack(out, axis=-2)
    return (diff, borrow, ge8) if emit_ge8 else (diff, borrow)


def radix_lt(a_digits, b_digits, ck: CloudKey):
    """Encrypted (a < b) bit [..., n0+1] (message 0/1): the final borrow
    of the subtraction chain."""
    return radix_sub(a_digits, b_digits, ck)[1]


def _and_reduce_bits(bits, ck: CloudKey):
    """AND of K encrypted 0/1 bits [K, ..., n0+1] -> [..., n0+1].

    Chunks of <= M-1 bits sum into one PBS message (the message-capacity
    bound; the sum of k fresh PBS outputs carries ~sqrt(k) PBS noise,
    well inside the uint4-class budget), then iszero(k - sum) ANDs each
    chunk in ONE batched rotation per tree level.
    """
    cap = _spec_like(bits)[2] - 1
    while bits.shape[0] > 1:
        K = bits.shape[0]
        rows = []
        for i in range(0, K, cap):
            c = bits[i:i + cap]
            # dtype= keeps the carrier width: under jax_enable_x64 an
            # int32 sum otherwise promotes to int64 (numpy
            # accumulator rule) and poisons the pipeline dtype
            rows.append(_trivial_digit(c.shape[0], c[0])
                        - c.sum(axis=0, dtype=c.dtype))
        bits = _pbs_rows(jnp.stack(rows), ("iszero",) * len(rows), ck)
    return bits[0]


def radix_eq(a_digits, b_digits, ck: CloudKey):
    """Encrypted (a == b) bit [..., n0+1] (message 0/1).

    Depth log_(M-1)(D) + 1 rotations, all digit lanes batched: per-digit
    equality bits eq8(a_i - b_i + B) in one rotation, then an AND tree.
    """
    D = a_digits.shape[-2]
    eight = _trivial_digit(_spec_like(a_digits)[1], a_digits[..., 0, :])
    t = a_digits - b_digits + eight[..., None, :]
    bits = _pbs_rows(jnp.moveaxis(t, -2, 0), ("eq8",) * D, ck)
    return _and_reduce_bits(bits, ck)


def radix_select(sel, a_digits, b_digits, ck: CloudKey, *, sel8=None):
    """Encrypted mux: sel (0/1 message ct [..., n0+1]) ? a : b.

    One rotation refreshes sel into its 8x form (x8 LUT), then every
    digit of both operands packs w = d + 8*s / w = d + 8*(1-s) and a
    single batched pp0lo rotation over 2D lanes returns d*s / d*(1-s);
    the sum is exact (one addend is 0) — 2 rotations total, any D.
    Callers holding a pre-scaled bit (radix_sub(emit_ge8=True)) pass it
    as sel8 and skip the x8 rotation; sel is ignored then.
    """
    D = a_digits.shape[-2]
    assert b_digits.shape[-2] == D
    s8 = _pbs_mv(sel, ("x8",), ck)[0] if sel8 is None else sel8
    not8 = _trivial_digit(_spec_like(s8)[1], s8) - s8
    wa = jnp.moveaxis(a_digits, -2, 0) + s8
    wb = jnp.moveaxis(b_digits, -2, 0) + not8
    parts = _pbs_rows(jnp.concatenate([wa, wb]), ("pp0lo",) * (2 * D), ck)
    return jnp.moveaxis(parts[:D] + parts[D:], 0, -2)


def radix_lt_signed(a_digits, b_digits, ck: CloudKey):
    """Encrypted signed (a < b) on two's-complement radix arrays of equal
    width: flip both sign bits (one 2-lane flipsign rotation biases the
    order so that INT_MIN maps to 0) and compare unsigned."""
    tops = jnp.stack([a_digits[..., -1, :], b_digits[..., -1, :]])
    flipped = _pbs_rows(tops, ("flipsign", "flipsign"), ck)
    return radix_lt(a_digits.at[..., -1, :].set(flipped[0]),
                    b_digits.at[..., -1, :].set(flipped[1]), ck)


def radix_asr(a_digits, s: int, ck: CloudKey):
    """Arithmetic (sign-filling) right shift by a PLAIN amount s >= 0 on a
    two's-complement radix array; keeps the width D.  One rotation
    derives the sign digit (sign7) and the boundary fill from the top
    digit, the rest is radix_shr + linear adds on disjoint bits."""
    assert s >= 0
    if s == 0:
        return a_digits
    D = a_digits.shape[-2]
    q, r = divmod(s, _spec_like(a_digits)[0])
    top = a_digits[..., -1, :]
    if q >= D:
        sign7 = _pbs_mv(top, ("sign7",), ck)[0]
        return jnp.broadcast_to(sign7[..., None, :],
                                a_digits.shape[:-2] + (D, top.shape[-1]))
    names = ("sign7", f"signfill{r}") if r else ("sign7",)
    fills = _pbs_mv(top, names, ck)
    sh = radix_shr(a_digits, s, ck)                  # [..., D - q, n1]
    if r:
        sh = sh.at[..., -1, :].add(fills[1])
    if q:
        ext = jnp.broadcast_to(fills[0][..., None, :],
                               sh.shape[:-2] + (q, sh.shape[-1]))
        sh = jnp.concatenate([sh, ext], axis=-2)
    return sh


def radix_min(a_digits, b_digits, ck: CloudKey):
    """Encrypted elementwise min (D+1 rotations: borrow chain + select)."""
    return radix_select(radix_lt(a_digits, b_digits, ck),
                        a_digits, b_digits, ck)


def radix_max(a_digits, b_digits, ck: CloudKey):
    return radix_select(radix_lt(a_digits, b_digits, ck),
                        b_digits, a_digits, ck)


# ---------------------------------------------------------------------------
# Bitwise ops / shifts
# ---------------------------------------------------------------------------


def radix_bitwise(a_digits, b_digits, op: str, ck: CloudKey):
    """Bitwise and/or/xor of two radix integers (equal widths).

    2 rotations total, all digits batched: extract b's bb bit-planes
    (multi-value, base-x-scaled for packing), then one batched rotation
    over bb*D packed lanes w_k = a_i + B*bit_k(b_i) evaluates the
    per-bit {op}{k} LUTs; the bit-plane outputs occupy disjoint bits so
    their sum is the exact digit with no carry normalization.
    """
    assert op in ("and", "or", "xor"), op
    bb = _spec_like(a_digits)[0]
    D = a_digits.shape[-2]
    assert b_digits.shape[-2] == D
    b_rows = jnp.moveaxis(b_digits, -2, 0)                   # [D, ..., n1]
    bits8 = _pbs_mv(b_rows, tuple(f"bit{k}" for k in range(bb)),
                    ck)                                      # [bb, D, ...]
    w = jnp.moveaxis(a_digits, -2, 0)[None] + bits8
    names = tuple(f"{op}{k}" for k in range(bb) for _ in range(D))
    parts = _pbs_rows(w.reshape((bb * D,) + w.shape[2:]), names, ck)
    out = parts.reshape((bb, D) + parts.shape[1:]).sum(
        axis=0, dtype=parts.dtype)
    return jnp.moveaxis(out, 0, -2)


def radix_shl(a_digits, s: int, ck: CloudKey):
    """Left shift by a PLAIN amount s >= 0; widens to hold every bit
    ([..., D + ceil(s/bb), n0+1]).  Digit-aligned part is free (zero-digit
    prepend); the sub-digit remainder r costs ONE batched rotation (2
    LUTs per digit: shl{r}lo/hi), recombined linearly (disjoint bits)."""
    assert s >= 0
    q, r = divmod(s, _spec_like(a_digits)[0])
    D = a_digits.shape[-2]
    zero = _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
    if r:
        rows = jnp.moveaxis(a_digits, -2, 0)
        names = tuple(f"shl{r}lo" for _ in range(D)) + \
            tuple(f"shl{r}hi" for _ in range(D))
        parts = _pbs_rows(jnp.concatenate([rows, rows]), names, ck)
        lo = jnp.moveaxis(parts[:D], 0, -2)                  # [..., D, n1]
        hi = jnp.moveaxis(parts[D:], 0, -2)
        a_digits = jnp.concatenate([lo, zero], axis=-2) + \
            jnp.concatenate([zero, hi], axis=-2)             # [..., D+1, n1]
    return jnp.concatenate([zero] * q + [a_digits], axis=-2) if q \
        else a_digits


def radix_shr(a_digits, s: int, ck: CloudKey):
    """Logical right shift by a PLAIN amount s >= 0 ([..., max(D-q, 1),
    n0+1]).  Digit-aligned part drops digits; the remainder r is one
    batched rotation (shr{r} of d_i + low{r} of d_{i+1}, disjoint bits)."""
    assert s >= 0
    q, r = divmod(s, _spec_like(a_digits)[0])
    D = a_digits.shape[-2]
    if q >= D:
        return _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
    a_digits = a_digits[..., q:, :]
    if r:
        D = a_digits.shape[-2]
        rows = jnp.moveaxis(a_digits, -2, 0)
        names = tuple(f"shr{r}" for _ in range(D)) + \
            tuple(f"low{r}" for _ in range(D))
        parts = _pbs_rows(jnp.concatenate([rows, rows]), names, ck)
        down = jnp.moveaxis(parts[:D], 0, -2)
        up = jnp.moveaxis(parts[D:], 0, -2)      # bits of d_{i+1} moving down
        zero = _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
        a_digits = down + jnp.concatenate([up[..., 1:, :], zero], axis=-2)
    return a_digits


# ---------------------------------------------------------------------------
# Multiplication
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _digit_mul_tvs(params: SecurityParams) -> np.ndarray:
    """Tree-PBS tables for the bivariate digit multiplier: [2, B, 2, N];
    [fam, h] is (x*h) mod B (fam 0) / (x*h) div B (fam 1) over the
    modulus-M input grid (digits live in [0, B))."""
    bb, base, m = _spec_params(params)
    gen = L.Generator.new(m, params)
    dt = np.int32 if params.torus_bits == 32 else np.int64
    tvs = np.zeros((2, base, 2, params.N), dt)
    for h in range(base):
        tvs[0, h] = gen.generate_lookup_table(
            lambda x, h=h: ((x % base) * h) % base).poly
        tvs[1, h] = gen.generate_lookup_table(
            lambda x, h=h: ((x % base) * h) // base).poly
    return tvs


def digit_mul(x_ct, y_ct, ck: CloudKey):
    """Exact product of two encrypted digits (< 8): returns (lo, hi).

    With a packing key on the cloud key (CloudKey.generate(
    packing_key=True)) this is a BIVARIATE tree PBS (models/lut.py:
    tree_pbs): one multi-value rotation of x against the 16 hypothesis
    tables + one select rotation over y — 3 rotation-lane scans and
    2 sequential rounds, vs the 5-round / 7-rotation bit-decomposition
    pipeline below.  Noise: both output digits are fresh select-rotation
    outputs (testvec noise = mid-layer PBS noise x sqrt(delta) from the
    packing spread, docs/NOISE.md §9 budget); validated exact at alpha=0
    and at real uint4 noise.

    Classic path (no packing key): 5 sequential PBS rounds (7 blind
    rotations total with multi-value bootstrapping; 14 without), every
    message <= 15:
      1. bits of y (3 LUTs, 1 rotation);
      2. partial products via the w = x + 8*b packing (6 LUTs over the
         3 distinct w_k — lo_k = (x*y_k*2^k) mod 8, hi_k = ... div 8 —
         3 rotations);
      3. low-part carry normalization of lo_0 + lo_1 (2 LUTs, 1 rotation);
      4. final low digit + carry from + lo_2 (2 LUTs, 1 rotation);
      5. high-digit refresh (1 lane, plain).

    Bound check for step 5: hi_0 <= 0, hi_1 <= 1, hi_2 <= 3 and the two
    carries are <= 1 each, so the linear hi sum is <= 6 < 8 — a single
    mod-8 refresh is exact.
    """
    if getattr(ck, "pksk", None) is not None:
        # the cloud key's embedded packing key uses the per-width default
        # gadget contract (CloudKey.generate builds it that way and
        # stamps ck.pksk_gadget; ops/packing_keyswitch.py:
        # default_packing_gadget).  Validate BOTH the declared contract
        # and the row count: a custom-gadget key with the same t but a
        # different basebit has the RIGHT row count yet ks_decompose at
        # the default basebit would silently decode garbage (ADVICE r3
        # #1).
        from zig_tfhe_jax.ops.packing_keyswitch import default_packing_gadget

        p = ck.params
        want = default_packing_gadget(p)
        declared = getattr(ck, "pksk_gadget", None)
        if declared is not None and tuple(declared) != want:
            raise ValueError(
                f"cloud key's packing key was built at (basebit, t) = "
                f"{tuple(declared)} but the parameter set's default "
                f"packing gadget is {want}: custom-gadget "
                "packing keys must be used via models/lut.py:tree_pbs "
                "with explicit pksk_basebit/pksk_t, not attached to the "
                "cloud key")
        if ck.pksk.shape[0] != p.n1 * want[1]:
            raise ValueError(
                f"cloud key's packing key has {ck.pksk.shape[0]} rows, "
                f"expected n1*t = {p.n1 * want[1]}: custom-gadget "
                "packing keys must be used via models/lut.py:tree_pbs "
                "with explicit pksk_basebit/pksk_t, not attached to the "
                "cloud key")
        batch = x_ct.shape[:-1]
        B = int(np.prod(batch)) if batch else 1
        n1 = x_ct.shape[-1]
        out = L.tree_pbs(x_ct.reshape(B, n1), y_ct.reshape(B, n1),
                         _digit_mul_tvs(ck.params),
                         _spec_params(ck.params)[2], ck, ck.pksk)
        lo = out[:, 0].reshape(batch + (n1,))
        hi = out[:, 1].reshape(batch + (n1,))
        return lo, hi
    bb = _spec_params(ck.params)[0]
    x, y = x_ct, y_ct                                   # [..., n0+1]
    bits8 = _pbs_mv(y, tuple(f"bit{k}" for k in range(bb)),
                    ck)                                 # 1 rotation, bb LUTs
    w = x[None] + bits8                                 # w_k = x + B*y_k
    parts = _pbs_mv_groups(                             # bb rotations
        w, tuple((f"pp{k}lo", f"pp{k}hi") for k in range(bb)),
        ck)                                             # [bb, 2, ..., n0+1]
    hi_parts = parts[0, 1]
    for k in range(1, bb):
        # sum_k floor((B-1) 2^k / B) = B - 1 - bb (e.g. 4 at B=8, 11 at
        # B=16); + the bb-1 mod/div carries (<= 1 each) stays < B
        hi_parts = hi_parts + parts[k, 1]
    t = parts[0, 0]
    for k in range(1, bb):
        # lo_k <= B - 1 each: the pairwise sum <= 2B - 2 = M - 2 fits
        s = _pbs_mv(t + parts[k, 0], ("mod", "div"), ck)
        t = s[0]
        hi_parts = hi_parts + s[1]
    lo = t
    hi = _pbs_rows(hi_parts[None], ("mod",), ck)[0]
    return lo, hi


def radix_scale(a_digits, y_ct, ck: CloudKey):
    """[..., D, n0+1] x digit [..., n0+1] -> [..., D+1, n0+1].

    All D digit products run as ONE batched mul (the digit axis folds
    into digit_mul's batch dims)."""
    D = a_digits.shape[-2]
    a_rows = jnp.moveaxis(a_digits, -2, 0)               # [D, ..., n0+1]
    y_rows = jnp.broadcast_to(y_ct[None], a_rows.shape)
    lo, hi = digit_mul(a_rows, y_rows, ck)               # [D, ..., n0+1]
    z = _zeros_like_digit(lo[0])[None]
    row_lo = jnp.moveaxis(jnp.concatenate([lo, z]), 0, -2)
    row_hi = jnp.moveaxis(jnp.concatenate([z, hi]), 0, -2)
    return radix_add(row_lo, row_hi, ck)[..., : D + 1, :]


def radix_scale_plain(a_digits, c: int, ck: CloudKey):
    """[..., D, n0+1] times a PLAIN digit c in [0, B) -> [..., D+1, n0+1].

    One batched mulc{c}lo/hi rotation over 2D lanes, then one addition
    (lo_i + hi_{i-1} <= (B-1) + (B-2) = M - 3 fits the message space, so
    the carry chain normalizes exactly).  1 + (D+1) rotations vs the
    encrypted digit_mul path's ~7 per digit."""
    D = a_digits.shape[-2]
    zero = _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
    if c == 0:
        return jnp.concatenate([zero] * (D + 1), axis=-2)
    if c == 1:
        return jnp.concatenate([a_digits, zero], axis=-2)
    rows = jnp.moveaxis(a_digits, -2, 0)
    names = tuple(f"mulc{c}lo" for _ in range(D)) + \
        tuple(f"mulc{c}hi" for _ in range(D))
    parts = _pbs_rows(jnp.concatenate([rows, rows]), names, ck)
    lo = jnp.moveaxis(parts[:D], 0, -2)
    hi = jnp.moveaxis(parts[D:], 0, -2)
    row_lo = jnp.concatenate([lo, zero], axis=-2)
    row_hi = jnp.concatenate([zero, hi], axis=-2)
    return radix_add(row_lo, row_hi, ck)[..., : D + 1, :]


def radix_mul_plain(a_digits, v: int, ck: CloudKey):
    """[..., D, n0+1] times a PLAIN non-negative int -> widened exact
    product: schoolbook over v's radix digits with zero digits skipped,
    powers of two routed through the (cheaper) shift path."""
    assert v >= 0
    bb, base, _ = _spec_like(a_digits)
    D = a_digits.shape[-2]
    if v == 0:
        return _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
    if v & (v - 1) == 0:                       # power of two -> shl
        return radix_shl(a_digits, v.bit_length() - 1, ck)
    Dv = max(1, -(-v.bit_length() // bb))
    W = D + Dv
    zero = _zeros_like_digit(a_digits[..., 0, :])[..., None, :]

    def at_width(x):
        pad = W - x.shape[-2]
        return jnp.concatenate([x] + [zero] * pad, axis=-2) if pad else x

    acc = None
    for j in range(Dv):
        c = (v >> (bb * j)) & (base - 1)
        if c == 0:
            continue
        row = radix_scale_plain(a_digits, c, ck)           # [..., D+1]
        padded = at_width(jnp.concatenate([zero] * j + [row], axis=-2))
        acc = padded if acc is None else \
            radix_add(acc, padded, ck)[..., :W, :]
    return acc


def radix_mask_low(a_digits, nbits: int, ck: CloudKey):
    """Keep the low ``nbits`` of a radix value (x & (2^nbits - 1)):
    digit-aligned drops are free; the boundary digit costs one masklow
    rotation.  Width shrinks to ceil(nbits/bb) (min 1)."""
    assert nbits >= 0
    if nbits == 0:
        return _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
    q, r = divmod(nbits, _spec_like(a_digits)[0])
    if r == 0:
        return a_digits[..., :q, :]
    kept = a_digits[..., : q + 1, :]
    top = _pbs_rows(kept[..., -1, :][None], (f"masklow{r}",), ck)[0]
    return kept.at[..., -1, :].set(top)


def radix_mul(a_digits, b_digits, ck: CloudKey):
    """Full product: [..., Da, n0+1] x [..., Db, n0+1] -> [..., Da+Db, n0+1]
    (exact schoolbook over batched rows)."""
    Da, Db = a_digits.shape[-2], b_digits.shape[-2]
    zero = _zeros_like_digit(a_digits[..., 0, :])[..., None, :]
    acc = jnp.concatenate([zero] * (Da + Db), axis=-2)
    for j in range(Db):
        row = radix_scale(a_digits, b_digits[..., j, :], ck)  # [..., Da+1]
        padded = jnp.concatenate(
            [zero] * j + [row] + [zero] * (Db - 1 - j), axis=-2)
        acc = radix_add(acc, padded, ck)[..., : Da + Db, :]
    return acc


def to_bools(digits, ck: CloudKey):
    """Radix digits -> boolean-codec bits: [..., D, n0+1] ->
    [..., bb*D, n0+1] TLWE ciphertexts at the gate codec (+-1/8),
    little-endian — directly composable with models/gates (and
    models/circuits adders / the Bristol scheduler).

    One batched rotation: bb boolbit lanes per digit, each a full-output
    LUT emitting +-1/8 raw torus values.
    """
    bb = _spec_like(digits)[0]
    D = digits.shape[-2]
    rows = jnp.repeat(jnp.moveaxis(digits, -2, 0), bb, axis=0)  # [bb*D, ..]
    names = tuple(f"boolbit{k}" for _ in range(D) for k in range(bb))
    return jnp.moveaxis(_pbs_rows(rows, names, ck), 0, -2)


def from_bools(bits, ck: CloudKey):
    """Boolean-codec bits -> radix digits: [..., nb, n0+1] (+-1/8 codec,
    little-endian, e.g. gate/adder outputs) -> [..., ceil(nb/bb), n0+1]
    PBS-codec digits.

    One batched rotation over all bits: lane bb*j+k bootstraps with a
    CONSTANT testvec 2^k/(4M), so the sign of the bit selects
    -+2^k/(4M); adding the trivial offset 2^k/(4M) yields bit*2^k at the
    digit codec, and each digit is the exact sum of its <= bb disjoint
    bit contributions.
    """
    bb, _, m = _spec_params(ck.params)
    nb = bits.shape[-2]
    D = -(-nb // bb)
    rows = jnp.moveaxis(bits, -2, 0)                       # [nb, ..., n1]
    batch = rows.shape[1:-1]
    B = int(np.prod(batch)) if batch else 1
    flat = rows.reshape(nb * B, rows.shape[-1])
    N = ck.params.N
    w = ck.params.torus_bits
    dt = np.int32 if w == 32 else np.int64
    offs = np.array([((1 << w) // (4 * m)) << (i % bb) for i in range(nb)],
                    dt)
    tv = np.zeros((nb, 2, N), dt)
    tv[:, 1, :] = offs[:, None]
    tv = jnp.repeat(jnp.asarray(tv), B, axis=0)            # lane i*B+b
    out = _bootstrap_lut_bucketed(flat, tv, ck)
    out = out.reshape((nb,) + batch + (rows.shape[-1],))
    out = out.at[..., -1].add(
        jnp.asarray(offs).reshape((nb,) + (1,) * len(batch)))
    ds = [sum(out[bb * j + k] for k in range(bb) if bb * j + k < nb)
          for j in range(D)]
    return jnp.moveaxis(jnp.stack(ds), 0, -2)


def _barrel_shift(a_digits, y_digits, ck: CloudKey, shift_fn):
    """Barrel shifter core: fixed width D (data-dependent widths are
    impossible under an encrypted amount); amounts >= bb*D shift
    everything into the fill (zeros, or sign digits for shift_fn =
    radix_asr which keeps width and sign-fills by construction).

    One multi-value rotation extracts all bits of y in their base-x
    packing form, then each bit k muxes x against shift_fn(x, 2^k) — the
    select consumes the pre-scaled bit directly (sel8), so a level costs
    the plain shift's rotations + one pack rotation.
    """
    bb = _spec_like(a_digits)[0]
    D = a_digits.shape[-2]
    Dy = y_digits.shape[-2]
    bits8 = _pbs_mv(jnp.moveaxis(y_digits, -2, 0),
                    tuple(f"bit{k}" for k in range(bb)),
                    ck)                                # [bb, Dy, ..., n1]
    x = a_digits
    for k in range(bb * Dy):
        s8 = bits8[k % bb, k // bb]
        shifted = shift_fn(x, min(1 << k, bb * D), ck)
        x = radix_select(None, shifted, x, ck, sel8=s8)
    return x


def _shl_fixed(x, s, ck):
    D = x.shape[-2]
    return radix_shl(x, s, ck)[..., :D, :]


def _shr_fixed(x, s, ck):
    D = x.shape[-2]
    sh = radix_shr(x, s, ck)
    pad = D - sh.shape[-2]
    if pad:
        zero = _zeros_like_digit(x[..., 0, :])[..., None, :]
        sh = jnp.concatenate([sh] + [zero] * pad, axis=-2)
    return sh


def radix_shl_enc(a_digits, y_digits, ck: CloudKey):
    """Left shift by an ENCRYPTED amount y (wraps mod 8^D)."""
    return _barrel_shift(a_digits, y_digits, ck, _shl_fixed)


def radix_shr_enc(a_digits, y_digits, ck: CloudKey):
    """Logical right shift by an ENCRYPTED amount."""
    return _barrel_shift(a_digits, y_digits, ck, _shr_fixed)


def radix_asr_enc(a_digits, y_digits, ck: CloudKey):
    """ARITHMETIC (sign-filling) right shift by an ENCRYPTED amount
    (two's-complement digits; y is an unsigned radix amount)."""
    return _barrel_shift(a_digits, y_digits, ck, radix_asr)


# ---------------------------------------------------------------------------
# Division
# ---------------------------------------------------------------------------


def radix_divmod(n_digits, m_digits, ck: CloudKey):
    """Exact unsigned division: (quotient [..., Dn, n0+1], remainder
    [..., Dm, n0+1]) by restoring shift-subtract over encrypted bits.

    Per quotient bit (bb*Dn total): shift the running remainder left one
    bit (1 rotation), shift in the next numerator bit (linear; all
    numerator bits are extracted up front in ONE multi-value rotation),
    trial-subtract the divisor (Dm+1 rotations), and keep either result
    by encrypted mux (2 rotations) — the no-borrow bit IS the quotient
    bit.  Quotient digits reassemble as sum_k 2^k b_k (<= B-1, exact)
    with one final batched mod refresh.  ~bb*Dn*(Dm+3) rotations total
    (the mux's x8 refresh rides the trial-subtract's last multi-value
    rotation), every rotation batched over all lanes/batch dims.

    Division by an encrypted zero yields an all-ones quotient (tfhe-rs
    convention — no borrow ever fires) and an unspecified remainder.
    """
    bb = _spec_like(n_digits)[0]
    Dn, Dm = n_digits.shape[-2], m_digits.shape[-2]
    Dr = Dm + 1            # remainder width: R < 2*divisor <= B^(Dm+1)
    zero = _zeros_like_digit(n_digits[..., 0, :])
    m_ext = jnp.concatenate(
        [m_digits, jnp.broadcast_to(zero[..., None, :],
                                    m_digits.shape[:-2] + (1, zero.shape[-1]))],
        axis=-2)
    rows = jnp.moveaxis(n_digits, -2, 0)
    ubits = _pbs_mv(rows, tuple(f"ubit{k}" for k in range(bb)),
                    ck)                                     # [bb, Dn, ...]
    one = _trivial_digit(1, zero)
    R = jnp.broadcast_to(zero[..., None, :],
                         zero.shape[:-1] + (Dr, zero.shape[-1]))
    q_bits = [None] * (bb * Dn)
    for i in range(bb * Dn - 1, -1, -1):
        R = radix_shl(R, 1, ck)[..., :Dr, :]      # top stays 0
        R = R.at[..., 0, :].add(ubits[i % bb, i // bb])
        diff, borrow, ge8 = radix_sub(R, m_ext, ck, emit_ge8=True)
        ge = one - borrow                          # R >= divisor, flip
        R = radix_select(None, diff, R, ck, sel8=ge8)  # x8 rode the sub
        q_bits[i] = ge
    qd = [sum((1 << k) * q_bits[bb * j + k] for k in range(bb))
          for j in range(Dn)]
    q = _pbs_rows(jnp.stack(qd), ("mod",) * Dn, ck)
    return jnp.moveaxis(q, 0, -2), R[..., :Dm, :]


# ---------------------------------------------------------------------------
# High-level encrypted-integer handle
# ---------------------------------------------------------------------------


class _FheOpsMixin:
    """Operator wiring shared by FheUint/FheInt.

    Subclasses provide ``_aligned(other) -> (a_digits, b_digits) | None``
    (None = foreign type, rich comparisons return NotImplemented so
    Python falls back to identity) and ``_lt_digits`` (the unsigned or
    sign-biased borrow chain).  Comparisons return an encrypted 0/1 bit
    as a 1-digit handle; defining __eq__ makes the handles unhashable
    (value semantics) and __bool__ raises — an encrypted comparison has
    no Python truth value (``if a == b:`` would otherwise silently take
    the branch every time).
    """

    __slots__ = ()
    __hash__ = None

    def _aligned(self, other):
        raise NotImplementedError

    _lt_digits = None        # staticmethod set by subclasses

    def _aligned_req(self, other):
        pair = self._aligned(other)
        if pair is None:
            raise TypeError(f"cannot combine {type(self).__name__} with "
                            f"{type(other).__name__}")
        return pair

    def __bool__(self):
        raise TypeError(
            f"{type(self).__name__} comparisons are encrypted bits with no "
            "Python truth value; decrypt() the result instead")

    def _bit(self, ct):
        return type(self)(ct[..., None, :], self.ck)

    def _flip(self, ct):
        return self._bit(_trivial_digit(1, ct) - ct)

    def __eq__(self, other):
        pair = self._aligned(other)
        if pair is None:
            return NotImplemented
        return self._bit(radix_eq(*pair, self.ck))

    def __ne__(self, other):
        pair = self._aligned(other)
        if pair is None:
            return NotImplemented
        return self._flip(radix_eq(*pair, self.ck))

    def __lt__(self, other):
        pair = self._aligned(other)
        if pair is None:
            return NotImplemented
        return self._bit(self._lt_digits(*pair, self.ck))

    def __gt__(self, other):
        pair = self._aligned(other)
        if pair is None:
            return NotImplemented
        a, b = pair
        return self._bit(self._lt_digits(b, a, self.ck))

    def __le__(self, other):
        pair = self._aligned(other)
        if pair is None:
            return NotImplemented
        a, b = pair
        return self._flip(self._lt_digits(b, a, self.ck))

    def __ge__(self, other):
        pair = self._aligned(other)
        if pair is None:
            return NotImplemented
        return self._flip(self._lt_digits(*pair, self.ck))

    def _bitwise(self, other, op):
        a, b = self._aligned_req(other)
        return type(self)(radix_bitwise(a, b, op, self.ck), self.ck)

    def __and__(self, other):
        return self._bitwise(other, "and")

    def __or__(self, other):
        return self._bitwise(other, "or")

    def __xor__(self, other):
        return self._bitwise(other, "xor")

    __rand__, __ror__, __rxor__ = __and__, __or__, __xor__

    def min(self, other):
        a, b = self._aligned_req(other)
        return type(self)(radix_select(self._lt_digits(a, b, self.ck),
                                       a, b, self.ck), self.ck)

    def max(self, other):
        a, b = self._aligned_req(other)
        return type(self)(radix_select(self._lt_digits(a, b, self.ck),
                                       b, a, self.ck), self.ck)


class FheUint(_FheOpsMixin):
    """Operator-overloaded encrypted unsigned integer (tfhe-rs-style DX).

    A thin immutable handle over the radix machinery: ``digits`` is the
    int32 [..., D, n0+1] little-endian base-8 ciphertext array and ``ck``
    the evaluation key.  ``+ - * & | ^ << >>`` and the six comparisons
    all work homomorphically: add/mul widen to the exact result, sub
    wraps mod 8^D, comparisons return an encrypted 0/1 bit (a 1-digit
    FheUint usable with ``.select(a, b)``/``.min``/``.max``); mixed-width
    operands are allowed.  Plain ints are encrypted trivially (b-only
    ciphertexts) on the fly, so ``x + 3`` and ``x < 100`` work.

    No reference analog (the reference composes nothing on its multi-bit
    sets); works on any parameter set whose PBS is reliable at m=16
    (uint4, TEST_TINY_UINT).
    """

    __slots__ = ("digits", "ck")

    def __init__(self, digits, ck: CloudKey):
        self.digits = digits
        self.ck = ck

    @classmethod
    def encrypt(cls, key, value, n_digits: int, sk, ck: CloudKey,
                alpha: float | None = None) -> "FheUint":
        a = ck.params.tlwe_lv0.alpha if alpha is None else alpha
        return cls(encrypt_radix(key, value, n_digits, a, sk.key_lv0,
                                 ck.params.torus_bits), ck)

    def _coerce(self, other) -> "FheUint":
        if isinstance(other, FheUint):
            return other
        v = int(other)
        if v < 0:
            raise ValueError(f"FheUint is unsigned, got {v}")
        bb = _spec_like(self.digits)[0]
        D = max(1, -(-v.bit_length() // bb))
        return FheUint(_trivial_radix(v, D, self.digits), self.ck)

    @property
    def n_digits(self) -> int:
        return self.digits.shape[-2]

    def __add__(self, other):
        o = self._coerce(other)
        return FheUint(radix_add(*_pad_to_match(self.digits, o.digits),
                                 self.ck), self.ck)

    __radd__ = __add__

    def __mul__(self, other):
        if not isinstance(other, FheUint):
            v = int(other)
            if v < 0:
                raise ValueError(f"FheUint is unsigned, got {v}")
            # plain-constant fast path: known digits need no homomorphic
            # bit extraction (~2 rotations/digit vs ~7)
            return FheUint(radix_mul_plain(self.digits, v, self.ck),
                           self.ck)
        return FheUint(radix_mul(self.digits, other.digits, self.ck),
                       self.ck)

    __rmul__ = __mul__

    def __floordiv__(self, other):
        return self.__divmod__(other)[0]

    def __mod__(self, other):
        return self.__divmod__(other)[1]

    def __divmod__(self, other):
        if not isinstance(other, FheUint):
            v = int(other)
            if v > 0 and v & (v - 1) == 0:     # power of two: shift + mask
                k = v.bit_length() - 1
                return (FheUint(radix_shr(self.digits, k, self.ck),
                                self.ck),
                        FheUint(radix_mask_low(self.digits, k, self.ck),
                                self.ck))
        o = self._coerce(other)
        q, r = radix_divmod(self.digits, o.digits, self.ck)
        return FheUint(q, self.ck), FheUint(r, self.ck)

    def __rfloordiv__(self, other):
        return self._coerce(other).__floordiv__(self)

    def __rmod__(self, other):
        return self._coerce(other).__mod__(self)

    def __rdivmod__(self, other):
        return self._coerce(other).__divmod__(self)

    def overflowing_add(self, other):
        """(wrapping sum at the common width, encrypted carry-out bit) —
        the widened add's top digit IS the carry (0/1)."""
        a, b = _pad_to_match(self.digits, self._coerce(other).digits)
        wide = radix_add(a, b, self.ck)
        return (FheUint(wide[..., :-1, :], self.ck),
                self._bit(wide[..., -1, :]))

    def overflowing_sub(self, other):
        """(wrapping difference, encrypted borrow bit = self < other)."""
        a, b = _pad_to_match(self.digits, self._coerce(other).digits)
        diff, borrow = radix_sub(a, b, self.ck)
        return FheUint(diff, self.ck), self._bit(borrow)

    def __sub__(self, other):
        """Wrapping difference mod 8^D (tfhe-rs semantics); use
        ``a < b`` for the underflow indicator."""
        a, b = _pad_to_match(self.digits, self._coerce(other).digits)
        return FheUint(radix_sub(a, b, self.ck)[0], self.ck)

    def __rsub__(self, other):
        return self._coerce(other).__sub__(self)

    # comparisons/bitwise/min/max come from _FheOpsMixin via _aligned
    def _aligned(self, other):
        if not isinstance(other, (FheUint, int, np.integer)):
            return None
        return _pad_to_match(self.digits, self._coerce(other).digits)

    _lt_digits = staticmethod(radix_lt)

    def __lshift__(self, s):
        """Plain amounts widen to hold every bit; an encrypted amount
        (FheUint or FheInt digits, treated unsigned) keeps the width
        (wraps mod 8^D, barrel shifter)."""
        if isinstance(s, (FheUint, FheInt)):
            return FheUint(radix_shl_enc(self.digits, s.digits, self.ck),
                           self.ck)
        return FheUint(radix_shl(self.digits, int(s), self.ck), self.ck)

    def __rshift__(self, s):
        if isinstance(s, (FheUint, FheInt)):
            return FheUint(radix_shr_enc(self.digits, s.digits, self.ck),
                           self.ck)
        return FheUint(radix_shr(self.digits, int(s), self.ck), self.ck)

    def select(self, if_true, if_false) -> "FheUint":
        """self is an encrypted 0/1 bit: returns if_true where 1 else
        if_false (2 rotations, any width)."""
        a, b = _pad_to_match(self._coerce(if_true).digits,
                             self._coerce(if_false).digits)
        return FheUint(radix_select(self.digits[..., 0, :], a, b, self.ck),
                       self.ck)

    def decrypt(self, sk):
        return decrypt_radix(self.digits, sk.key_lv0)


class FheInt(_FheOpsMixin):
    """Operator-overloaded encrypted SIGNED integer (two's complement).

    Same radix-8 machinery as FheUint, fixed-width semantics: every
    binary op aligns to the widest operand's D digits (narrower
    ciphertexts sign-extend with one sign7 rotation; plain ints encode
    trivially at the target width) and wraps mod 8^D.  Comparisons are
    signed (one flipsign rotation biases both tops, then the unsigned
    borrow chain); ``>>`` is arithmetic (sign-filling).  Value range
    [-8^D/2, 8^D/2).
    """

    __slots__ = ("digits", "ck")

    def __init__(self, digits, ck: CloudKey):
        self.digits = digits
        self.ck = ck

    @classmethod
    def encrypt(cls, key, value, n_digits: int, sk, ck: CloudKey,
                alpha: float | None = None) -> "FheInt":
        a = ck.params.tlwe_lv0.alpha if alpha is None else alpha
        bb = _spec_params(ck.params)[0]
        v = np.asarray(value, np.int64)
        half = (1 << (bb * n_digits)) // 2
        if ((v < -half) | (v >= half)).any():
            raise ValueError(f"{value} out of range for {n_digits} digits "
                             f"[{-half}, {half})")
        enc_v = np.mod(v, 1 << (bb * n_digits))
        return cls(encrypt_radix(key, enc_v, n_digits, a, sk.key_lv0,
                                 ck.params.torus_bits), ck)

    @property
    def n_digits(self) -> int:
        return self.digits.shape[-2]

    def _at_width(self, x, D: int):
        """x (FheInt or plain int) as a digits array of width exactly D."""
        if isinstance(x, FheInt):
            extra = D - x.n_digits
            assert extra >= 0, (D, x.n_digits)
            if extra == 0:
                return x.digits
            sign7 = _pbs_mv(x.digits[..., -1, :], ("sign7",), self.ck)[0]
            ext = jnp.broadcast_to(
                sign7[..., None, :],
                x.digits.shape[:-2] + (extra, sign7.shape[-1]))
            return jnp.concatenate([x.digits, ext], axis=-2)
        v = int(x)
        bb = _spec_like(self.digits)[0]
        half = (1 << (bb * D)) // 2
        if not -half <= v < half:
            raise ValueError(f"constant {v} out of range for {D} digits")
        return _trivial_radix(v % (1 << (bb * D)), D, self.digits)

    def _align(self, other):
        bb = _spec_like(self.digits)[0]
        if isinstance(other, FheInt):
            D = max(self.n_digits, other.n_digits)
        else:
            D = max(self.n_digits,
                    -(-(int(other).bit_length() + 1) // bb), 1)
        return self._at_width(self, D), self._at_width(other, D), D

    def __add__(self, other):
        a, b, D = self._align(other)
        return FheInt(radix_add(a, b, self.ck)[..., :D, :], self.ck)

    __radd__ = __add__

    def __sub__(self, other):
        a, b, _ = self._align(other)
        return FheInt(radix_sub(a, b, self.ck)[0], self.ck)

    def __rsub__(self, other):
        a, b, _ = self._align(other)
        return FheInt(radix_sub(b, a, self.ck)[0], self.ck)

    def __neg__(self):
        return self.__rsub__(0)

    def overflowing_add(self, other):
        """(wrapping sum, encrypted SIGNED-overflow bit): overflow iff
        the operands agree in sign and the result's sign differs.  One
        batched sign1 extraction of the three top digits + one packed
        sovf round on v = sa + 2*sb + 4*sr (scalar weights <= 4 on fresh
        0/1 bits stay far inside the m = 16 budget)."""
        a, b, D = self._align(other)
        r = radix_add(a, b, self.ck)[..., :D, :]
        tops = jnp.stack([a[..., -1, :], b[..., -1, :], r[..., -1, :]])
        s = _pbs_rows(tops, ("sign1",) * 3, self.ck)
        v = s[0] + 2 * s[1] + 4 * s[2]
        ovf = _pbs_rows(v[None], ("sovf",), self.ck)[0]
        return FheInt(r, self.ck), self._bit(ovf)

    def abs(self) -> "FheInt":
        """|self| (note: INT_MIN has no positive counterpart and wraps
        to itself, as in two's complement)."""
        neg = self < 0
        return neg.select(-self, self)

    def div_rem(self, other) -> tuple["FheInt", "FheInt"]:
        """TRUNCATING signed division (tfhe-rs/C semantics, not Python
        floor): quotient rounds toward zero, remainder takes the
        dividend's sign.  |a| divmod |b| on the unsigned machinery, then
        two encrypted sign fixes (the sign bits are computed once and
        reused for both the abs muxes and the fixes)."""
        a, b, _ = self._align(other)
        fa, fb = FheInt(a, self.ck), FheInt(b, self.ck)
        sa, sb = fa < 0, fb < 0
        abs_a, abs_b = sa.select(-fa, fa), sb.select(-fb, fb)
        q, r = radix_divmod(abs_a.digits, abs_b.digits, self.ck)
        qsign = sa != sb                           # signs differ -> negate q
        fq, fr = FheInt(q, self.ck), FheInt(r, self.ck)
        return qsign.select(-fq, fq), sa.select(-fr, fr)

    def __mul__(self, other):
        if not isinstance(other, FheInt):
            # plain-constant fast path on the raw representation (exact
            # mod 8^D), sign fixed by one negation
            v = int(other)
            D = self.n_digits
            if v == 0:
                return FheInt(_trivial_radix(0, D, self.digits), self.ck)
            out = radix_mul_plain(self.digits, abs(v), self.ck)[..., :D, :]
            f = FheInt(out, self.ck)
            return -f if v < 0 else f
        a, b, D = self._align(other)
        return FheInt(radix_mul(a, b, self.ck)[..., :D, :], self.ck)

    __rmul__ = __mul__

    # comparisons/bitwise/min/max come from _FheOpsMixin via _aligned
    def _aligned(self, other):
        if not isinstance(other, (FheInt, int, np.integer)):
            return None
        a, b, _ = self._align(other)
        return a, b

    _lt_digits = staticmethod(radix_lt_signed)

    def __lshift__(self, s):
        """Wrapping left shift; the amount may be plain or an encrypted
        unsigned value (FheUint/FheInt digits, treated unsigned)."""
        if isinstance(s, (FheInt, FheUint)):
            return FheInt(radix_shl_enc(self.digits, s.digits, self.ck),
                          self.ck)
        D = self.n_digits
        return FheInt(radix_shl(self.digits, int(s), self.ck)[..., :D, :],
                      self.ck)

    def __rshift__(self, s):
        """Arithmetic right shift (sign-filling), plain or encrypted
        amount."""
        if isinstance(s, (FheInt, FheUint)):
            return FheInt(radix_asr_enc(self.digits, s.digits, self.ck),
                          self.ck)
        return FheInt(radix_asr(self.digits, int(s), self.ck), self.ck)

    def select(self, if_true, if_false) -> "FheInt":
        """self is an encrypted 0/1 bit: if_true where 1 else if_false.
        At least one branch must be a ciphertext (plain-int branches
        encode at the widest branch's width)."""
        anchor = if_true if isinstance(if_true, FheInt) else if_false
        if not isinstance(anchor, FheInt):
            raise ValueError("select needs at least one ciphertext branch")
        if anchor is if_true:
            a, b, _ = anchor._align(if_false)
        else:
            b, a, _ = anchor._align(if_true)
        return FheInt(radix_select(self.digits[..., 0, :], a, b, self.ck),
                      self.ck)

    def decrypt(self, sk):
        raw = decrypt_radix(self.digits, sk.key_lv0)
        mod = 1 << (_spec_like(self.digits)[0] * self.n_digits)
        if isinstance(raw, (int, np.integer)):
            return int(raw - mod) if raw >= mod // 2 else int(raw)
        return np.where(raw >= mod // 2, raw - mod, raw)


def _pad_to_match(a, b):
    """Zero-pad the narrower radix array (most-significant end) so both
    have equal digit counts (a trivial zero digit encrypts 0 exactly)."""
    Da, Db = a.shape[-2], b.shape[-2]
    if Da == Db:
        return a, b

    def pad(x, extra):
        z = jnp.zeros(x.shape[:-2] + (extra, x.shape[-1]), x.dtype)
        return jnp.concatenate([x, z], axis=-2)

    return (a, pad(b, Da - Db)) if Da > Db else (pad(a, Db - Da), b)
