"""Key generation: secret keys and the cloud (evaluation) key.

Differences from the reference (key.zig), all for batched execution:

  * keygen is fully vectorized JAX (the reference's sequential keygen takes
    ~30s, key.zig:240-241; ours is one batched TRGSW encrypt + one batched
    TLWE encrypt);
  * the bootstrapping key is stored in negacyclic-extension int8-limb form
    (see trgsw.py:to_ext_limbs) instead of the f64 FFT domain;
  * the key-switching key stores ONE entry per (i, j) — ``KSK1[i*t+j]``
    encrypts ``s1[i] * 2^(32-(j+1)*basebit)`` — because digits are signed
    (see ops/keyswitch.py).  The reference stores base*t*N entries and skips
    k=0 (key.zig:148-172);
  * everything is deterministic from a single PRNG key.

CloudKey is a pytree (jit/shard_map friendly); ``params`` rides along as
static aux data.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp

from zig_tfhe_jax import trgsw as _trgsw
from zig_tfhe_jax import tlwe as _tlwe
from zig_tfhe_jax.ops.keyswitch import ks_plaintexts as _ks_plaintexts
from zig_tfhe_jax.params import SecurityParams
from zig_tfhe_jax.utils import rng as _rng
from zig_tfhe_jax.utils.torus import to_i32, torus_constant


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SecretKey:
    """Binary secret keys for lv0 and lv1 (key.zig:34-58)."""

    key_lv0: Any  # int32 [n0], values in {0,1}
    key_lv1: Any  # int32 [N],  values in {0,1}

    def tree_flatten(self):
        return (self.key_lv0, self.key_lv1), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def generate(cls, key, params: SecurityParams) -> "SecretKey":
        k0, k1 = jax.random.split(key)
        return cls(
            key_lv0=_rng.uniform_binary(k0, (params.n0,)),
            key_lv1=_rng.uniform_binary(k1, (params.n1,)),
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CloudKey:
    """Evaluation key (key.zig:61-77), in batched-engine layouts.

    testvec:       int32 [2, N]             (a=0, b==1/8; key.zig:134-145)
    ksk1:          int32 [N*t, n0+1]        (signed-digit key switch key)
    bsk_ntt:       BSK in NTT residue form (the fast engine's key, rounded
                   by bsk_ntt_drop bits):
                     bsk_group=1: int16 [n0, P, 2L, 2, N]
                     bsk_group=g (generate() defaults per set —
                       ops/ntt.py:default_group: 3 for boolean, 2 for
                       uint): int16 [ceil(n0/g), 2^g - 1, P, 2L, 2, N] —
                       TRGSWs of every nonempty subset product of g key
                       bits per coefficient group (multi-bit rotation)
    bsk_ext_limbs: int8  [n0, 4, 2L, 2, 2N] (BSK in ext-limb form, for the
                   Toeplitz engines; optional)
    """

    testvec: Any
    ksk1: Any
    bsk_ntt: Any = None
    bsk_ext_limbs: Any = None
    # optional TLWE->TRLWE packing key-switch key (int32 [n1*t, 2, N],
    # ops/packing_keyswitch.py): enables the tree-PBS fast paths (radix
    # LUTs, the integer layer's bivariate digit multiplier).  Built at
    # the parameter set's (basebit, iks_t); generate(packing_key=True).
    pksk: Any = None
    params: SecurityParams = dataclasses.field(
        default=None, metadata=dict(static=True))
    # (basebit, t) build contract of the embedded pksk — validated by the
    # consumers (models/integer.py:digit_mul) so a custom-gadget key can
    # never be silently decomposed at the wrong base (a same-row-count
    # mismatch decodes garbage with no error otherwise).  None when pksk
    # is None, or for pre-contract saved keys (treated as the parameter
    # defaults, which is how CloudKey.generate has always built it).
    pksk_gadget: tuple | None = dataclasses.field(
        default=None, metadata=dict(static=True))
    bsk_ntt_drop: int = dataclasses.field(
        default=0, metadata=dict(static=True))
    bsk_group: int = dataclasses.field(
        default=1, metadata=dict(static=True))
    # (a_levels, b_levels) of the NTT BSK's gadget rows; None = exact
    # symmetric, read off the key shape (pre-asymmetric saved keys)
    bsk_levels: tuple | None = dataclasses.field(
        default=None, metadata=dict(static=True))
    # ENGINE gadget base of the NTT BSK (ops/ntt.py:default_engine_gadget);
    # None = the parameter set's bgbit (pre-engine-gadget saved keys)
    bsk_bgbit: int | None = dataclasses.field(
        default=None, metadata=dict(static=True))

    def tree_flatten(self):
        return ((self.testvec, self.ksk1, self.bsk_ntt, self.bsk_ext_limbs,
                 self.pksk),
                (self.params, self.bsk_ntt_drop, self.bsk_group,
                 self.bsk_levels, self.bsk_bgbit, self.pksk_gadget))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, params=aux[0], bsk_ntt_drop=aux[1],
                   bsk_group=aux[2], bsk_levels=aux[3], bsk_bgbit=aux[4],
                   pksk_gadget=aux[5])

    @classmethod
    def generate(cls, key, secret_key: SecretKey, params: SecurityParams,
                 engines=("ntt",), bsk_limbs: int = 4,
                 ntt_drop: int | None = None, group: int | None = None,
                 decomp_levels: int | None = None,
                 engine_bgbit: int | None = None,
                 packing_key: bool | None = None) -> "CloudKey":
        """engines selects the BSK forms to materialize ('ntt' and/or
        'toeplitz').  group=g builds the multi-bit NTT bootstrapping key
        (TRGSWs of every nonempty subset product of g secret bits per
        coefficient group — divides the blind-rotate scan length by g);
        None picks the default per parameter set
        (ops/ntt.py:default_group — 3 for the boolean sets, 2 for uint).
        SECURITY NOTE: any group > 1 publishes TRGSW encryptions of
        g-bit secret-key subset PRODUCTS (BMMP16-style) — a stronger
        circular-security-flavored assumption than the reference's
        per-bit BSK (key.zig:175-212); pass group=1 for the classic
        per-bit key format (docs/NOISE.md §6 quantifies both).

        packing_key=None (the default) builds the TLWE->TRLWE packing
        key-switch key for the uint-family sets (default_packing_key) —
        it is what routes FheUint multiplication and the radix/bivariate
        LUTs through the fast tree-PBS — and skips it for the boolean
        sets (whose gate path never packs).  Pass True/False to force.
        ntt_drop (BSK rounding bits) defaults per params; bsk_limbs < 4 is
        the Toeplitz engines' analogous knob.

        (engine_bgbit, decomp_levels) is the NTT BSK's ENGINE gadget
        (ops/ntt.py:default_engine_gadget — the gadget inside the bootstrap
        is an implementation detail; the boolean sets default to Bg_e = 2^8
        with (2, 2) levels, 4 rows of 16-bit precision).  Passing
        decomp_levels alone keeps the parameter base (the approximate
        gadget on the reference's Bg); pass (params.bgbit, params.L) to
        force the exact reference gadget."""
        from zig_tfhe_jax.ops import ntt as _nttmod
        from zig_tfhe_jax.utils.torus import require_width

        require_width(params.torus_bits)
        if params.torus_bits != 32 and "toeplitz" in engines:
            raise ValueError(
                "the Toeplitz engine is 32-bit-only (ext-limb key form); "
                "64-bit-torus sets use engines=('ntt',)")
        if group is None:
            group = _nttmod.default_group(params)
        if engine_bgbit is None:
            if decomp_levels is None:
                engine_bgbit, decomp_levels = _nttmod.default_engine_gadget(
                    params, group)
            else:
                engine_bgbit = params.bgbit
        # decomp_levels=None with an explicit engine_bgbit -> all
        # floor(torus_bits/bgbit) levels (full precision at that base)
        decomp_levels = _nttmod.norm_levels(params, decomp_levels,
                                            bgbit=engine_bgbit)
        if ntt_drop is None:
            ntt_drop = _nttmod.default_drop_bits(params, group, engine_bgbit)
        testvec, ksk1, bsk_ntt, bsk_ext = _gen_cloud_key_arrays(
            key, secret_key, params=params,
            with_ntt="ntt" in engines, with_toeplitz="toeplitz" in engines,
            bsk_limbs=bsk_limbs, ntt_drop=ntt_drop, group=group,
            levels=decomp_levels, bgbit=engine_bgbit)
        if packing_key is None:
            packing_key = default_packing_key(params)
        pksk = None
        if packing_key:
            pksk = _gen_pksk_jit(jax.random.fold_in(key, 0x9acc), secret_key,
                                 params)
        from zig_tfhe_jax.ops.packing_keyswitch import default_packing_gadget
        return cls(
            testvec=testvec,
            ksk1=ksk1,
            bsk_ntt=bsk_ntt,
            bsk_ext_limbs=bsk_ext,
            pksk=pksk,
            pksk_gadget=default_packing_gadget(params) if pksk is not None
            else None,
            params=params,
            bsk_ntt_drop=ntt_drop,
            bsk_group=group if "ntt" in engines else 1,
            bsk_levels=decomp_levels if "ntt" in engines else None,
            bsk_bgbit=engine_bgbit if "ntt" in engines else None,
        )

    @classmethod
    def generate_no_ksk(cls, params: SecurityParams,
                        engines=("ntt",), group: int | None = 1,
                        decomp_levels: int | None = None,
                        engine_bgbit: int | None = None,
                        ntt_drop: int | None = None) -> "CloudKey":
        """Cheap test fixture: dummy all-zero BSK, zero KSK (key.zig:80-100).

        group>1 gives the multi-bit BSK layout that CloudKey.generate()
        produces by default (same compile graph as production); ntt_drop
        (BSK rounding bits) overrides default_drop_bits, matching
        generate()'s knob.  group=None matches generate()'s per-set
        default (the keygen fixture keeps group=1 as ITS default: most
        kernel tests want the single-bit layout).
        """
        from zig_tfhe_jax.ops import ntt as _nttmod

        if group is None:
            group = _nttmod.default_group(params)
        if engine_bgbit is None:
            if decomp_levels is None:
                engine_bgbit, decomp_levels = _nttmod.default_engine_gadget(
                    params, group)
            else:
                engine_bgbit = params.bgbit
        decomp_levels = _nttmod.norm_levels(params, decomp_levels,
                                            bgbit=engine_bgbit)
        if ntt_drop is None:
            ntt_drop = _nttmod.default_drop_bits(params, group, engine_bgbit)
        la, lb = decomp_levels
        bsk_ntt = None
        if "ntt" in engines:
            plan = _nttmod.plan_for_params(params, ntt_drop, group,
                                           decomp_levels, bgbit=engine_bgbit,
                                           pseudorandom_key=True)
            if params.split_ring:
                # folded split layout (ops/split_ring.py:fold_key_split):
                # row axis (r, q_in) = 2R, plane axis (c, q_out) = 4, Nh
                tail = (plan.n_primes, 2 * (la + lb), 4, params.N // 2)
            else:
                tail = (plan.n_primes, la + lb, 2, params.N)
            if group == 1:
                shape = (params.n0,) + tail
            else:
                G = -(-params.n0 // group)
                shape = (G, (1 << group) - 1) + tail
            bsk_ntt = jnp.zeros(shape, jnp.int16)
        bsk_ext = None
        if "toeplitz" in engines:
            bsk_ext = jnp.zeros(
                (params.n0, _trgsw.N_KLIMBS, 2 * params.L, 2, 2 * params.N),
                jnp.int8)
        from zig_tfhe_jax.utils.torus import carrier_dtype

        return cls(
            testvec=gen_testvec(params),
            ksk1=jnp.zeros((params.n1 * params.iks_t, params.n0 + 1),
                           carrier_dtype(params.torus_bits)),
            bsk_ntt=bsk_ntt,
            bsk_ext_limbs=bsk_ext,
            params=params,
            bsk_ntt_drop=ntt_drop,
            bsk_group=group if "ntt" in engines else 1,
            bsk_levels=decomp_levels if "ntt" in engines else None,
            bsk_bgbit=engine_bgbit if "ntt" in engines else None,
        )


def default_packing_key(params: SecurityParams) -> bool:
    """Whether CloudKey.generate builds the packing key by default.

    True for the multi-bit message sets (uint1-8 and the tiny uint test
    set) — their integer layer's digit multiplier and the radix/bivariate
    LUT routes take the packing-key tree PBS (without it the
    quickstart's ``a * b`` silently takes the slower path).
    Also True for the 64-bit-torus sets: the radix tree-PBS is their
    only exact route to m >= 64 LUTs (single-shot is modswitch-limited
    to m <= 32, docs/TORUS64.md §9), and the integer layer's digit
    multiplier rides the same key.  False for the 32-bit boolean sets,
    whose gate pipeline never packs.  Custom parameter sets follow the
    same rules; pass packing_key explicitly to override either way.
    """
    return (params.name.startswith("uint") or params.name == "tiny_uint"
            or params.torus_bits == 64)


@functools.partial(jax.jit, static_argnames=("params",))
def _gen_pksk_jit(key, secret_key: "SecretKey", params: SecurityParams):
    """Packing key as one jitted dispatch (gen_packing_ksk at the
    parameter defaults; ops/packing_keyswitch.py for the layout)."""
    from zig_tfhe_jax.ops.packing_keyswitch import gen_packing_ksk

    return gen_packing_ksk(key, secret_key.key_lv1, params)


@functools.partial(
    jax.jit, static_argnames=("params", "with_ntt", "with_toeplitz",
                              "bsk_limbs", "ntt_drop", "group", "levels",
                              "bgbit"))
def _gen_cloud_key_arrays(key, secret_key: "SecretKey", *,
                          params: SecurityParams, with_ntt: bool,
                          with_toeplitz: bool, bsk_limbs: int,
                          ntt_drop: int, group: int, levels: int | None = None,
                          bgbit: int | None = None):
    """One jitted graph for the whole cloud keygen: a single dispatch
    instead of a few hundred eager ones."""
    # independent keys per BSK form: reusing one key would give the two
    # published encryptions identical masks/noise, leaking exact secret-key
    # relations (c_ntt[r] - c_toep[r] = (m_ntt - m_toep) * h)
    k_ksk, k_bsk_ntt, k_bsk_toep = jax.random.split(key, 3)
    bsk_ntt = (gen_bootstrapping_key_ntt(k_bsk_ntt, secret_key, params,
                                         ntt_drop, group, levels, bgbit)
               if with_ntt else None)
    bsk_ext = (gen_bootstrapping_key(k_bsk_toep, secret_key, params,
                                     bsk_limbs)
               if with_toeplitz else None)
    return (gen_testvec(params),
            gen_key_switching_key(k_ksk, secret_key, params),
            bsk_ntt, bsk_ext)


def gen_testvec(params: SecurityParams):
    """Trivial TRLWE with b == 1/8 everywhere (key.zig:134-145)."""
    from zig_tfhe_jax.utils.torus import carrier_dtype, to_carrier
    from zig_tfhe_jax.utils.torus import torus_constant_w

    w = params.torus_bits
    dt = carrier_dtype(w)
    b = jnp.full((params.N,), to_carrier(torus_constant_w(0.125, w), w), dt)
    a = jnp.zeros((params.N,), dt)
    return jnp.stack([a, b])


def gen_key_switching_key(key, secret_key: SecretKey, params: SecurityParams):
    """KSK1[i*t+j] = TLWE_lv0( s1[i] * 2^(w-(j+1)*basebit) ), noise KSK_ALPHA.

    Single batched TLWE encrypt (vs 27k sequential encrypts, key.zig:148-172).
    The row encoding is the shared key-switch contract
    (ops/keyswitch.py:ks_plaintexts); proxy re-encryption keys use it too.
    """
    w = params.torus_bits
    mu = _ks_plaintexts(secret_key.key_lv1, params.basebit, params.iks_t, w)
    ct = _tlwe.encrypt_torus(key, mu, params.ksk_alpha, secret_key.key_lv0,
                             width=w)
    return ct.reshape(params.n1 * params.iks_t, params.n0 + 1)


def gen_bootstrapping_key(key, secret_key: SecretKey, params: SecurityParams,
                          bsk_limbs: int = 4):
    """BSK[i] = TRGSW(s0[i]) under the lv1 key, in ext-limb form
    (key.zig:175-212 + the FFT-form conversion, here exact int8 limbs)."""
    trgsw_ct = _trgsw.encrypt_torus(
        key, secret_key.key_lv0, params.bsk_alpha, secret_key.key_lv1, params)
    return _trgsw.to_ext_limbs(trgsw_ct, bsk_limbs)  # [n0, limbs, 2L, 2, 2N] i8


def gen_bootstrapping_key_ntt(key, secret_key: SecretKey,
                              params: SecurityParams, drop: int, group: int,
                              levels: int | None = None,
                              bgbit: int | None = None):
    """BSK in NTT residue form (the fast engine's key).

    group=1: TRGSW(s[i]) per coefficient -> int16 [n0, P, 2L', 2, N].
    group=g>1: TRGSW of every nonempty subset product of g secret bits
    per coefficient group (multi-bit blind rotation) -> int16
    [G, 2^g - 1, P, 2L', 2, N], G = ceil(n0/g); ragged n0 is padded with
    zero key bits (TRGSW(0) = CMux no-op).

    (bgbit, levels) is the ENGINE gadget (ops/ntt.py:default_engine_gadget):
    the key's rows are ordinary TRLWE encryptions of s * Bg_e^-(i+1) — la
    a-rows then lb b-rows (trgsw.encrypt_gadget_rows) — so the gadget base
    is free to differ from the parameter set's; each row is a fresh
    encryption under the same security assumption.  levels < the full
    count selects the approximate gadget (only the top digits of the
    accumulator feed the external product; ops/ntt.py:norm_levels explains
    the a/b asymmetry).
    """
    from zig_tfhe_jax.ops import ntt as _nttmod

    s = secret_key.key_lv0
    if group == 1:
        values = s
    else:
        # group-g multi-bit key: per coefficient group, TRGSW-encrypt the
        # secret-bit PRODUCT of every nonempty subset (mask bit i <->
        # group coefficient i) — BMMP16-style.  The mask order matches
        # ops/ntt.py:rotate_combine_multi; for g=2 it is (s1, s2, s1*s2)
        # = masks (1, 2, 3), identical to the measured-tuned group-2
        # combiner's expectation.  Padding bits are zero (TRGSW(0) =
        # CMux no-op).
        G = -(-params.n0 // group)
        pad = group * G - params.n0
        s_pad = jnp.concatenate([s, jnp.zeros(pad, s.dtype)]) if pad else s
        bits = [s_pad[i::group] for i in range(group)]       # each [G]
        subset_vals = []
        for m in range(1, 1 << group):
            v = None
            for i in range(group):
                if m >> i & 1:
                    v = bits[i] if v is None else v * bits[i]
            subset_vals.append(v)
        n_masks = (1 << group) - 1
        values = jnp.stack(subset_vals, axis=1).reshape(n_masks * G)
    if params.split_ring:
        # N > 1024: the even/odd split engine's key form (folded split-NTT
        # planes per subset value — ops/split_ring.py)
        from zig_tfhe_jax.ops.split_ring import gen_bootstrapping_key_ntt_split
        return gen_bootstrapping_key_ntt_split(
            key, values, secret_key.key_lv1, params, drop, group, levels,
            bgbit)
    e = params.bgbit if bgbit is None else bgbit
    la, lb = _nttmod.norm_levels(params, levels, bgbit=e)
    plan = _nttmod.plan_for_params(params, drop, group, (la, lb), bgbit=e,
                                   pseudorandom_key=True)
    trgsw_ct = _trgsw.encrypt_gadget_rows(
        key, values, params.bsk_alpha, secret_key.key_lv1, params, e, la, lb)
    res = jnp.moveaxis(_nttmod.to_ntt_form(trgsw_ct, plan, drop,
                                           width=params.torus_bits), 0, 1)
    if group > 1:
        G = -(-params.n0 // group)
        res = res.reshape(G, (1 << group) - 1, plan.n_primes,
                          la + lb, 2, params.N)
    return res
