"""Key and ciphertext (de)serialization.

The reference has NO serialization anywhere (SURVEY.md §5) — but multi-host
key distribution requires it, so it is a first-class feature here.  Format:
numpy ``.npz`` with a manifest entry carrying the FULL parameter set (every
field, so custom/tweaked SecurityParams round-trip — the set name alone is
not authoritative) and the object kind; torus arrays are stored as uint32,
key material as int8/int16/int32.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax.models import proxy_reenc as PR

_KIND_SECRET = "secret_key"
_KIND_CLOUD = "cloud_key"
_KIND_CIPHERTEXT = "ciphertext"
_KIND_PUBLIC = "public_key"
_KIND_REENC = "reenc_key"
_KIND_SEEDED = "seeded_ciphertext"


def _npz_path(path):
    """np.savez appends '.npz' to extensionless paths; mirror that on load
    so save/load pairs round-trip for any path the caller gives."""
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _params_doc(params: P.SecurityParams) -> dict:
    return dataclasses.asdict(params)


def _params_from_doc(m: dict) -> P.SecurityParams:
    """Reconstruct the exact SecurityParams from the manifest.

    Full-field reconstruction (format >= v1 with 'params_full'); falls back
    to the stock-set name lookup for files written by older versions.
    """
    doc = m.get("params_full")
    if doc is None:
        name = m.get("params", "")
        if name not in P.PARAMS_BY_NAME:
            raise ValueError(
                f"file lacks embedded parameters and names an unknown "
                f"set {name!r}")
        return P.PARAMS_BY_NAME[name]
    params = P.SecurityParams(
        security_bits=doc["security_bits"],
        description=doc["description"],
        tlwe_lv0=P.TlweParams(**doc["tlwe_lv0"]),
        tlwe_lv1=P.TlweParams(**doc["tlwe_lv1"]),
        trlwe_lv1=P.TrlweParams(**doc["trlwe_lv1"]),
        trgsw_lv1=P.TrgswParams(**doc["trgsw_lv1"]),
        name=doc.get("name", ""),
        torus_bits=doc.get("torus_bits", 32),  # pre-width files: u32
    )
    # canonicalize to the stock instance when it matches field-for-field
    # (keeps object identity for the common case; tweaked sets round-trip
    # as their own reconstructed instance)
    stock = P.PARAMS_BY_NAME.get(params.name)
    return stock if stock == params else params


def _manifest(kind: str, params: P.SecurityParams, extra=None) -> np.ndarray:
    doc = {"format": "zig_tfhe_jax.v1", "kind": kind, "params": params.name,
           "params_full": _params_doc(params)}
    if extra:
        doc.update(extra)
    return np.frombuffer(json.dumps(doc).encode(), dtype=np.uint8)


def _open(path, kind: str):
    """Load an .npz and validate the manifest (real errors, not asserts —
    these guard external input and must survive python -O)."""
    z = np.load(_npz_path(path))
    try:
        m = json.loads(bytes(z["__manifest__"]).decode())
    except KeyError:
        z.close()
        raise ValueError(f"{path}: not a zig_tfhe_jax file (no manifest)")
    if not str(m.get("format", "")).startswith("zig_tfhe_jax."):
        z.close()
        raise ValueError(f"{path}: unknown format {m.get('format')!r}")
    if m.get("kind") != kind:
        z.close()
        raise ValueError(
            f"{path}: expected a {kind!r} file, found {m.get('kind')!r}")
    return z, m


def save_secret_key(path, sk: K.SecretKey, params: P.SecurityParams) -> None:
    np.savez(path, __manifest__=_manifest(_KIND_SECRET, params),
             key_lv0=np.asarray(sk.key_lv0), key_lv1=np.asarray(sk.key_lv1))


def load_secret_key(path):
    z, m = _open(path, _KIND_SECRET)
    with z:
        sk = K.SecretKey(jnp.asarray(z["key_lv0"]), jnp.asarray(z["key_lv1"]))
    return sk, _params_from_doc(m)


def save_cloud_key(path, ck: K.CloudKey) -> None:
    arrays = dict(testvec=np.asarray(ck.testvec), ksk1=np.asarray(ck.ksk1))
    if ck.bsk_ntt is not None:
        arrays["bsk_ntt"] = np.asarray(ck.bsk_ntt)
    if ck.bsk_ext_limbs is not None:
        arrays["bsk_ext_limbs"] = np.asarray(ck.bsk_ext_limbs)
    extra = {"bsk_ntt_drop": ck.bsk_ntt_drop, "bsk_group": ck.bsk_group,
             "bsk_levels": (list(ck.bsk_levels)
                            if ck.bsk_levels is not None else None),
             "bsk_bgbit": ck.bsk_bgbit}
    if getattr(ck, "pksk", None) is not None:
        # embedded packing key always uses the parameter-set (basebit, t)
        # contract (CloudKey.generate builds it that way); custom-gadget
        # packing keys travel via save_packing_ksk.  The contract is
        # persisted so digit_mul's fail-fast guard survives a round trip
        # (ADVICE r3 #1).
        arrays["pksk"] = np.asarray(ck.pksk)
        gadget = getattr(ck, "pksk_gadget", None)
        extra["pksk_gadget"] = (
            list(gadget) if gadget is not None
            else [ck.params.basebit, ck.params.iks_t])
    np.savez(path, __manifest__=_manifest(_KIND_CLOUD, ck.params, extra),
             **arrays)


def load_cloud_key(path) -> K.CloudKey:
    z, m = _open(path, _KIND_CLOUD)
    with z:
        params = _params_from_doc(m)
        has_pksk = "pksk" in z
        return K.CloudKey(
            testvec=jnp.asarray(z["testvec"]),
            ksk1=jnp.asarray(z["ksk1"]),
            bsk_ntt=jnp.asarray(z["bsk_ntt"]) if "bsk_ntt" in z else None,
            bsk_ext_limbs=(jnp.asarray(z["bsk_ext_limbs"])
                           if "bsk_ext_limbs" in z else None),
            pksk=jnp.asarray(z["pksk"]) if has_pksk else None,
            # pre-contract files (no pksk_gadget) always embedded a
            # parameter-default key — CloudKey.generate built it that way
            pksk_gadget=(tuple(m["pksk_gadget"]) if "pksk_gadget" in m
                         else (params.basebit, params.iks_t) if has_pksk
                         else None),
            params=params,
            bsk_ntt_drop=m.get("bsk_ntt_drop", 0),
            bsk_group=m.get("bsk_group", 1),
            bsk_levels=(tuple(m["bsk_levels"])
                        if m.get("bsk_levels") is not None else None),
            # absent in pre-engine-gadget files -> None = parameter base
            bsk_bgbit=m.get("bsk_bgbit"),
        )


def save_ciphertext(path, ct, params: P.SecurityParams) -> None:
    u = np.uint32 if params.torus_bits == 32 else np.uint64
    np.savez(path, __manifest__=_manifest(_KIND_CIPHERTEXT, params),
             ct=np.asarray(ct).view(u))


def load_ciphertext(path):
    z, m = _open(path, _KIND_CIPHERTEXT)
    params = _params_from_doc(m)
    i = np.int32 if params.torus_bits == 32 else np.int64
    with z:
        ct = jnp.asarray(z["ct"].view(i))
    return ct, params


def save_seeded_ciphertext(path, mask_seed, b, params: P.SecurityParams) -> None:
    """Seeded (compressed) TLWE batch: the MASK seed's key data + bodies
    only — (n0+1)x smaller on the wire than the expanded batch
    (tlwe.encrypt_*_seeded / tlwe.expand_seeded).

    ``mask_seed`` must be the first element of encrypt_*_seeded's return
    (the published half of the encryption key split), never the encryption
    key itself — the parent key also derives the Gaussian noise, and
    publishing it allows full secret-key recovery (see
    tlwe.encrypt_torus_seeded SECURITY note)."""
    import jax.random as _jr

    np.savez(path, __manifest__=_manifest(_KIND_SEEDED, params),
             key_data=np.asarray(_jr.key_data(mask_seed)),
             b=np.asarray(b).view(np.uint32))


def load_seeded_ciphertext(path, expand: bool = True):
    """Returns (ct, params) with ct expanded to [..., n0+1] (expand=True),
    or ((mask_seed, b), params) in compressed form."""
    import jax.random as _jr

    from zig_tfhe_jax import tlwe as _tlwe

    z, m = _open(path, _KIND_SEEDED)
    with z:
        mask_seed = _jr.wrap_key_data(jnp.asarray(z["key_data"]))
        b = jnp.asarray(z["b"].view(np.int32))
    params = _params_from_doc(m)
    if not expand:
        return (mask_seed, b), params
    return _tlwe.expand_seeded(mask_seed, b, params.n0,
                               params.torus_bits), params


def save_public_key(path, pk: PR.PublicKeyLv0,
                    params: P.SecurityParams) -> None:
    np.savez(path, __manifest__=_manifest(_KIND_PUBLIC, params),
             encryptions=np.asarray(pk.encryptions))


def load_public_key(path):
    z, m = _open(path, _KIND_PUBLIC)
    with z:
        pk = PR.PublicKeyLv0(jnp.asarray(z["encryptions"]))
    return pk, _params_from_doc(m)


def save_reenc_key(path, rk: PR.ProxyReencryptionKey,
                   params: P.SecurityParams) -> None:
    np.savez(path, __manifest__=_manifest(
        _KIND_REENC, params, {"basebit": rk.basebit, "t": rk.t}),
        key_encryptions=np.asarray(rk.key_encryptions))


def load_reenc_key(path):
    z, m = _open(path, _KIND_REENC)
    with z:
        rk = PR.ProxyReencryptionKey(jnp.asarray(z["key_encryptions"]),
                                     basebit=m["basebit"], t=m["t"])
    return rk, _params_from_doc(m)


_KIND_PACKING = "packing_ksk"


def save_packing_ksk(path, pksk, params: P.SecurityParams,
                     basebit: int | None = None, t: int | None = None) -> None:
    """Packing key-switch key (ops/packing_keyswitch.py:gen_packing_ksk).

    basebit/t default to the parameter set's key-switch settings (the
    gen_packing_ksk defaults); pass explicit values if the key was built
    with custom ones — they are stored so load reconstructs the contract.
    """
    np.savez(path, __manifest__=_manifest(
        _KIND_PACKING, params,
        {"basebit": params.basebit if basebit is None else basebit,
         "t": params.iks_t if t is None else t}),
        pksk=np.asarray(pksk))


def load_packing_ksk(path):
    """Returns (pksk, params, basebit, t)."""
    z, m = _open(path, _KIND_PACKING)
    with z:
        pksk = jnp.asarray(z["pksk"])
    return pksk, _params_from_doc(m), m["basebit"], m["t"]
