"""Bootstrapping strategies (batch-first).

Vanilla gate bootstrap (bootstrap/vanilla.zig:38-52): blind rotate ->
sample extract at 0 -> identity key switch.  All stages operate on a batch
``[B, ...]`` and the whole pipeline is one jittable function.

``bootstrap_to_lv1`` is the proper no-key-switch variant: it returns the
full TLWE **lv1** ciphertext (under the lv1 key), which downstream ops can
combine before a single final key switch (used by the optimized MUX in
models/gates.py).  The reference's bootstrapWithoutKeySwitch instead
truncates the mask to n0 coefficients (vanilla.zig:58-69 via
trlwe.zig:165-180) — provided as ``bootstrap_without_key_switch_truncated``
for API parity.
"""

from __future__ import annotations


import dataclasses
from typing import Any, Callable

from zig_tfhe_jax import trlwe as _trlwe
from zig_tfhe_jax.key import CloudKey
from zig_tfhe_jax.ops.blind_rotate import blind_rotate
from zig_tfhe_jax.ops.keyswitch import identity_key_switch

STRATEGY_NAME = "vanilla"


@dataclasses.dataclass(frozen=True)
class BootstrapStrategy:
    """Pluggable bootstrap strategy (bootstrap.zig:30-47's fn-pointer
    vtable, as a frozen dataclass of callables).

    Members mirror the reference interface: ``bootstrap`` (full pipeline),
    ``bootstrap_without_key_switch`` (result under the lv1 key), ``name``.
    All callables are batch-first ``(tlwe_batch, cloud_key) -> batch`` and
    jittable, so a strategy can be passed as a static argument.
    """

    bootstrap: Callable[[Any, CloudKey], Any]
    bootstrap_without_key_switch: Callable[[Any, CloudKey], Any]
    name: str = "custom"


def default_bootstrap() -> BootstrapStrategy:
    """The vanilla strategy (bootstrap.zig:50-52, vanilla.zig:72-75)."""
    return BootstrapStrategy(
        bootstrap=bootstrap,
        bootstrap_without_key_switch=bootstrap_to_lv1,
        name=STRATEGY_NAME,
    )


def bootstrap(tlwe_batch, ck: CloudKey):
    """Full gate bootstrap: [B, n0+1] -> refreshed [B, n0+1]."""
    tr = blind_rotate(tlwe_batch, ck.testvec, ck, ck.params,
                      tv_lo_zero=True)
    lv1 = _trlwe.sample_extract(tr, 0)
    return identity_key_switch(lv1, ck.ksk1, ck.params)


def bootstrap_to_lv1(tlwe_batch, ck: CloudKey):
    """Blind rotate + extract, NO key switch: [B, n0+1] -> [B, N+1] (lv1)."""
    tr = blind_rotate(tlwe_batch, ck.testvec, ck, ck.params,
                      tv_lo_zero=True)
    return _trlwe.sample_extract(tr, 0)


def bootstrap_without_key_switch_truncated(tlwe_batch, ck: CloudKey):
    """Reference-parity hybrid (vanilla.zig:58-69): lv1 mask truncated to n0."""
    tr = blind_rotate(tlwe_batch, ck.testvec, ck, ck.params,
                      tv_lo_zero=True)
    return _trlwe.sample_extract_lv0_shaped(tr, ck.params.n0, 0)


def bootstrap_with_testvec(tlwe_batch, testvec, ck: CloudKey):
    """Programmable bootstrap core: custom testvec(s), full pipeline.

    testvec: int32 [2, N] shared or [B, 2, N] per-gate.
    """
    tr = blind_rotate(tlwe_batch, testvec, ck, ck.params)
    lv1 = _trlwe.sample_extract(tr, 0)
    return identity_key_switch(lv1, ck.ksk1, ck.params)
