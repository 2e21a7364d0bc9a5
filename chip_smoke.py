#!/usr/bin/env python
"""Drive the TFHE main path once on an NVIDIA GPU and check it exactly.

    python chip_smoke.py          # one card: reference compares, gates, circuits
    python chip_smoke.py --four   # only the batch-sharded path, on four cards

Every phase prints one line of what it found and raises on any mismatch,
so a failed phase exits non-zero.  The arithmetic is exact integer
arithmetic mod 2^32 or 2^64, so every compare has tolerance 0.  The last
line of standard output is one JSON object naming the device, printed
only when every phase passed.  The script refuses to run anywhere but a
GPU: there is no CPU fallback.

The compile cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is
set, and in ``<repo>/.jax_cache`` otherwise.

The phase functions take their parameter sets and sizes as arguments so
that tests/test_chip_smoke.py can run each of them on the CPU at the tiny
test sets.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from zig_tfhe_jax import key as K
from zig_tfhe_jax import params as P
from zig_tfhe_jax import tlwe
from zig_tfhe_jax import trgsw as T
from zig_tfhe_jax.models import circuits, gates as G
from zig_tfhe_jax.models import netlists, scheduler as S
from zig_tfhe_jax.ops import ntt, poly, split_ring as SR
from zig_tfhe_jax.ops.blind_rotate import external_product
from zig_tfhe_jax.ops.blind_rotate_ntt import external_product_ntt
from zig_tfhe_jax.parallel import mesh as M

REPO = os.path.dirname(os.path.abspath(__file__))


def cache_dir() -> str:
    """Persistent compile-cache directory: the env var, else in-checkout."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO, ".jax_cache"))


def _say(line: str) -> None:
    print(line, flush=True)


def _check_equal(name: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    bad = int(np.count_nonzero(got != want))
    if bad:
        raise AssertionError(f"{name}: {bad} of {got.size} values differ")


def _timed(fn, *args):
    """(result, seconds) of fn(*args), waited for with block_until_ready."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Device
# ---------------------------------------------------------------------------


def nvidia_smi() -> str:
    """Card name and power limit, read by a child process that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def phase_device(min_count: int = 1) -> dict:
    """Require a GPU backend with at least ``min_count`` devices."""
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {d0.platform!r}); "
            "this script does not fall back to the CPU")
    if len(devs) < min_count:
        raise SystemExit(f"chip_smoke: needs {min_count} GPUs, JAX found "
                         f"{len(devs)}")
    info = {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}
    _say(f"device: kind={d0.device_kind} count={len(devs)} "
         f"jax={jax.__version__} "
         f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
         f"cache={cache_dir()}")
    return info


# ---------------------------------------------------------------------------
# Reference compares (tolerance 0)
# ---------------------------------------------------------------------------


def _negacyclic_matrix(k: np.ndarray) -> np.ndarray:
    """[N, N] int64 M with (d * k)(X) mod X^N+1 == d @ M."""
    N = k.shape[-1]
    i = np.arange(N)[:, None]
    j = np.arange(N)[None, :]
    return np.where(j >= i, 1, -1) * k[(j - i) % N]


def _wrap32(x: np.ndarray) -> np.ndarray:
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(
        np.int32)


def check_extprod(p32, batch: int, seed: int = 0) -> str:
    """NTT external product == the Toeplitz oracle, drop=0, full gadget."""
    rng = np.random.default_rng(seed)
    L, N = p32.L, p32.N
    trgsw = rng.integers(-2**31, 2**31, (2 * L, 2, N)).astype(np.int32)
    ct = jnp.asarray(rng.integers(-2**31, 2**31, (batch, 2, N))
                     .astype(np.int32))
    plan = ntt.plan_for_params(p32, 0)
    t_ntt = ntt.to_ntt_form(jnp.asarray(trgsw), plan)
    got = jax.jit(external_product_ntt, static_argnums=(2, 3))(
        t_ntt, ct, p32, 0)
    ext = T.to_ext_limbs(jnp.asarray(trgsw), T.N_KLIMBS)
    want = jax.jit(external_product, static_argnums=2)(ext, ct, p32)
    _check_equal("external_product_ntt vs Toeplitz", got, want)
    return (f"extprod_ntt==toeplitz ({p32.name} N={N} "
            f"{plan.n_primes} primes B={batch})")


def check_split_product(p64, seed: int = 1) -> str:
    """Split-ring key fold + pointwise product + inverse == the numpy
    negacyclic product of digit rows against the drop-rounded key, which
    wraps mod 2^64 (the engine's own gadget, drop and plan)."""
    group = ntt.default_group(p64)
    e, levels = ntt.default_engine_gadget(p64, group)
    drop = ntt.default_drop_bits(p64, group, e)
    plan = ntt.plan_for_params(p64, drop, group, levels, bgbit=e,
                               pseudorandom_key=True)
    N, R = p64.N, sum(levels)
    Nh = N // 2
    rng = np.random.default_rng(seed)
    half = 1 << (e - 1)
    d = rng.integers(-half, half, (R, N)).astype(np.int64)
    k = rng.integers(-2**63, 2**63, (R, 2, N), dtype=np.int64)

    kh = SR.split(jnp.asarray(k))                             # [R, 2, 2, Nh]
    res_e = ntt.to_ntt_form(kh[..., 0, :], plan, drop, width=64)
    res_o = ntt.to_ntt_form(kh[..., 1, :], plan, drop, width=64)
    folded = SR.fold_key_split(res_e, res_o, plan)            # [P, 2R, 4, Nh]

    def engine(d_rows, key):
        rows = SR.split(d_rows).reshape(1, 2 * R, Nh)
        d_hat = ntt.ntt_forward(rows, plan, 1, half)
        u = ntt.pointwise_extprod(d_hat, key, plan)
        v = [x.reshape(1, 2, 2, Nh) for x in u]
        return SR.unsplit(ntt.ntt_inverse_to_crt(v, plan, 64)[0])

    got = np.asarray(jax.jit(engine)(jnp.asarray(d), folded))
    got = (got.astype(np.uint64) << np.uint64(drop)).view(np.int64)

    # key rounding as the engine does it, in exact integers
    kr = ((k.astype(object) + (1 << (drop - 1))) >> drop).astype(np.int64)
    want = np.zeros((2, N), np.int64)
    for c in range(2):
        for r in range(R):           # |sum| < R*N*half*2^(64-drop) << 2^63
            want[c] += d[r] @ _negacyclic_matrix(kr[r, c])
    want = (want.astype(np.uint64) << np.uint64(drop)).view(np.int64)
    _check_equal("split-ring product vs numpy", got, want)
    return (f"split_ring==numpy ({p64.name} N={N} {plan.n_primes} primes "
            f"rows={R} drop={drop})")


def check_dot_i8(rows: int, k: int, m: int, seed: int = 2) -> str:
    """The engine's s8 x s8 -> s32 dot == numpy.  |sum| <= k * 2^14 stays
    below 2^53, so the float64 BLAS product is exact."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, (rows, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, m)).astype(np.int8)
    got = jax.jit(ntt._dot_i8)(jnp.asarray(a), jnp.asarray(b))
    want = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.int64)
    _check_equal("_dot_i8 vs numpy", np.asarray(got).astype(np.int64), want)
    return f"dot_i8 [{rows},{k}]x[{k},{m}]==numpy"


def check_s32_dots(batch: int, n: int, seed: int = 3) -> str:
    """The plain s32 dot_generals of encrypt/decrypt and public-key
    encryption wrap exactly mod 2^32."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-2**31, 2**31, (batch, n)).astype(np.int32)
    s = rng.integers(0, 2, n).astype(np.int32)
    signs = rng.integers(-1, 2, (batch, n)).astype(np.int32)
    enc = rng.integers(-2**31, 2**31, (n, n)).astype(np.int32)
    a64, s64 = a.astype(np.int64), s.astype(np.int64)

    got = jax.jit(tlwe._inner_product_binary)(jnp.asarray(a), jnp.asarray(s))
    _check_equal("tlwe inner product", got, _wrap32(a64 @ s64))

    got = jax.jit(poly.negacyclic_polymul_binary)(jnp.asarray(a),
                                                  jnp.asarray(s))
    _check_equal("negacyclic_polymul_binary", got,
                 _wrap32(a64 @ _negacyclic_matrix(s64)))

    def subset_sum(x, y):            # the public-key encryption's contraction
        return jax.lax.dot_general(x, y, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)

    got = jax.jit(subset_sum)(jnp.asarray(signs), jnp.asarray(enc))
    _check_equal("s32 subset-sum dot", got,
                 _wrap32(signs.astype(np.int64) @ enc.astype(np.int64)))
    return f"s32 dots wrap mod 2^32 (B={batch} n={n})"


def phase_reference(p32, p64, batch: int, dot_shape, s32_n: int) -> None:
    t0 = time.perf_counter()
    found = [check_extprod(p32, batch), check_split_product(p64),
             check_dot_i8(*dot_shape), check_s32_dots(batch, s32_n)]
    _say(f"reference: exact, tolerance 0: {'; '.join(found)} "
         f"[{time.perf_counter() - t0:.1f} s]")


# ---------------------------------------------------------------------------
# Keys, gates, circuits
# ---------------------------------------------------------------------------


def keygen(params, seed: int, **kw):
    """(sk, ck, seconds) through the public key API."""
    t0 = time.perf_counter()
    sk = K.SecretKey.generate(jax.random.key(seed), params)
    ck = K.CloudKey.generate(jax.random.key(seed + 1), sk, params, **kw)
    jax.block_until_ready((sk, ck))
    return sk, ck, time.perf_counter() - t0


def phase_keygen(params, seed: int = 0, **kw):
    """Cold and warm keygen; returns the (sk, ck) of the cold call."""
    sk, ck, cold = keygen(params, seed, **kw)
    _, _, warm = keygen(params, seed + 100, **kw)
    _say(f"keygen {params.name}: cold {cold:.2f} s, warm {warm:.2f} s "
         f"(group {ck.bsk_group}, bsk {ck.bsk_ntt.shape} "
         f"{ck.bsk_ntt.dtype})")
    return sk, ck


def scan_steps(ck) -> int:
    """Blind-rotation scan length: one step per group of key bits."""
    return ck.bsk_ntt.shape[0]


def lowering_counts(hlo_text: str) -> dict:
    """Where the compiled step's matmuls went, from optimized HLO text."""
    return {
        "cublas": len(re.findall(r'custom_call_target="__cublas', hlo_text)),
        "triton_fusions": len(re.findall(r'"kind":"__triton', hlo_text)),
        "other_custom_calls": len(re.findall(
            r'custom_call_target="(?!__cublas)', hlo_text)),
        "unfused_dot": len(re.findall(r"= \S+ dot\(", hlo_text)),
        "loop_fusions": len(re.findall(r"kind=kLoop", hlo_text)),
        "input_fusions": len(re.findall(r"kind=kInput", hlo_text)),
    }


def _encrypt_pair(sk, params, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    xa = rng.integers(0, 2, batch).astype(bool)
    xb = rng.integers(0, 2, batch).astype(bool)
    w = params.torus_bits
    alpha = params.tlwe_lv0.alpha
    cta = tlwe.encrypt_bool(jax.random.key(seed), jnp.asarray(xa), alpha,
                            sk.key_lv0, width=w)
    ctb = tlwe.encrypt_bool(jax.random.key(seed + 1), jnp.asarray(xb), alpha,
                            sk.key_lv0, width=w)
    return xa, xb, cta, ctb


def _truth(ids, xa, xb) -> np.ndarray:
    """Plain-boolean gate outputs (the Bristol oracle's gate table)."""
    ops = netlists._PLAIN_OPS
    return np.array([bool(ops[G.GATE_NAMES[int(i)].upper()](int(x), int(y)))
                     for i, x, y in zip(ids, xa, xb)])


def _accuracy(out, sk, want) -> float:
    dec = np.asarray(tlwe.decrypt_bool(out, sk.key_lv0))
    return float(np.mean(dec == want))


def _median_warm(fn, args, iters: int) -> float:
    return float(np.median([_timed(fn, *args)[1] for _ in range(iters)]))


def phase_gates(sk, ck, batch: int, iters: int = 5, seed: int = 10) -> dict:
    """Heterogeneous apply_gates and nand at ``batch`` and at B=1, each
    decrypt checked against the truth table; warm times and the step's
    memory and lowering."""
    params = ck.params
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, len(G.GATE_NAMES), batch).astype(np.int32)
    xa, xb, cta, ctb = _encrypt_pair(sk, params, batch, seed)
    ids_j = jnp.asarray(ids)

    t0 = time.perf_counter()
    compiled = jax.jit(G.apply_gates).lower(ids_j, cta, ctb, ck).compile()
    t_compile = time.perf_counter() - t0
    out, t_first = _timed(compiled, ids_j, cta, ctb, ck)
    acc = _accuracy(out, sk, _truth(ids, xa, xb))

    nand = jax.jit(G.nand)
    out_nand = jax.block_until_ready(nand(cta, ctb, ck))
    acc_nand = _accuracy(out_nand, sk, ~(xa & xb))

    warm = _median_warm(compiled, (ids_j, cta, ctb, ck), iters)

    one = (ids_j[:1], cta[:1], ctb[:1], ck)
    compiled1 = jax.jit(G.apply_gates).lower(*one).compile()
    out1 = jax.block_until_ready(compiled1(*one))
    acc1 = _accuracy(out1, sk, _truth(ids[:1], xa[:1], xb[:1]))
    warm1 = _median_warm(compiled1, one, iters)

    if min(acc, acc_nand, acc1) != 1.0:
        raise AssertionError(
            f"gates {params.name}: accuracy apply_gates={acc} nand="
            f"{acc_nand} B=1={acc1}, must be 1.0")
    steps = scan_steps(ck)
    ma = compiled.memory_analysis()
    mem = ("n/a" if ma is None else
           f"temp={ma.temp_size_in_bytes} arg={ma.argument_size_in_bytes} "
           f"out={ma.output_size_in_bytes}")
    stats = jax.devices()[0].memory_stats() or {}
    res = {
        "accuracy": acc, "compile_s": t_compile, "first_call_s": t_first,
        "warm_s": warm, "warm_b1_s": warm1, "steps": steps,
        "ms_per_step": warm / steps * 1e3,
        "ms_per_step_b1": warm1 / steps * 1e3,
        "lowering": lowering_counts(compiled.as_text()),
    }
    _say(f"gates {params.name}: accuracy 1.0 (apply_gates B={batch}, nand "
         f"B={batch}, B=1); compile {t_compile:.2f} s, first call "
         f"{t_first:.3f} s; warm median of {iters}: B={batch} "
         f"{warm * 1e3:.2f} ms ({batch / warm:.0f} gates/s), B=1 "
         f"{warm1 * 1e3:.2f} ms; {steps} scan steps: "
         f"{res['ms_per_step']:.4f} ms/step at B={batch}, "
         f"{res['ms_per_step_b1']:.4f} ms/step at B=1; step memory {mem}; "
         f"peak_bytes_in_use={stats.get('peak_bytes_in_use', 'n/a')}")
    _say(f"lowering {params.name} gate step: "
         f"{json.dumps(res['lowering'], sort_keys=True)}")
    return res


def phase_adder(sk, ck, a: int = 402, b: int = 304, width: int = 16) -> int:
    """The README quick start: Kogge-Stone addition of two encrypted ints."""
    params = ck.params
    ea = circuits.encrypt_bits(jax.random.key(20), a, width, sk, params)
    eb = circuits.encrypt_bits(jax.random.key(21), b, width, sk, params)
    t0 = time.perf_counter()
    s, _ = circuits.kogge_stone_add(ea, eb, ck)
    got = circuits.decrypt_bits(jax.block_until_ready(s), sk)
    dt = time.perf_counter() - t0
    want = (a + b) % (1 << width)
    if got != want:
        raise AssertionError(f"kogge_stone_add {a}+{b}: got {got}, want "
                             f"{want}")
    _say(f"adder {params.name}: kogge_stone_add {a}+{b} = {got} ({width} "
         f"bits, {dt:.2f} s incl. compile)")
    return got


def phase_bristol(sk, ck, width: int = 64, seed: int = 30) -> int:
    """Bristol width x width multiplier through the native scheduler."""
    params = ck.params
    text = netlists.bristol_multiplier(width)
    plan = S.parse_bristol(text)
    rng = np.random.default_rng(seed)
    a = int(rng.integers(0, 1 << 62)) % (1 << width)
    b = int(rng.integers(0, 1 << 62)) % (1 << width)
    bits = [(a >> i) & 1 for i in range(width)] + \
           [(b >> i) & 1 for i in range(width)]
    plain = netlists.eval_bristol_plain(text, bits)
    if sum(v << i for i, v in enumerate(plain)) != a * b:
        raise AssertionError("plain Bristol oracle disagrees with a*b")
    cts = tlwe.encrypt_bool(jax.random.key(seed), jnp.asarray(bits, bool),
                            params.tlwe_lv0.alpha, sk.key_lv0,
                            width=params.torus_bits)
    out, dt = _timed(S.evaluate, plan, cts, ck)
    got = circuits.decrypt_bits(out, sk)
    if got != a * b:
        raise AssertionError(f"Bristol {width}x{width}: got {got}, want "
                             f"{a * b}")
    _say(f"bristol {params.name}: {width}x{width} product exact "
         f"({plan.n_gates} gates, {plan.n_levels} levels, {dt:.2f} s incl. "
         f"compile)")
    return got


# ---------------------------------------------------------------------------
# Four cards: batch-sharded paths, bit-exact against one card
# ---------------------------------------------------------------------------


def _one_card(ck, ids, cta, ctb, per: int):
    """Single-device outputs on the same inputs, ``per`` lanes per call
    (the same lanes each card gets in the sharded run)."""
    f = jax.jit(G.apply_gates)
    n = ids.shape[0] // per
    return jnp.concatenate([
        f(ids[i * per:(i + 1) * per], cta[i * per:(i + 1) * per],
          ctb[i * per:(i + 1) * per], ck)
        for i in range(n)])


def _sharded_leg(name, run, sk, ck, n_shards: int, per: int, seed: int):
    B = n_shards * per
    rng = np.random.default_rng(seed)
    ids = jnp.asarray(rng.integers(0, len(G.GATE_NAMES), B).astype(np.int32))
    xa, xb, cta, ctb = _encrypt_pair(sk, ck.params, B, seed)
    ref = jax.block_until_ready(_one_card(ck, ids, cta, ctb, per))
    _, t_one = _timed(_one_card, ck, ids, cta, ctb, per)
    out = jax.block_until_ready(run(ids, cta, ctb))
    _, t_shard = _timed(run, ids, cta, ctb)
    _check_equal(f"{name} vs one card", out, ref)
    acc = _accuracy(out, sk, _truth(np.asarray(ids), xa, xb))
    if acc != 1.0:
        raise AssertionError(f"{name}: accuracy {acc}, must be 1.0")
    return (f"{name} B={B} bit-exact vs one card, accuracy 1.0 (warm "
            f"{t_shard * 1e3:.1f} ms sharded, {t_one * 1e3:.1f} ms on one "
            f"card)")


def phase_four(sk32, ck32, sk64, ck64, per32: int, per64: int,
               devices) -> None:
    """shard_map over a 4-way data mesh, the (data 2 x model 2) GSPMD step
    with a model-sharded key switch, and the 64-bit split engine over a
    4-way data mesh — each bit-exact against one card."""
    devices = list(devices)[:4]
    if len(devices) != 4:
        raise SystemExit(f"chip_smoke --four: needs 4 devices, found "
                         f"{len(devices)}")
    mesh4 = M.make_mesh(4, 1, devices)
    mesh22 = M.make_mesh(2, 2, devices)
    found = [
        _sharded_leg(f"shard_map {ck32.params.name} data=4",
                     M.shard_map_gates(mesh4, ck32), sk32, ck32, 4, per32,
                     40),
        _sharded_leg(f"gspmd {ck32.params.name} data=2 model=2",
                     M.gspmd_gates(mesh22, ck32), sk32, ck32, 2, per32, 41),
        _sharded_leg(f"gspmd {ck64.params.name} data=4",
                     M.gspmd_gates(mesh4, ck64), sk64, ck64, 4, per64, 42),
    ]
    _say("four: " + "; ".join(found))


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the batch-sharded path on four cards")
    args = ap.parse_args(argv)

    info = phase_device(4 if args.four else 1)
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_compilation_cache_dir", cache_dir())
    p32, p64 = P.SECURITY_128_BIT, P.SECURITY_128_BIT_T64

    if args.four:
        sk32, ck32, _ = keygen(p32, 0)
        sk64, ck64, _ = keygen(p64, 2, packing_key=False)
        phase_four(sk32, ck32, sk64, ck64, 2048, 512, jax.devices())
    else:
        phase_reference(p32, p64, batch=64, dot_shape=(2048 * 4, 1024, 1024),
                        s32_n=1024)
        sk32, ck32 = phase_keygen(p32, 0)
        phase_gates(sk32, ck32, batch=2048)
        sk64, ck64 = phase_keygen(p64, 2, packing_key=False)
        phase_gates(sk64, ck64, batch=512)
        phase_adder(sk32, ck32)
        phase_bristol(sk32, ck32, width=64)

    _say(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
