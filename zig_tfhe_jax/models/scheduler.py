"""Circuit scheduler bindings + batched level evaluator.

The native C++ scheduler (native/circuit/scheduler.cc) levels a boolean
circuit DAG and allocates wire slots; this module binds it via ctypes and
evaluates the resulting plan on the device: every level runs as ONE batched
heterogeneous bootstrap (models/gates.py:apply_gates) over a fixed
int32[n_slots, n0+1] ciphertext arena.

Level widths are padded to powers of two so jit compiles are reused across
levels (a padded lane evaluates NAND(s0,s0) into a trash slot).

No reference analog: zig-tfhe evaluates circuits gate-by-gate in user code
(examples/add_two_numbers.zig:66-70).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from zig_tfhe_jax.key import CloudKey
from zig_tfhe_jax.models import gates as G

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, os.pardir, "native", "circuit")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcircuit_scheduler.so")

# op codes >= 100 (must match scheduler.cc enum Op)
OP_NOT, OP_COPY, OP_CONST0, OP_CONST1, OP_MUX = 100, 101, 102, 103, 104

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # make is incremental (mtime): a fresh checkout builds, an up-to-date
    # .so is a no-op, and a stale .so (older than scheduler.cc) rebuilds.
    # A failed build raises even when an old .so exists, so what loads is
    # always built from the committed scheduler.cc.
    proc = subprocess.run(["make", "-C", _NATIVE_DIR],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the native circuit scheduler failed (needs make "
            f"and a C++17 compiler):\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(_LIB_PATH)
    lib.tfhe_circuit_new.restype = ctypes.c_void_p
    lib.tfhe_circuit_parse_bristol.restype = ctypes.c_void_p
    lib.tfhe_circuit_parse_bristol.argtypes = [ctypes.c_char_p]
    lib.tfhe_circuit_error.restype = ctypes.c_char_p
    lib.tfhe_circuit_error.argtypes = [ctypes.c_void_p]
    lib.tfhe_circuit_add_wire.argtypes = [ctypes.c_void_p]
    lib.tfhe_circuit_add_gate.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 4
    lib.tfhe_circuit_mark_input.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.tfhe_circuit_mark_output.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for f in ("tfhe_circuit_n_gates", "tfhe_circuit_n_inputs",
              "tfhe_circuit_n_outputs"):
        getattr(lib, f).argtypes = [ctypes.c_void_p]
        getattr(lib, f).restype = ctypes.c_int32
    lib.tfhe_schedule.restype = ctypes.c_void_p
    lib.tfhe_schedule.argtypes = [ctypes.c_void_p]
    lib.tfhe_schedule_capped.restype = ctypes.c_void_p
    lib.tfhe_schedule_capped.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.tfhe_plan_error.restype = ctypes.c_char_p
    lib.tfhe_plan_error.argtypes = [ctypes.c_void_p]
    for f in ("tfhe_plan_n_levels", "tfhe_plan_n_gates", "tfhe_plan_n_slots",
              "tfhe_plan_n_inputs", "tfhe_plan_n_outputs"):
        getattr(lib, f).argtypes = [ctypes.c_void_p]
        getattr(lib, f).restype = ctypes.c_int32
    lib.tfhe_plan_level_offsets.restype = ctypes.POINTER(ctypes.c_int32)
    lib.tfhe_plan_level_offsets.argtypes = [ctypes.c_void_p]
    for f in ("tfhe_plan_gates", "tfhe_plan_input_slots",
              "tfhe_plan_output_slots"):
        getattr(lib, f).argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.tfhe_circuit_free.argtypes = [ctypes.c_void_p]
    lib.tfhe_plan_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


@dataclass
class Plan:
    """A leveled, slot-allocated evaluation plan."""

    levels: list          # list of int32 np arrays [k, 5]: op, s0, s1, s2, sout
    n_slots: int
    input_slots: np.ndarray
    output_slots: np.ndarray

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def n_gates(self) -> int:
        return sum(len(l) for l in self.levels)


class Circuit:
    """Python-side circuit builder over the native graph."""

    def __init__(self):
        self._lib = _load()
        self._c = self._lib.tfhe_circuit_new()

    def __del__(self):
        if getattr(self, "_c", None):
            self._lib.tfhe_circuit_free(self._c)
            self._c = None

    def input(self) -> int:
        w = self._lib.tfhe_circuit_add_wire(self._c)
        self._lib.tfhe_circuit_mark_input(self._c, w)
        return w

    def gate(self, name: str, a: int, b: int) -> int:
        return self._lib.tfhe_circuit_add_gate(self._c, G.GATE_IDS[name], a, b, -1)

    def not_(self, a: int) -> int:
        return self._lib.tfhe_circuit_add_gate(self._c, OP_NOT, a, -1, -1)

    def copy(self, a: int) -> int:
        return self._lib.tfhe_circuit_add_gate(self._c, OP_COPY, a, -1, -1)

    def const(self, value: bool) -> int:
        return self._lib.tfhe_circuit_add_gate(
            self._c, OP_CONST1 if value else OP_CONST0, -1, -1, -1)

    def mux(self, sel: int, t: int, f: int) -> int:
        """(sel ? t : f)."""
        return self._lib.tfhe_circuit_add_gate(self._c, OP_MUX, sel, t, f)

    def output(self, w: int) -> None:
        self._lib.tfhe_circuit_mark_output(self._c, w)

    def schedule(self) -> Plan:
        return _schedule_circuit_handle(self._lib, self._c)


def _plan_from_native(lib, p) -> Plan:
    """Construct a COMPLETE Plan from a native plan handle (the plan owns
    its input/output slot arrays via tfhe_plan_n_inputs/n_outputs)."""
    err = lib.tfhe_plan_error(p).decode()
    if err:
        lib.tfhe_plan_free(p)
        raise ValueError(f"schedule error: {err}")
    n_levels = lib.tfhe_plan_n_levels(p)
    n_gates = lib.tfhe_plan_n_gates(p)
    offs = np.ctypeslib.as_array(lib.tfhe_plan_level_offsets(p),
                                 shape=(n_levels + 1,)).copy()
    gates = np.zeros((n_gates, 5), np.int32)
    if n_gates:
        lib.tfhe_plan_gates(p, gates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    n_slots = lib.tfhe_plan_n_slots(p)
    ins = np.zeros(lib.tfhe_plan_n_inputs(p), np.int32)
    outs = np.zeros(lib.tfhe_plan_n_outputs(p), np.int32)
    if len(ins):
        lib.tfhe_plan_input_slots(
            p, ins.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if len(outs):
        lib.tfhe_plan_output_slots(
            p, outs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return Plan(levels=[gates[offs[i]:offs[i + 1]] for i in range(n_levels)],
                n_slots=n_slots,
                input_slots=ins,
                output_slots=outs)


def parse_bristol(text: str) -> Plan:
    """Parse + schedule a Bristol-fashion circuit."""
    lib = _load()
    c = lib.tfhe_circuit_parse_bristol(text.encode())
    try:
        err = lib.tfhe_circuit_error(c).decode()
        if err:
            raise ValueError(f"parse error: {err}")
        return _schedule_circuit_handle(lib, c)
    finally:
        lib.tfhe_circuit_free(c)


def _super_level_cap() -> int:
    """Rotation-lane budget per super-level (native list scheduler).

    Default: the 2048-lane throughput knee (hand-set; not yet measured
    on the GPU).  ASAP levels' ragged tails (a 7-gate level dispatches a
    7-lane rotation whose wall-clock is close to a 2048-lane one) waste
    rotations; slack-priority packing tops narrow levels up with
    deferred gates from wide ones, pushing the dispatch count toward
    the critical-path depth.  ZTFHE_SUPER_LEVEL overrides; 0 restores
    plain ASAP leveling.  Read at schedule time (the resulting Plan
    bakes it in).
    """
    return int(os.environ.get("ZTFHE_SUPER_LEVEL", "2048"))


def _schedule_circuit_handle(lib, c) -> Plan:
    p = lib.tfhe_schedule_capped(c, _super_level_cap())
    plan = _plan_from_native(lib, p)
    lib.tfhe_plan_free(p)
    _check_no_unresolved_slots(plan)
    return plan


def _check_no_unresolved_slots(plan: Plan) -> None:
    """The native side errors on unproduced wires, so -1 slots should be
    impossible in REQUIRED operand positions; check anyway — a -1 reaching
    a JAX gather would WRAP to the last arena row and silently return
    garbage ciphertexts.  (Unused operand positions are legitimately -1:
    s1/s2 of NOT, s2 of two-input gates, all inputs of CONST.)"""
    if (plan.output_slots < 0).any():
        raise ValueError("plan has outputs with unresolved (-1) arena slots")
    for lvl in plan.levels:
        op = lvl[:, 0]
        need_s0 = (op < 100) | (op == OP_NOT) | (op == OP_COPY) | (op == OP_MUX)
        need_s1 = (op < 100) | (op == OP_MUX)
        need_s2 = op == OP_MUX
        bad = ((need_s0 & (lvl[:, 1] < 0)) | (need_s1 & (lvl[:, 2] < 0))
               | (need_s2 & (lvl[:, 3] < 0)) | (lvl[:, 4] < 0))
        if bad.any():
            raise ValueError("plan contains unresolved (-1) arena slots")


def _pad_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pad_bucket(n: int) -> int:
    """Gate-lane padding bucket: pow2 up to 256, multiples of 128 above.

    Pure pow2 padding costs +21% lane waste on the Bristol 64x64 plan
    (1073-gate levels pad to 2048), counted from the plan's level widths;
    multiple-of-128 buckets cut that to +8% at ~13 distinct compile
    signatures.  Below 256 the
    pow2 grid keeps the signature count tiny where waste is cheap.
    """
    return _pad_pow2(n) if n <= 256 else -(-n // 128) * 128


def _pack_level(lvl: np.ndarray, trash: int) -> dict:
    """Pad one level's lanes to power-of-two widths (trash-slot lanes) so
    the jitted level step's compile is shared across levels with the same
    padded signature.  Padding lanes read slot 0 and write the trash row
    (slot 0 always holds a valid ciphertext: zeros decrypt fine and padded
    gate lanes' outputs are never read)."""
    out = {}
    two = lvl[lvl[:, 0] < 100]
    k = _pad_bucket(len(two)) if len(two) else 0
    ids = np.zeros(k, np.int32)
    s0 = np.zeros(k, np.int32)
    s1 = np.zeros(k, np.int32)
    sout = np.full(k, trash, np.int32)
    ids[: len(two)] = two[:, 0]
    s0[: len(two)] = two[:, 1]
    s1[: len(two)] = two[:, 2]
    sout[: len(two)] = two[:, 4]
    out["two"] = (ids, s0, s1, sout)
    mux = lvl[lvl[:, 0] == OP_MUX]
    k = _pad_pow2(len(mux)) if len(mux) else 0
    sel = np.zeros(k, np.int32)
    tv = np.zeros(k, np.int32)
    fv = np.zeros(k, np.int32)
    sout = np.full(k, trash, np.int32)
    sel[: len(mux)] = mux[:, 1]
    tv[: len(mux)] = mux[:, 2]
    fv[: len(mux)] = mux[:, 3]
    sout[: len(mux)] = mux[:, 4]
    out["mux"] = (sel, tv, fv, sout)
    for name, cop in (("not", OP_NOT), ("copy", OP_COPY)):
        un = lvl[lvl[:, 0] == cop]
        k = _pad_pow2(len(un)) if len(un) else 0
        src = np.zeros(k, np.int32)
        sout = np.full(k, trash, np.int32)
        src[: len(un)] = un[:, 1]
        sout[: len(un)] = un[:, 4]
        out[name] = (src, sout)
    for name, cop in (("c0", OP_CONST0), ("c1", OP_CONST1)):
        consts = lvl[lvl[:, 0] == cop]
        k = _pad_pow2(len(consts)) if len(consts) else 0
        sout = np.full(k, trash, np.int32)
        sout[: len(consts)] = consts[:, 4]
        out[name] = (sout,)
    return out


_EMPTY_I32 = np.zeros(0, np.int32)


def _chunk_level(g: dict, B: int, params=None) -> list[dict]:
    """Split one packed level into knee-sized dispatch chunks.

    Gates and MUXes within a level are independent, so any partition is
    valid; the bootstrap-free groups (not/copy/const) ride the first
    chunk.  Chunk width is pow2 (so it divides every pow2-padded group
    width) and targets _level_chunk_lanes() total rotation lanes at
    batch B — every blind rotation then runs at the knee batch instead
    of one past-the-knee giant.
    """
    chunk = _level_chunk_lanes(params)
    if not chunk:
        return [g]
    chunk_k = _pad_pow2(max(1, chunk // B))
    if chunk_k * B > chunk:
        chunk_k //= 2
    chunk_k = max(1, chunk_k)
    two_k, mux_k = g["two"][0].shape[0], g["mux"][0].shape[0]
    if two_k <= chunk_k and mux_k <= chunk_k:
        return [g]
    base = {"two": tuple(a[:0] for a in g["two"]),
            "mux": tuple(a[:0] for a in g["mux"]),
            "not": (_EMPTY_I32, _EMPTY_I32), "copy": (_EMPTY_I32, _EMPTY_I32),
            "c0": (_EMPTY_I32,), "c1": (_EMPTY_I32,)}
    chunks = []
    for i in range(0, max(two_k, chunk_k), chunk_k):
        if i >= two_k:
            break
        c = dict(base)
        c["two"] = tuple(a[i:i + chunk_k] for a in g["two"])
        chunks.append(c)
    for i in range(0, max(mux_k, chunk_k), chunk_k):
        if i >= mux_k:
            break
        c = dict(base)
        c["mux"] = tuple(a[i:i + chunk_k] for a in g["mux"])
        chunks.append(c)
    if not chunks:
        chunks.append(dict(base))
    for name in ("not", "copy", "c0", "c1"):
        chunks[0][name] = g[name]
    return chunks


def _level_chunk_lanes(params=None) -> int:
    """Blind-rotation lanes per dispatch (env knob ZTFHE_LEVEL_CHUNK,
    read when the plan's levels are packed; 0 disables chunking).

    The default is the engine's throughput knee: 2048 lanes on the
    32-bit gate path, 512 on the SPLIT engine (hand-set; not yet
    measured on the GPU).  Wide circuit levels (k * B lanes — a
    4097-gate level pads to 8192, x B clients) would otherwise run one
    giant rotation deep past the knee.  Chunks dispatch as separate
    _run_level calls so each compiled graph stays one-rotation sized
    and the compile cache is shared across chunks and levels.
    """
    env = os.environ.get("ZTFHE_LEVEL_CHUNK")
    if env is not None:
        return int(env)
    if params is not None and params.split_ring:
        return 512
    return 2048


def _level_body(arena, ck, two, mux, nots, copies, c0, c1):
    """One level's arena update (shared by the per-level dispatch and the
    scan-run body).

    arena: carrier [n_slots+1, B, n0+1] (last row is trash).  Lane
    groups are the padded index tuples from _pack_level.  Group presence
    is a static shape property, so empty groups trace away and the
    compile is keyed on the padded-width signature only.
    """
    n0 = arena.shape[-1] - 1
    B = arena.shape[1]

    def flat(g):                              # [k, B, n0+1] -> [k*B, n0+1]
        return g.reshape(-1, n0 + 1)

    ids, s0, s1, sout = two
    if ids.shape[0]:
        out = G.apply_gates(jnp.repeat(ids, B), flat(arena[s0]),
                            flat(arena[s1]), ck)
        arena = arena.at[sout].set(out.reshape(-1, B, n0 + 1))
    sel, tv, fv, sout = mux
    if sel.shape[0]:
        out = G.mux(flat(arena[sel]), flat(arena[tv]), flat(arena[fv]), ck)
        arena = arena.at[sout].set(out.reshape(-1, B, n0 + 1))
    src, sout = nots
    if src.shape[0]:
        arena = arena.at[sout].set(-arena[src])
    src, sout = copies
    if src.shape[0]:
        arena = arena.at[sout].set(arena[src])
    for val, (sout,) in ((False, c0), (True, c1)):
        if sout.shape[0]:
            cts = G.constant(val, ck.params, batch=(sout.shape[0], B))
            arena = arena.at[sout].set(cts)
    return arena


@functools.partial(jax.jit, donate_argnums=(0,))
def _run_level(arena, ck, two, mux, nots, copies, c0, c1):
    """One level chunk as ONE jitted dispatch over the slot arena."""
    return _level_body(arena, ck, two, mux, nots, copies, c0, c1)


@functools.partial(jax.jit, donate_argnums=(0,))
def _run_levels_scan(arena, ck, two, nots, copies, c0, c1):
    """A RUN of consecutive equal-width levels as ONE dispatch.

    The Bristol 64x64 tail is ~30 narrow levels; dispatched one by one,
    each pays a per-dispatch cost on a rotation far below the
    throughput knee.  Levels whose padded group widths agree stack on a
    leading L axis and run as ONE ``lax.scan`` dispatch (the level
    index arrays are the xs; the arena is the carry), so a whole
    equal-width run pays the dispatch cost once.  Compile is keyed on
    the (L, widths, B) signature — the bucket grid (_pad_bucket) keeps
    the signature count small.  MUX levels stay on the per-level path
    (rare; they would double the scan body for every run).
    """
    def body(ar, xs):
        t, n, cp, z0, z1 = xs
        mux = (jnp.zeros((0,), jnp.int32),) * 4
        return _level_body(ar, ck, t, mux, n, cp, z0, z1), None

    arena, _ = jax.lax.scan(body, arena, (two, nots, copies, c0, c1))
    return arena


_FREE_CAP = 32    # not/copy lanes a scan-run level may carry (padded width)
_CONST_CAP = 16   # const lanes likewise


def _coalesce_runs(units: list[dict]) -> list[list[dict]]:
    """Group consecutive dispatch units into scan-runs.

    Units join a run when they have NO mux lanes, EQUAL two-gate widths,
    and free-op groups within the fixed scan caps (padded there).  Runs
    of length >= 2 dispatch via _run_levels_scan; singletons keep the
    per-level path.  Correctness: scanned levels execute in the same
    order with the same arena semantics — only the dispatch granularity
    changes.
    """
    runs: list[list[dict]] = []
    for g in units:
        ok = (g["mux"][0].shape[0] == 0
              and g["not"][0].shape[0] <= _FREE_CAP
              and g["copy"][0].shape[0] <= _FREE_CAP
              and g["c0"][0].shape[0] <= _CONST_CAP
              and g["c1"][0].shape[0] <= _CONST_CAP)
        if (ok and runs
                and runs[-1][0]["two"][0].shape[0] == g["two"][0].shape[0]
                and runs[-1][0].get("_scan_ok")):
            runs[-1].append(dict(g, _scan_ok=True))
        else:
            runs.append([dict(g, _scan_ok=ok)])
    return runs


def _stack_run(run: list[dict], trash: int):
    """Stack a run's units into [L, width] xs arrays (frees padded to the
    scan caps: pad lanes read slot 0 and write the trash row)."""
    def pad_to(a, k, fill):
        out = np.full(k, fill, np.int32)
        out[: len(a)] = a
        return out

    two = tuple(jnp.asarray(np.stack([u["two"][i] for u in run]))
                for i in range(4))
    frees = {}
    for name, cap in (("not", _FREE_CAP), ("copy", _FREE_CAP)):
        src = np.stack([pad_to(u[name][0], cap, 0) for u in run])
        out = np.stack([pad_to(u[name][1], cap, trash) for u in run])
        frees[name] = (jnp.asarray(src), jnp.asarray(out))
    for name in ("c0", "c1"):
        out = np.stack([pad_to(u[name][0], _CONST_CAP, trash) for u in run])
        frees[name] = (jnp.asarray(out),)
    return two, frees["not"], frees["copy"], frees["c0"], frees["c1"]


def evaluate(plan: Plan, input_cts, ck: CloudKey):
    """Evaluate a scheduled circuit over encrypted inputs.

    input_cts: carrier [n_inputs, n0+1] in plan input order (int32 on
    32-bit sets, int64 on 64-bit), or [n_inputs, B, n0+1] to run the
    SAME plan over a batch of B client input sets (the serving mode:
    every level's gates fuse across the whole batch, so per-client cost
    rides the batched-bootstrap throughput curve instead of the
    circuit's own width).
    Returns carrier [n_outputs, n0+1] (or [n_outputs, B, n0+1]).

    Each level runs as a handful of jitted dispatches (_run_level): its
    two-input gates as apply_gates batches, MUX lanes as batched
    2-rotation MUXes, NOT/COPY/CONST as vector ops — padded to powers of
    two so compiles are shared across levels with equal signatures, and
    chunked to the engine's throughput knee (_chunk_level;
    ZTFHE_LEVEL_CHUNK overrides) so wide levels and client batches never
    run one giant past-the-knee rotation.
    """
    from zig_tfhe_jax.utils.torus import carrier_dtype

    n0 = ck.params.n0
    input_cts = jnp.asarray(input_cts)
    batched = input_cts.ndim == 3
    B = input_cts.shape[1] if batched else 1
    if not batched:
        input_cts = input_cts[:, None]
    # arena [n_slots+1, B, n0+1]; slot n_slots is the trash row.  The
    # carrier dtype follows the parameter set (int64 on 64-bit-torus
    # sets) — an int32 arena would silently downcast 64-bit inputs at
    # .at[].set() and die mid-circuit with blind_rotate's width error
    # (ADVICE r4 #1); gates/mux/constant are already width-general.
    arena = jnp.zeros((plan.n_slots + 1, B, n0 + 1),
                      carrier_dtype(ck.params.torus_bits))
    trash = plan.n_slots
    arena = arena.at[jnp.asarray(plan.input_slots)].set(input_cts)

    units = [g for lvl in plan.levels
             for g in _chunk_level(_pack_level(lvl, trash), B, ck.params)]
    for run in _coalesce_runs(units):
        if len(run) >= 2:
            two, nots, copies, c0, c1 = _stack_run(run, trash)
            arena = _run_levels_scan(arena, ck, two, nots, copies, c0, c1)
            continue
        g = run[0]
        arena = _run_level(
            arena, ck,
            tuple(jnp.asarray(a) for a in g["two"]),
            tuple(jnp.asarray(a) for a in g["mux"]),
            tuple(jnp.asarray(a) for a in g["not"]),
            tuple(jnp.asarray(a) for a in g["copy"]),
            tuple(jnp.asarray(a) for a in g["c0"]),
            tuple(jnp.asarray(a) for a in g["c1"]))

    outs = arena[jnp.asarray(plan.output_slots)]
    return outs if batched else outs[:, 0]


def schedule(circuit: Circuit) -> Plan:
    """Schedule a built circuit (leveling + slot allocation)."""
    return circuit.schedule()
