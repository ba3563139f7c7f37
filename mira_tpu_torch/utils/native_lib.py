"""Shared ctypes loader for the native runtime library (native/evaluator.cpp).

Exposes the row-VM gate evaluator plus the scalar field kernels
(inner product, constant Montgomery multiply, RLC) used by the CPU
runtime paths — the roles rayon + halo2curves' 64-bit field arithmetic
play for the reference.  Built lazily with g++; callers must handle a
None return (no toolchain).

Copied from mira_tpu/utils/native_lib.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from functools import lru_cache

_NATIVE_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "native"
)
_SRC = os.path.join(_NATIVE_DIR, "evaluator.cpp")
_SO = os.path.join(_NATIVE_DIR, "libmiraeval.so")
_build_lock = threading.Lock()

u64p = ctypes.POINTER(ctypes.c_uint64)
i32p = ctypes.POINTER(ctypes.c_int32)
u32p = ctypes.POINTER(ctypes.c_uint32)


@lru_cache(maxsize=1)
def load():
    with _build_lock:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(
            _SRC
        ):
            try:
                subprocess.run(
                    [
                        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        "-pthread", _SRC, "-o", _SO,
                    ],
                    check=True,
                    capture_output=True,
                )
            except (OSError, subprocess.CalledProcessError):
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
    lib.mira_eval_fold.argtypes = [
        u64p, i32p, ctypes.c_size_t, ctypes.c_size_t,
        u64p, u64p, u64p,
        u64p, ctypes.c_size_t,
        u64p, ctypes.c_size_t,
        ctypes.c_size_t,
        u64p, ctypes.c_int, u64p,
    ]
    lib.mira_eval_fold.restype = None
    lib.mira_inner_product_mont.argtypes = [
        u64p, u64p, u64p, ctypes.c_size_t, ctypes.c_int, u64p,
    ]
    lib.mira_inner_product_mont.restype = None
    lib.mira_mul_const_mont.argtypes = [
        u64p, u64p, u64p, ctypes.c_size_t, ctypes.c_int, u64p,
    ]
    lib.mira_mul_const_mont.restype = None
    lib.mira_rlc_mont.argtypes = [
        u64p, u64p, u64p, u64p, ctypes.c_size_t, ctypes.c_int, u64p,
    ]
    lib.mira_rlc_mont.restype = None
    lib.mira_lincomb_mont.argtypes = [
        u64p, u64p, u64p,
        ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int,
        u64p,
    ]
    lib.mira_lincomb_mont.restype = None
    lib.mira_mul_const_mont16.argtypes = [
        u64p, u32p, u64p, ctypes.c_size_t, ctypes.c_int, u32p,
    ]
    lib.mira_mul_const_mont16.restype = None
    lib.mira_inner_product_mont16.argtypes = [
        u64p, u64p, u32p, ctypes.c_size_t, ctypes.c_int, u64p,
    ]
    lib.mira_inner_product_mont16.restype = None
    return lib


def available() -> bool:
    return load() is not None


# ---------------------------------------------------------------------------
# Witness-tape VM (native/tape_vm.cpp): executes the straight-line
# witness-generation program captured by table/tape.py.  The SSA slot space
# is renamed to a small reusable register file (liveness analysis) so the
# working set stays cache-resident; advice-cell values are emitted inline by
# the VM as 4x64-bit words.

_TAPE_SRC = os.path.join(_NATIVE_DIR, "tape_vm.cpp")
_TAPE_SO = os.path.join(_NATIVE_DIR, "libmiratape.so")

_W = 10  # 640-bit registers, matches tape_vm.cpp


@lru_cache(maxsize=1)
def load_tape_vm():
    with _build_lock:
        if not os.path.exists(_TAPE_SO) or os.path.getmtime(
            _TAPE_SO
        ) < os.path.getmtime(_TAPE_SRC):
            try:
                subprocess.run(
                    [
                        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        _TAPE_SRC, "-o", _TAPE_SO,
                    ],
                    check=True,
                    capture_output=True,
                )
            except (OSError, subprocess.CalledProcessError):
                return None
        try:
            lib = ctypes.CDLL(_TAPE_SO)
        except OSError:
            return None
    lib.mira_tape_execute.argtypes = [
        i32p, i32p, i32p, i32p, ctypes.c_int64,
        u64p, i32p, ctypes.c_int64, ctypes.c_int64,
        i32p, i32p, u64p,
    ]
    lib.mira_tape_execute.restype = ctypes.c_int
    return lib


def tape_vm_available() -> bool:
    return load_tape_vm() is not None


def _tape_prepare(tape):
    """One-time per tape: liveness-based register renaming + static
    marshaling.  Cached on the tape object."""
    import numpy as np

    n_ops = len(tape.op_code)
    n_slots = len(tape.slots)
    op_of_slot = [-1] * n_slots
    for i, s in enumerate(tape.op_out):
        op_of_slot[s] = i

    # static slots (inputs + consts) pinned to registers [0, n_static)
    static_slots = [s for s in range(n_slots) if op_of_slot[s] < 0]
    n_static = len(static_slots)
    reg_of = [-1] * n_slots
    for r, s in enumerate(static_slots):
        reg_of[s] = r

    last_use = [-1] * n_slots
    for i in range(n_ops):
        last_use[tape.op_a[i]] = i
        last_use[tape.op_b[i]] = i

    # the VM caches Barrett contexts keyed by divisor REGISTER; that is only
    # sound when every divisor is a pinned static register (const/input)
    for i, c in enumerate(tape.op_code):
        if c in (3, 4, 5, 6):  # MOD, DIV, INVMOD, ISZM
            assert op_of_slot[tape.op_b[i]] < 0, (
                "dynamic divisor breaks the native VM's Barrett cache"
            )

    a_reg = np.empty(n_ops, np.int32)
    b_reg = np.empty(n_ops, np.int32)
    out_reg = np.empty(n_ops, np.int32)
    free: list = []
    n_regs = n_static
    OUT, A, B = tape.op_out, tape.op_a, tape.op_b
    for i in range(n_ops):
        sa, sb, so = A[i], B[i], OUT[i]
        a_reg[i] = reg_of[sa]
        b_reg[i] = reg_of[sb]
        # free dying operand registers (op computes into a temp, so the out
        # register may alias an operand)
        if op_of_slot[sa] >= 0 and last_use[sa] == i:
            free.append(reg_of[sa])
        if op_of_slot[sb] >= 0 and last_use[sb] == i and sb != sa:
            free.append(reg_of[sb])
        if free:
            r = free.pop()
        else:
            r = n_regs
            n_regs += 1
        reg_of[so] = r
        out_reg[i] = r
        if last_use[so] < 0:  # emitted only (or dead): free immediately
            free.append(r)

    # emit table: writes whose source slot is an op output
    emits_per_op: dict = {}
    dyn_writes = []  # indices into tape.writes
    static_input_writes = []  # (write_idx, slot) with slot an input
    for w_idx, (_c, _r, slot) in enumerate(tape.writes):
        op_i = op_of_slot[slot]
        if op_i >= 0:
            emits_per_op.setdefault(op_i, []).append(len(dyn_writes))
            dyn_writes.append(w_idx)
        elif slot < tape.num_inputs:
            static_input_writes.append((w_idx, slot))
        # const-sourced writes are already in the advice template

    emit_start = np.zeros(n_ops + 1, np.int32)
    emit_dst = np.empty(len(dyn_writes), np.int32)
    pos = 0
    for i in range(n_ops):
        emit_start[i] = pos
        for d in emits_per_op.get(i, ()):
            emit_dst[pos] = d
            pos += 1
    emit_start[n_ops] = pos

    # static register values: consts marshaled once; inputs patched per run
    static_mag = np.zeros((n_static, _W), np.uint64)
    static_hdr = np.zeros(n_static, np.int32)
    input_reg = [-1] * tape.num_inputs
    for r, s in enumerate(static_slots):
        if s < tape.num_inputs:
            input_reg[s] = r
        else:
            v = tape.slots[s]
            assert v >= 0 or True
            neg = v < 0
            mag = -v if neg else v
            b = mag.to_bytes(_W * 8, "little")
            static_mag[r] = np.frombuffer(b, np.uint64)
            ln = (mag.bit_length() + 63) // 64
            static_hdr[r] = -ln if neg else ln

    prep = {
        "code": np.asarray(tape.op_code, np.int32),
        "a_reg": a_reg,
        "b_reg": b_reg,
        "out_reg": out_reg,
        "n_regs": n_regs,
        "n_static": n_static,
        "static_mag": static_mag,
        "static_hdr": static_hdr,
        "input_reg": input_reg,
        "emit_start": emit_start,
        "emit_dst": emit_dst,
        "dyn_writes": dyn_writes,
        "static_input_writes": static_input_writes,
    }
    tape._native_prep = prep
    return prep


def tape_vm_run_raw(tape, inputs):
    """Run the native VM; returns (out_buf (nwrites, 4) uint64, prep) with
    out_buf rows aligned with prep['dyn_writes'].  None when unavailable."""
    import numpy as np

    lib = load_tape_vm()
    if lib is None:
        return None
    prep = getattr(tape, "_native_prep", None)
    if prep is None:
        prep = _tape_prepare(tape)

    mag = prep["static_mag"].copy()
    hdr = prep["static_hdr"].copy()
    for s, v in enumerate(inputs):
        r = prep["input_reg"][s]
        v = int(v)
        assert v >= 0, "negative tape input"
        mag[r] = np.frombuffer(v.to_bytes(_W * 8, "little"), np.uint64)
        hdr[r] = (v.bit_length() + 63) // 64

    n_ops = len(prep["code"])
    out_buf = np.zeros((len(prep["dyn_writes"]), 4), np.uint64)
    rc = lib.mira_tape_execute(
        prep["code"].ctypes.data_as(i32p),
        prep["a_reg"].ctypes.data_as(i32p),
        prep["b_reg"].ctypes.data_as(i32p),
        prep["out_reg"].ctypes.data_as(i32p),
        n_ops,
        mag.ctypes.data_as(u64p),
        hdr.ctypes.data_as(i32p),
        prep["n_static"],
        prep["n_regs"],
        prep["emit_start"].ctypes.data_as(i32p),
        prep["emit_dst"].ctypes.data_as(i32p),
        out_buf.ctypes.data_as(u64p),
    )
    if rc != 0:
        raise RuntimeError(f"tape VM error {rc}")
    return out_buf, prep


def tape_vm_write_values(tape, inputs):
    """Run the native VM; returns python-int values aligned with
    prep['dyn_writes'] (the unpacked twin of tape_vm_run_raw)."""
    out_buf, prep = tape_vm_run_raw(tape, inputs)
    raw = out_buf.tobytes()
    vals = [
        int.from_bytes(raw[i * 32 : (i + 1) * 32], "little")
        for i in range(len(prep["dyn_writes"]))
    ]
    return vals, prep


# ---------------------------------------------------------------------------
# BN254 pairing + Gt arithmetic (native/pairing.cpp) — used by the real-proof
# Gt cross terms and the pairing decider (snark/groth16.py); the host python
# pairing costs ~1s each (its final exponentiation dominates).

_PAIR_SRC = os.path.join(_NATIVE_DIR, "pairing.cpp")
_PAIR_SO = os.path.join(_NATIVE_DIR, "libmirapairing.so")

u8p = ctypes.POINTER(ctypes.c_uint8)


@lru_cache(maxsize=1)
def load_pairing():
    with _build_lock:
        if not os.path.exists(_PAIR_SO) or os.path.getmtime(
            _PAIR_SO
        ) < os.path.getmtime(_PAIR_SRC):
            try:
                subprocess.run(
                    [
                        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        _PAIR_SRC, "-o", _PAIR_SO,
                    ],
                    check=True,
                    capture_output=True,
                )
            except (OSError, subprocess.CalledProcessError):
                return None
        try:
            lib = ctypes.CDLL(_PAIR_SO)
        except OSError:
            return None
    lib.mira_pairing.argtypes = [
        u64p, u64p, u64p, u64p, u64p, u64p, u8p, ctypes.c_int64, u64p,
    ]
    lib.mira_pairing.restype = ctypes.c_int
    lib.mira_gt_mul.argtypes = [u64p, u64p, u64p]
    lib.mira_gt_mul.restype = ctypes.c_int
    lib.mira_gt_pow.argtypes = [u64p, u8p, ctypes.c_int64, u64p]
    lib.mira_gt_pow.restype = ctypes.c_int
    return lib


def pairing_available() -> bool:
    return load_pairing() is not None
