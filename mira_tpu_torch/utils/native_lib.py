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


def _reuse_registers(a_src, b_src):
    """Liveness renaming of the op outputs, in numpy passes: the registers
    mira_tpu's renaming loop assigns, register for register.

    `a_src` / `b_src` give, for each op, the op whose output is its operand
    a / b (-1 for a static slot).  That loop walks the ops with a free list
    (a stack): at op i it pushes the registers of operands whose last use
    is i (a's, then b's; the op computes into a temporary, so its output may
    take one of them), pops one for the output or, with the list empty,
    opens a new register, and pushes the output's register back at once
    when nothing reads it.  Here each op i has four event slots (a dies, b
    dies, the output is assigned, the output dies unread), so the events'
    order is that of their keys.  An assignment opens a register exactly
    when the live values then outnumber every earlier count; every other
    assignment pops, and a pop takes the register of the latest push not
    yet popped, found as brackets are matched: by a stable sort of pushes
    and pops on the stack depth they reach.  Each output then inherits the
    register of the value whose push it popped, resolved by pointer
    jumping.  Returns (each op output's register counted from 0, the number
    of registers)."""
    import numpy as np

    n = len(a_src)
    idx = np.arange(n, dtype=np.int64)
    last = np.full(n, -1, np.int64)
    for src in (a_src, b_src):
        dyn = src >= 0
        np.maximum.at(last, src[dyn], idx[dyn])
    used = last >= 0
    lu = np.where(used, last, 0)
    end_key = np.where(used, 4 * lu + (a_src[lu] != idx), 4 * idx + 3)
    start_key = 4 * idx + 2
    # live values just after each assignment, and whether it opens a register
    live = idx + 1 - np.searchsorted(np.sort(end_key), start_key)
    opened = live > np.maximum.accumulate(np.concatenate(([0], live[:-1])))
    # pushes (every value's death) and pops (the other assignments) in order
    keys = np.concatenate((end_key, start_key[~opened]))
    value = np.concatenate((idx, idx[~opened]))
    push = np.concatenate((np.ones(n, bool), np.zeros(n - opened.sum(), bool)))
    order = np.argsort(keys)  # the keys are distinct
    value, push = value[order], push[order]
    depth = np.cumsum(np.where(push, 1, -1))
    # by depth, and in time order within a depth (a distinct key again)
    by_depth = np.argsort(np.where(push, depth, depth + 1) * len(push)
                          + np.arange(len(push)))
    pops = np.flatnonzero(~push[by_depth])
    parent = idx.copy()
    parent[value[by_depth[pops]]] = value[by_depth[pops - 1]]
    while True:
        up = parent[parent]
        if np.array_equal(up, parent):
            break
        parent = up
    rank = np.cumsum(opened) - 1
    return rank[parent], int(opened.sum())


def _tape_prepare(tape):
    """One-time per tape: liveness-based register renaming + static
    marshaling, in numpy passes.  Cached on the tape object.

    The static slots (inputs and constants) are pinned to registers
    [0, n_static); the op outputs take the registers mira_tpu's renaming
    loop gives them (`_reuse_registers`), so the VM's register file holds
    only the values live at once."""
    import numpy as np

    n_ops = len(tape.op_code)
    n_slots = len(tape.slots)
    code = np.asarray(tape.op_code, np.int32)
    op_out = np.asarray(tape.op_out, np.int64)
    op_of_slot = np.full(n_slots, -1, np.int64)
    op_of_slot[op_out] = np.arange(n_ops)

    static_slots = np.flatnonzero(op_of_slot < 0)
    n_static = len(static_slots)
    op_a = np.asarray(tape.op_a, np.int64)
    op_b = np.asarray(tape.op_b, np.int64)
    out_regs, n_dyn = _reuse_registers(op_of_slot[op_a], op_of_slot[op_b])
    reg_of = np.empty(n_slots, np.int64)
    reg_of[static_slots] = np.arange(n_static)
    reg_of[op_out] = n_static + out_regs
    n_regs = n_static + n_dyn
    if n_regs >= 1 << 31:
        raise ValueError(f"tape of {n_regs} registers: past the VM's int32 indices")

    # the VM caches Barrett contexts keyed by divisor REGISTER; that is only
    # sound when every divisor is a pinned static register (const/input)
    divides = np.isin(code, (3, 4, 5, 6))  # MOD, DIV, INVMOD, ISZM
    assert (op_of_slot[op_b[divides]] < 0).all(), (
        "dynamic divisor breaks the native VM's Barrett cache"
    )
    a_reg = reg_of[op_a].astype(np.int32)
    b_reg = reg_of[op_b].astype(np.int32)
    out_reg = reg_of[op_out].astype(np.int32)

    # emit table: writes whose source slot is an op output, grouped by op
    # in op order (each op's in write order)
    slots_w = np.fromiter((w[2] for w in tape.writes), np.int64, len(tape.writes))
    op_w = op_of_slot[slots_w]
    dyn_writes = np.flatnonzero(op_w >= 0)
    emit_dst = np.argsort(op_w[dyn_writes], kind="stable").astype(np.int32)
    emit_start = np.zeros(n_ops + 1, np.int32)
    emit_start[1:] = np.cumsum(np.bincount(op_w[dyn_writes], minlength=n_ops))
    # const-sourced writes are already in the advice template
    inputs_w = np.flatnonzero((op_w < 0) & (slots_w < tape.num_inputs))
    static_input_writes = list(zip(inputs_w.tolist(), slots_w[inputs_w].tolist()))
    static_slots = static_slots.tolist()

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
