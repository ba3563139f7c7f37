"""ctypes wrapper for native/keygen.cpp — threaded commitment-key setup.

The reference parallelizes generator derivation with rayon
(src/commitment.rs:52-76: Shake256 XOF -> 32 bytes/point ->
hash_to_curve).  This wrapper reproduces the exact python svdw.py pipeline
(same DST, same expand_message_xmd, same SVDW constants) in C++ threads —
~3 orders of magnitude over the python-int path, making real (binding)
keys at k>=20 feasible.  Bit-parity with the python path is asserted in
tests/test_commitment.py.

Copied from mira_tpu/ops/native_keygen.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from functools import lru_cache

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SRC = os.path.join(_NATIVE_DIR, "keygen.cpp")
_SO = os.path.join(_NATIVE_DIR, "libmirakeygen.so")
_build_lock = threading.Lock()

u64p = ctypes.POINTER(ctypes.c_uint64)
u8p = ctypes.POINTER(ctypes.c_uint8)


@lru_cache(maxsize=1)
def load():
    with _build_lock:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
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
    lib.mira_keygen.argtypes = [
        u8p, ctypes.c_size_t, ctypes.c_size_t,
        u64p, u8p, u8p, ctypes.c_int,
        u64p, u8p, ctypes.c_size_t,
        u64p, ctypes.c_int,
    ]
    lib.mira_keygen.restype = None
    lib.mira_on_curve_check.argtypes = [
        u64p, ctypes.c_size_t, u64p, u64p, ctypes.c_int,
    ]
    lib.mira_on_curve_check.restype = ctypes.c_size_t
    return lib


def available() -> bool:
    return load() is not None


def _int_to_u64x4(v: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(32, "little"), dtype="<u8").copy()


@lru_cache(maxsize=None)
def _field_pack(p: int):
    """fparams u64[17] + Tonelli-Shanks byte strings for modulus p."""
    n0inv = (-pow(p, -1, 1 << 64)) & ((1 << 64) - 1)
    r = 1 << 256
    r2 = (r * r) % p
    one_m = r % p
    # 2-adicity
    s = 0
    q = p - 1
    while q % 2 == 0:
        q //= 2
        s += 1
    q12 = (q - 1) // 2
    # smallest quadratic non-residue
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    c_init_mont = (pow(z, q, p) * r) % p
    fparams = np.concatenate(
        [
            _int_to_u64x4(p),
            np.array([n0inv], dtype="<u8"),
            _int_to_u64x4(r2),
            _int_to_u64x4(one_m),
            _int_to_u64x4(c_init_mont),
        ]
    )
    q_bytes = np.frombuffer(q.to_bytes(32, "little"), dtype=np.uint8).copy()
    q12_bytes = np.frombuffer(q12.to_bytes(32, "little"), dtype=np.uint8).copy()
    return fparams, q_bytes, q12_bytes, s


def keygen_native(curve, n: int, label: bytes, nthreads: int = 0):
    """Derive n generators; returns (n, 2, 4) uint64 raw affine coords or None."""
    lib = load()
    if lib is None:
        return None
    from ..curves.svdw import CURVE_IDS, svdw_constants

    p = curve.base_modulus
    fparams, q_bytes, q12_bytes, s = _field_pack(p)
    Z, c1, c2, c3, c4 = svdw_constants(p, 0, curve.b)
    svdw = np.concatenate(
        [_int_to_u64x4(v) for v in (Z, c1, c2, c3, c4, curve.b)]
    )
    dst = f"from_uniform_bytes-{CURVE_IDS[curve.name]}_XMD:SHA-256_SVDW_RO_".encode()
    dst_arr = np.frombuffer(dst, dtype=np.uint8).copy()
    label_arr = (
        np.frombuffer(label, dtype=np.uint8).copy()
        if label
        else np.zeros(1, dtype=np.uint8)
    )
    out = np.empty((n, 2, 4), dtype="<u8")
    if nthreads <= 0:
        nthreads = os.cpu_count() or 4
    lib.mira_keygen(
        label_arr.ctypes.data_as(u8p), len(label), n,
        fparams.ctypes.data_as(u64p),
        q_bytes.ctypes.data_as(u8p), q12_bytes.ctypes.data_as(u8p), s,
        svdw.ctypes.data_as(u64p),
        dst_arr.ctypes.data_as(u8p), len(dst),
        out.ctypes.data_as(u64p), nthreads,
    )
    return out


def on_curve_check_native(xy_u64: np.ndarray, curve, nthreads: int = 0):
    """Returns number of off-curve points, or None if native lib unavailable.

    xy_u64: (n, 2, 4) uint64 raw affine coordinates.
    """
    lib = load()
    if lib is None:
        return None
    fparams, _, _, _ = _field_pack(curve.base_modulus)
    b_raw = _int_to_u64x4(curve.b)
    xy = np.ascontiguousarray(xy_u64, dtype="<u8")
    if nthreads <= 0:
        nthreads = os.cpu_count() or 4
    return int(
        lib.mira_on_curve_check(
            xy.ctypes.data_as(u64p), xy.shape[0],
            fparams.ctypes.data_as(u64p), b_raw.ctypes.data_as(u64p), nthreads,
        )
    )


def u64x4_to_limbs16(arr: np.ndarray) -> np.ndarray:
    """(..., 4) uint64 LE words -> (..., 16) uint32 16-bit limbs."""
    b = np.ascontiguousarray(arr, dtype="<u8")
    u16 = b.view("<u2").reshape(*arr.shape[:-1], 16)
    return u16.astype(np.uint32)


def limbs16_to_u64x4(arr: np.ndarray) -> np.ndarray:
    """(..., 16) uint32 16-bit limbs -> (..., 4) uint64 LE words."""
    u16 = np.ascontiguousarray(arr, dtype=np.uint32).astype("<u2")
    return u16.view("<u8").reshape(*arr.shape[:-1], 4)
