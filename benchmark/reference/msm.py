"""The reference's multi-scalar multiplication: msm.cpp, a frozen copy of the
host Pippenger MSM (native.py builds it), bound with ctypes.

A vector committed in Montgomery form (words m_i = v_i R mod r, R = 2^256)
is committed as sum(m_i G_i) times R^-1 mod r, which equals sum(v_i G_i)
because every key point has order r: no word is converted on the host.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .curves import Curve, Point
from .native import library


def _load():
    lib = library("msm")
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.mira_msm.argtypes = [u64p, u64p, u64p, ctypes.c_size_t, u64p,
                             ctypes.c_int, ctypes.c_int, u64p]
    lib.mira_msm.restype = None
    return lib


def key_coords(rows: np.ndarray):
    """(n, 2, 16) 16-bit limbs of raw affine coordinates (the key file's
    layout) -> x and y as (n, 4) little-endian uint64."""
    u64 = np.ascontiguousarray(rows, dtype="<u4").astype("<u2").view("<u8")
    u64 = u64.reshape(rows.shape[0], 2, 4)
    return np.ascontiguousarray(u64[:, 0]), np.ascontiguousarray(u64[:, 1])


def msm_words(curve: Curve, words: np.ndarray, xs: np.ndarray, ys: np.ndarray,
              montgomery: bool) -> Point:
    """sum(s_i G_i) for the (n, 8) int32 words s (read as Montgomery forms
    where `montgomery`) and the first n key points."""
    n = words.shape[0]
    if n > xs.shape[0]:
        raise ValueError(f"{n} scalars for a key of {xs.shape[0]} points")
    if n == 0:
        return None
    lib = _load()
    sc = np.ascontiguousarray(words, dtype="<i4").view("<u8").reshape(n, 4)
    mod = np.array([(curve.p >> (64 * i)) & (2**64 - 1) for i in range(4)], dtype="<u8")
    out = np.zeros(12, dtype="<u8")
    u64p = ctypes.POINTER(ctypes.c_uint64)
    xs_n, ys_n = np.ascontiguousarray(xs[:n]), np.ascontiguousarray(ys[:n])
    lib.mira_msm(sc.ctypes.data_as(u64p), xs_n.ctypes.data_as(u64p),
                 ys_n.ctypes.data_as(u64p), n, mod.ctypes.data_as(u64p), 0,
                 os.cpu_count() or 4, out.ctypes.data_as(u64p))
    X, Y, Z = (sum(int(out[4 * k + i]) << (64 * i) for i in range(4)) for k in range(3))
    pt = curve.from_jacobian(X, Y, Z)
    if montgomery:
        pt = curve.mul(pt, pow(2**256, -1, curve.r))
    return pt
