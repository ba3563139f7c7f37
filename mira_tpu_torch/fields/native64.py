"""Native 4x64-limb Montgomery field kernels over numpy arrays.

CPU-runtime helpers backed by native/evaluator.cpp (__int128 scalar
Montgomery, threaded): constant multiply (to/from-Montgomery form),
homomorphic inner product, and the witness RLC — the hot vector ops the
reference gets from halo2curves' 64-bit Rust field arithmetic + rayon.

Layout: little-endian 4x64 limbs — the byte image of the device's
(..., 16) 16-bit-limb uint32 arrays, so 16<->64 conversion is a numpy
view, not arithmetic.

Copied from mira_tpu/fields/native64.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils.native_lib import available, load  # noqa: F401

NUM_LIMBS16 = 16


def limbs16_to_64(arr) -> np.ndarray:
    """(..., 16) uint32 16-bit-limb array -> C-contiguous (..., 4) uint64."""
    a = np.ascontiguousarray(np.asarray(arr), dtype=np.uint32).astype("<u2")
    return np.ascontiguousarray(a).view("<u8").reshape(*a.shape[:-1], 4)


def limbs64_to_16(arr) -> np.ndarray:
    """(..., 4) uint64 -> (..., 16) uint32 16-bit-limb array."""
    a = np.ascontiguousarray(arr, dtype="<u8")
    return a.view("<u2").astype(np.uint32).reshape(*a.shape[:-1], NUM_LIMBS16)


def int_to_64(v: int) -> np.ndarray:
    out = np.zeros(4, dtype=np.uint64)
    for k in range(4):
        out[k] = (v >> (64 * k)) & 0xFFFFFFFFFFFFFFFF
    return out


def ints_to_64(vals) -> np.ndarray:
    buf = b"".join(
        (v if isinstance(v, int) else v.v).to_bytes(32, "little")
        for v in vals
    )
    return np.frombuffer(buf, dtype="<u8").reshape(len(vals), 4).copy()


def u64_to_int(a) -> int:
    return sum(int(a[k]) << (64 * k) for k in range(4))


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def mul_const_mont(p: int, a64: np.ndarray, c: int,
                   nthreads: int = 0) -> np.ndarray:
    """out[i] = mont_mul(a[i], c) with c given as plain 256-bit limbs."""
    lib = load()
    a64 = np.ascontiguousarray(a64, dtype=np.uint64)
    n = a64.reshape(-1, 4).shape[0]
    out = np.empty_like(a64.reshape(-1, 4))
    lib.mira_mul_const_mont(
        _ptr(int_to_64(p)), _ptr(a64), _ptr(int_to_64(c)), n, nthreads,
        _ptr(out),
    )
    return out.reshape(a64.shape)


def to_mont(p: int, a64: np.ndarray) -> np.ndarray:
    """Plain limbs -> Montgomery form (mont_mul by R^2 mod p)."""
    r2 = pow(1 << 256, 2, p)
    return mul_const_mont(p, a64, r2)


def from_mont(p: int, a64: np.ndarray) -> np.ndarray:
    """Montgomery form -> plain limbs (mont_mul by 1)."""
    return mul_const_mont(p, a64, 1)


def inner_product_mont(p: int, w_plain64: np.ndarray, v_mont64: np.ndarray,
                       nthreads: int = 0) -> int:
    """<w, v> mod p with w in PLAIN limbs and v in Montgomery form.

    mont_mul(w, vR) = w*v, so the accumulated sum is the plain inner
    product directly — no weight pre-conversion, no correction factor."""
    lib = load()
    w64 = np.ascontiguousarray(w_plain64, dtype=np.uint64)
    v64 = np.ascontiguousarray(v_mont64, dtype=np.uint64)
    n = v64.reshape(-1, 4).shape[0]
    assert w64.reshape(-1, 4).shape[0] >= n
    out = np.zeros(4, dtype=np.uint64)
    lib.mira_inner_product_mont(
        _ptr(int_to_64(p)), _ptr(w64), _ptr(v64), n, nthreads, _ptr(out)
    )
    return u64_to_int(out)


def lincomb_mont(p: int, ins64: np.ndarray, coefs: "list[list[int]]",
                 nthreads: int = 0) -> np.ndarray:
    """out[k] = sum_j coefs[k][j] * ins[j] with plain-int coefficients;
    ins64: (m_in, n, 4) Montgomery; returns (m_out, n, 4) Montgomery."""
    lib = load()
    ins64 = np.ascontiguousarray(ins64, dtype=np.uint64)
    m_in, n = ins64.shape[0], ins64.shape[1]
    m_out = len(coefs)
    R = 1 << 256
    c64 = np.zeros((m_out, m_in, 4), dtype=np.uint64)
    for k, row in enumerate(coefs):
        for j, c in enumerate(row):
            c64[k, j] = int_to_64((c % p) * R % p)
    out = np.empty((m_out, n, 4), dtype=np.uint64)
    lib.mira_lincomb_mont(
        _ptr(int_to_64(p)), _ptr(ins64), _ptr(c64), m_in, m_out, n,
        nthreads, _ptr(out),
    )
    return out


def rlc_mont(p: int, a64: np.ndarray, b64: np.ndarray, r: int,
             nthreads: int = 0) -> np.ndarray:
    """out[i] = a[i] + mont_mul(r_mont, b[i]) — witness RLC with plain
    scalar r (Montgomery-encoded internally)."""
    lib = load()
    a64 = np.ascontiguousarray(a64, dtype=np.uint64)
    b64 = np.ascontiguousarray(b64, dtype=np.uint64)
    n = a64.reshape(-1, 4).shape[0]
    out = np.empty_like(a64.reshape(-1, 4))
    r_mont = (r % p) * (1 << 256) % p
    lib.mira_rlc_mont(
        _ptr(int_to_64(p)), _ptr(a64), _ptr(b64), _ptr(int_to_64(r_mont)),
        n, nthreads, _ptr(out),
    )
    return out.reshape(a64.shape)


def _ptr32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def to_mont16(p: int, raw16: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """(n, 16) plain uint32 16-bit-limb planes -> Montgomery, same layout.
    Single fused native pass (pack/mul/unpack in registers) — no numpy
    16<->64 temporaries."""
    lib = load()
    a = np.ascontiguousarray(raw16, dtype=np.uint32)
    out = np.empty_like(a)
    n = a.shape[0]
    r2 = int_to_64((1 << 512) % p)
    lib.mira_mul_const_mont16(_ptr(int_to_64(p)), _ptr32(a), _ptr(r2),
                              n, nthreads, _ptr32(out))
    return out


def inner_product_mont16(p: int, w_plain64: np.ndarray, v16: np.ndarray,
                         nthreads: int = 0) -> int:
    """<w_plain, v_mont> with v in (n, 16) limb planes; returns plain int
    (mont_mul(w_plain, v_mont) = w*v, so the result needs no decode)."""
    lib = load()
    v = np.ascontiguousarray(v16, dtype=np.uint32)
    n = v.shape[0]
    assert w_plain64.shape[0] >= n
    out = np.zeros(4, dtype=np.uint64)
    lib.mira_inner_product_mont16(
        _ptr(int_to_64(p)), _ptr(np.ascontiguousarray(w_plain64[:n])),
        _ptr32(v), n, nthreads, _ptr(out),
    )
    return u64_to_int(out)


def from_mont16(p: int, mont16: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """(n, 16) Montgomery limb planes -> plain, fused native pass."""
    lib = load()
    a = np.ascontiguousarray(mont16, dtype=np.uint32)
    out = np.empty_like(a)
    lib.mira_mul_const_mont16(_ptr(int_to_64(p)), _ptr32(a),
                              _ptr(int_to_64(1)), a.shape[0], nthreads,
                              _ptr32(out))
    return out
