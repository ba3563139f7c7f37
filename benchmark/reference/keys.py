"""The benchmark's own Pedersen keys: row i of a key labelled L is the SvdW
hash-to-curve (RFC 9380, expand_message_xmd with SHA-256, the DST
"from_uniform_bytes-<curve id>_XMD:SHA-256_SVDW_RO_") of bytes 32i..32i+31
of SHAKE-256(L), as Mira's src/commitment.rs derives its generators.  The
points come from keygen.cpp, a frozen copy of the native generator; the
constants it needs are worked out here.  The file is written in the layout
the program's key cache reads ((n, 2, 16) uint32 16-bit limbs of the raw
affine x and y), so the program and the reference read one file that the
benchmark made.
"""

from __future__ import annotations

import ctypes
import hashlib
import os

import numpy as np

from .curves import Curve
from .native import library

CURVE_IDS = {"bn254": "bn256_g1", "grumpkin": "grumpkin_g1"}


def _u64x4(v: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(32, "little"), dtype="<u8").copy()


def _is_square(v: int, p: int) -> bool:
    return v % p == 0 or pow(v, (p - 1) // 2, p) == 1


def _sqrt(v: int, p: int) -> int:
    """A square root mod p (Tonelli-Shanks)."""
    q, s = p - 1, 0
    while q % 2 == 0:
        q, s = q // 2, s + 1
    z = 2
    while _is_square(z, p):
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(v, q, p), pow(v, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2, i = t2 * t2 % p, i + 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


def svdw_constants(p: int, b: int):
    """RFC 9380 6.6.1 and F.1 for a = 0: Z (the nonzero integer of least
    absolute value, positive first, meeting the criteria), c1..c4."""
    def g(x):
        return (x * x * x + b) % p

    def fits(z):
        gz = g(z)
        if gz == 0:
            return False
        h = (-(3 * z * z) * pow(4 * gz, -1, p)) % p
        return (h != 0 and _is_square(h, p)
                and (_is_square(gz, p) or _is_square(g((-z * pow(2, -1, p)) % p), p)))

    ctr, Z = 1, None
    while Z is None:
        for cand in (ctr % p, -ctr % p):
            if fits(cand):
                Z = cand
                break
        ctr += 1
    gZ = g(Z)
    c3 = _sqrt((-gZ * 3 * Z * Z) % p, p)
    if c3 % 2:
        c3 = p - c3
    return Z, gZ, (-Z * pow(2, -1, p)) % p, c3, (-4 * gZ * pow(3 * Z * Z, -1, p)) % p


def _field_params(p: int):
    """keygen.cpp's field block: p, -p^-1 mod 2^64, R^2, R (mod p), a
    non-residue to the odd part of p - 1 (Montgomery), and Tonelli-Shanks'
    q, (q - 1)/2 and 2-adicity."""
    q, s = p - 1, 0
    while q % 2 == 0:
        q, s = q // 2, s + 1
    z = 2
    while _is_square(z, p):
        z += 1
    r = 1 << 256
    fparams = np.concatenate([_u64x4(p), np.array([(-pow(p, -1, 1 << 64)) % (1 << 64)],
                                                    dtype="<u8"),
                              _u64x4(r * r % p), _u64x4(r % p), _u64x4(pow(z, q, p) * r % p)])
    as_bytes = [np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8).copy()
                for v in (q, (q - 1) // 2)]
    return fparams, as_bytes[0], as_bytes[1], s


def make_rows(curve: Curve, label: bytes, n: int, start: int = 0) -> np.ndarray:
    """Rows start..n-1 of the key, (n - start, 2, 16) uint32 16-bit limbs,
    from their slice of the SHAKE-256 stream."""
    lib = library("keygen")
    u8p, u64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64)
    lib.mira_keygen_mapped.argtypes = [u8p, ctypes.c_size_t, u64p, u8p, u8p, ctypes.c_int,
                                       u64p, u8p, ctypes.c_size_t, u64p, ctypes.c_int]
    lib.mira_keygen_mapped.restype = None
    fparams, q_bytes, q12_bytes, s = _field_params(curve.p)
    svdw = np.concatenate([_u64x4(v) for v in (*svdw_constants(curve.p, curve.b), curve.b)])
    dst = np.frombuffer(f"from_uniform_bytes-{CURVE_IDS[curve.name]}_XMD:SHA-256_SVDW_RO_"
                        .encode(), dtype=np.uint8).copy()
    stream = np.frombuffer(hashlib.shake_256(label).digest(32 * n), dtype=np.uint8,
                           offset=32 * start)
    out = np.empty((n - start, 2, 4), dtype="<u8")
    lib.mira_keygen_mapped(stream.ctypes.data_as(u8p), n - start, fparams.ctypes.data_as(u64p),
                           q_bytes.ctypes.data_as(u8p), q12_bytes.ctypes.data_as(u8p), s,
                           svdw.ctypes.data_as(u64p), dst.ctypes.data_as(u8p), len(dst),
                           out.ctypes.data_as(u64p), os.cpu_count() or 4)
    return out.view("<u2").astype(np.uint32).reshape(n - start, 2, 16)


def ensure_key(curve: Curve, label: str, k: int, path: str):
    """Write the key of 2^k points to `path` unless it is there.  Keys of one
    label share their rows, so a larger key beside it (`<k'>-svdw.npy`)
    holds it as its first rows, and a smaller one is its first rows: only
    the rows past it are made."""
    if os.path.exists(path):
        return
    folder = os.path.dirname(path)
    os.makedirs(folder, exist_ok=True)

    def beside(k0):
        return os.path.join(folder, f"{k0}-svdw.npy")

    larger = [k0 for k0 in range(k + 1, 33) if os.path.exists(beside(k0))]
    smaller = [k0 for k0 in range(k - 1, -1, -1) if os.path.exists(beside(k0))]
    if larger:
        rows = np.load(beside(larger[0]), mmap_mode="r")[: 1 << k]
    elif smaller:
        head = np.load(beside(smaller[0]))
        rows = np.concatenate([head, make_rows(curve, label.encode(), 1 << k,
                                               start=head.shape[0])])
    else:
        rows = make_rows(curve, label.encode(), 1 << k)
    tmp = f"{path}.part.npy"
    np.save(tmp, rows)
    os.replace(tmp, path)
