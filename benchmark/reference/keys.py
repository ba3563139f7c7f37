"""The benchmark's own Pedersen keys: row i of a key labelled L is the SvdW
hash-to-curve (RFC 9380, expand_message_xmd with SHA-256, the DST
"from_uniform_bytes-<curve id>_XMD:SHA-256_SVDW_RO_") of bytes 32i..32i+31
of SHAKE-256(L), as Mira's src/commitment.rs derives its generators.  The
points come from keygen.cu on the card where there is one, else from
keygen.cpp, a frozen copy of the native generator, which also checks a
sample of the card's rows; the constants both need are worked out here.
The file is written in the layout the program's key cache reads ((n, 2, 16)
uint32 16-bit limbs of the raw affine x and y), so the program and the
reference read one file that the benchmark made.
"""

from __future__ import annotations

import ctypes
import hashlib
import os

import numpy as np

from .curves import Curve
from .native import cuda_library, library

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


CHUNK = 1 << 22  # rows a call makes, and a write copies, at most


class KeyMismatch(RuntimeError):
    """Rows made on the card differ from keygen.cpp's."""


def _args(curve: Curve):
    """keygen.cpp's arguments for a curve, after the stream and its length."""
    fparams, q_bytes, q12_bytes, s = _field_params(curve.p)
    svdw = np.concatenate([_u64x4(v) for v in (*svdw_constants(curve.p, curve.b), curve.b)])
    dst = np.frombuffer(f"from_uniform_bytes-{CURVE_IDS[curve.name]}_XMD:SHA-256_SVDW_RO_"
                        .encode(), dtype=np.uint8).copy()
    return fparams, q_bytes, q12_bytes, s, svdw, dst


def _bind(fn, restype, *extra):
    u8p, u64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64)
    fn.argtypes = [u8p, ctypes.c_size_t, u64p, u8p, u8p, ctypes.c_int, u64p, u8p,
                   ctypes.c_size_t, u64p, *extra]
    fn.restype = restype
    return fn


def card():
    """keygen.cu's entry where nvcc and a CUDA device are present, else None."""
    lib = cuda_library("keygen")
    if lib is None:
        return None
    lib.mira_keygen_cuda_devices.argtypes = []
    lib.mira_keygen_cuda_devices.restype = ctypes.c_int
    if lib.mira_keygen_cuda_devices() < 1:
        return None
    return _bind(lib.mira_keygen_cuda, ctypes.c_int)


def _map(fn, curve: Curve, stream: np.ndarray) -> np.ndarray:
    """Rows of 32 stream bytes each, (m, 2, 16) uint32 16-bit limbs, through
    `fn` (`card()`), or keygen.cpp's mira_keygen_mapped where it is None."""
    m = stream.shape[0] // 32
    u8p, u64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64)
    fparams, q_bytes, q12_bytes, s, svdw, dst = _args(curve)
    stream = np.ascontiguousarray(stream)
    out = np.empty((m, 2, 4), dtype="<u8")
    args = [stream.ctypes.data_as(u8p), m, fparams.ctypes.data_as(u64p),
            q_bytes.ctypes.data_as(u8p), q12_bytes.ctypes.data_as(u8p), s,
            svdw.ctypes.data_as(u64p), dst.ctypes.data_as(u8p), len(dst),
            out.ctypes.data_as(u64p)]
    if fn is None:
        _bind(library("keygen").mira_keygen_mapped, None, ctypes.c_int)(
            *args, os.cpu_count() or 4)
    else:
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"keygen.cu failed with CUDA error {code}")
    return out.view("<u2").astype(np.uint32).reshape(m, 2, 16)


def _stream(label: bytes, n: int) -> np.ndarray:
    return np.frombuffer(hashlib.shake_256(label).digest(32 * n), dtype=np.uint8)


def make_rows(curve: Curve, label: bytes, n: int, start: int = 0) -> np.ndarray:
    """Rows start..n-1 of the key, (n - start, 2, 16) uint32 16-bit limbs,
    from their slice of the SHAKE-256 stream, by keygen.cpp."""
    return _map(None, curve, _stream(label, n)[32 * start:])


def guard(curve: Curve, stream: np.ndarray, start: int, n: int, read, seed: int):
    """Hold a seeded sample of rows start..n-1 of a key (4,096 rows, one in
    each of equal strata, with the first and the last), as `read(rows)`
    gives them, against keygen.cpp's; raise KeyMismatch on any difference."""
    edges = start + (np.arange(4097, dtype=np.int64) * (n - start)) // 4096
    picks = edges[:-1] + (np.random.default_rng(seed).random(4096)
                          * (edges[1:] - edges[:-1])).astype(np.int64)
    idx = np.unique(np.concatenate([[start, n - 1], picks[picks < edges[1:]]]))
    want = _map(None, curve, stream.reshape(-1, 32)[idx].reshape(-1))
    bad = idx[~np.all(read(idx) == want, axis=(1, 2))]
    if bad.size:
        raise KeyMismatch(f"{bad.size} of {idx.size} sampled rows made on the card differ "
                          f"from keygen.cpp's, the first at row {int(bad[0])}")


def _key_rows_in(f, path: str) -> int:
    """The row count of the key file open in `f`, which is left past its
    header."""
    if np.lib.format.read_magic(f) != (1, 0):
        raise ValueError(f"{path} is no key file")
    shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    if dtype != np.dtype("<u4") or fortran or tuple(shape[1:]) != (2, 16):
        raise ValueError(f"{path} is no key file")
    return shape[0]


def _read_rows(path: str, idx) -> np.ndarray:
    """Rows idx of a key file, read one by one: a map of the file would keep
    the pages around each row, as much as the whole file."""
    with open(path, "rb") as f:
        _key_rows_in(f, path)
        at = f.tell()
        return np.stack([np.frombuffer(os.pread(f.fileno(), 128, at + 128 * int(i)),
                                       dtype="<u4").reshape(2, 16) for i in idx])


def _copy_rows(src: str, rows, out) -> int:
    """Copy the rows of the key file `src` (its first `rows`, or all) to the
    open file `out`, a chunk at a time.  Returns the rows copied."""
    with open(src, "rb") as f:
        have = _key_rows_in(f, src)
        rows = have if rows is None else rows
        left = rows * 128
        while left:
            buf = f.read(min(left, CHUNK * 128))
            if not buf:
                raise ValueError(f"{src} ends before row {rows}")
            out.write(buf)
            left -= len(buf)
    return rows


def ensure_key(curve: Curve, label: str, k: int, path: str, seed: int = 0):
    """Write the key of 2^k points to `path` unless it is there.  Keys of one
    label share their rows, so a larger key beside it (`<k'>-svdw.npy`)
    holds it as its first rows, and a smaller one is its first rows: only
    the rows past it are made, on the card where there is one (`card()`),
    else by keygen.cpp.  Rows made on the card pass `guard` (seeded by
    `seed`) before the file takes its name.  The file is written a chunk at
    a time, in np.save's bytes."""
    if os.path.exists(path):
        return
    folder = os.path.dirname(path)
    os.makedirs(folder, exist_ok=True)

    def beside(k0):
        return os.path.join(folder, f"{k0}-svdw.npy")

    larger = [k0 for k0 in range(k + 1, 33) if os.path.exists(beside(k0))]
    smaller = [k0 for k0 in range(k - 1, -1, -1) if os.path.exists(beside(k0))]
    n, fn = 1 << k, None
    tmp = f"{path}.part.npy"
    with open(tmp, "wb") as out:
        np.lib.format.write_array_header_1_0(
            out, {"descr": "<u4", "fortran_order": False, "shape": (n, 2, 16)})
        if larger:
            start = _copy_rows(beside(larger[0]), n, out)
        else:
            start = _copy_rows(beside(smaller[0]), None, out) if smaller else 0
            fn = card()
            stream = _stream(label.encode(), n)
            for r in range(start, n, CHUNK):
                _map(fn, curve, stream[32 * r: 32 * min(n, r + CHUNK)]).tofile(out)
    if fn is not None:
        try:
            guard(curve, stream, start, n, lambda idx: _read_rows(tmp, idx), seed)
        except KeyMismatch:
            os.remove(tmp)
            raise
    os.replace(tmp, path)
