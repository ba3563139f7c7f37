"""ctypes binding for the native C++ host Pippenger (native/msm.cpp).

This is the runtime-side commitment engine for CPU paths (test suites, key
setup, host fallbacks) — the role halo2curves' Rust `best_multiexp` plays
for the reference (src/commitment.rs:78-87).  Built lazily
with g++ the first time it's needed; falls back to the pure-python
Pippenger (curves/host.py) if no toolchain is available.

Copied from mira_tpu/ops/native_msm.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from functools import lru_cache

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SRC = os.path.join(_NATIVE_DIR, "msm.cpp")
_SO = os.path.join(_NATIVE_DIR, "libmiramsm.so")
_build_lock = threading.Lock()


@lru_cache(maxsize=1)
def _load():
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
    lib.mira_msm.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),  # scalars
        ctypes.POINTER(ctypes.c_uint64),  # xs
        ctypes.POINTER(ctypes.c_uint64),  # ys
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64),  # modulus
        ctypes.c_int,                     # window (<=0: auto)
        ctypes.c_int,                     # nthreads (<=0: auto)
        ctypes.POINTER(ctypes.c_uint64),  # out (12 u64)
    ]
    lib.mira_msm.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def _pack_u64x4(vals):
    n = len(vals)
    arr = (ctypes.c_uint64 * (n * 4))()
    mask = (1 << 64) - 1
    for i, v in enumerate(vals):
        arr[i * 4 + 0] = v & mask
        arr[i * 4 + 1] = (v >> 64) & mask
        arr[i * 4 + 2] = (v >> 128) & mask
        arr[i * 4 + 3] = (v >> 192) & mask
    return arr


def msm_native_raw(
    sc_u64x4, xs_u64x4, ys_u64x4, base_modulus: int,
    window: int = 0, nthreads: int = 0,
):
    """Raw-buffer MSM: (n, 4) uint64 little-endian plain scalars and affine
    coordinates ((0, 0) = infinity) -> (3, 4) uint64 plain Jacobian result.
    numpy in / numpy out — the per-shard engine of the CPU-mesh sharded MSM
    (parallel/msm.py), where per-value python object round trips would
    dominate."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native MSM library unavailable (no g++?)")
    sc = np.ascontiguousarray(sc_u64x4, dtype=np.uint64)
    xs = np.ascontiguousarray(xs_u64x4, dtype=np.uint64)
    ys = np.ascontiguousarray(ys_u64x4, dtype=np.uint64)
    n = sc.shape[0]
    assert sc.shape == (n, 4) and xs.shape == (n, 4) and ys.shape == (n, 4)
    mod = _pack_u64x4([base_modulus])
    out = (ctypes.c_uint64 * 12)()
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.mira_msm(
        sc.ctypes.data_as(u64p), xs.ctypes.data_as(u64p),
        ys.ctypes.data_as(u64p), n, mod, window, nthreads, out,
    )
    return np.ctypeslib.as_array(out).reshape(3, 4).copy()


def msm_native(scalars, points, window: int = 0, nthreads: int = 0):
    """scalars: list[int]; points: list[AffinePoint] (same curve).
    Returns AffinePoint.  Raises RuntimeError if the library is unavailable."""
    from ..curves.host import AffinePoint
    from ..fields.host import field

    lib = _load()
    if lib is None:
        raise RuntimeError("native MSM library unavailable (no g++?)")
    assert len(scalars) == len(points)
    curve = points[0].curve
    n = len(points)
    sc = _pack_u64x4([s % curve.scalar_modulus for s in scalars])
    xs = _pack_u64x4([0 if p.is_inf else p.x.v for p in points])
    ys = _pack_u64x4([0 if p.is_inf else p.y.v for p in points])
    mod = _pack_u64x4([curve.base_modulus])
    out = (ctypes.c_uint64 * 12)()
    lib.mira_msm(sc, xs, ys, n, mod, window, nthreads, out)

    def unpack(off):
        return (
            out[off]
            | (out[off + 1] << 64)
            | (out[off + 2] << 128)
            | (out[off + 3] << 192)
        )

    X, Y, Z = unpack(0), unpack(4), unpack(8)
    if Z == 0:
        return AffinePoint.identity(curve)
    p = curve.base_modulus
    zinv = pow(Z, p - 2, p)
    zinv2 = zinv * zinv % p
    F = field(p)
    return AffinePoint(curve, F(X * zinv2 % p), F(Y * zinv2 % p * zinv % p))
