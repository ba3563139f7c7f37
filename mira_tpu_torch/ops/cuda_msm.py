"""MSM kernels on the card: the bucket MSM (csrc/msm_bucket.cu), the port
of mira_tpu/ops/pallas_msm.py `msm_pallas(method="bucket")`; the fixed-base
MSM (csrc/msm_fixed.cu), the port of `msm_pallas_fixed`; and its multiples
table (csrc/fixed_table.cu), the port of `precompute_fixed_table`.

`msm`, `msm_fixed` and `fixed_table` take a CPU tensor to the plain version
(ops/msm.py) and a CUDA tensor to the kernel; there is no fallback between
the two.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..curves.host import CurveParams

from .. import _build
from ..fields.limbs import NUM_WORDS
from .msm import (
    NBUCKET,
    WINDOW,
    msm_fixed_plain,
    msm_plain,
    num_windows,
    precompute_fixed_table_plain,
)

launches = 0  # bucket-MSM kernel launches (one per MSM on the card)
fixed_launches = 0  # fixed-base MSM launches
table_launches = 0  # multiples-table builds
FIXED_WINDOWS = (5, 6)  # the windows the fixed-base kernels are built for
_XYZZ_WORDS = 4 * NUM_WORDS
REDUCE_GROUP = 32  # chunks per thread in the kernel's first bucket-reduce pass


@lru_cache(maxsize=None)
def carry_thresholds(nwin: int, window: int = WINDOW) -> np.ndarray:
    """(nwin, 8) uint32 words of (2^(w-1) - 1) * (2^(w*k) - 1) / (2^w - 1)
    for window k: the incoming carry of window k is 1 iff the scalar's low
    w*k bits exceed it.  A threshold of 2^256 or more (no carry can arrive)
    is clamped to 2^256 - 1."""
    out = np.zeros((nwin, NUM_WORDS), dtype=np.uint32)
    half = 1 << (window - 1)
    for w in range(nwin):
        t = (half - 1) * ((1 << (window * w)) - 1) // ((1 << window) - 1)
        t = min(t, (1 << 256) - 1)
        out[w] = [(t >> (32 * k)) & 0xFFFFFFFF for k in range(NUM_WORDS)]
    return out


def chunks_for(n: int) -> int:
    """Point chunks per window in kernel A: ~64 points per thread, at most
    1024 chunks (~53k threads over 52 windows)."""
    return max(1, min(1024, (n + 63) // 64))


def msm(scalars: torch.Tensor, points, curve: CurveParams):
    """sum_i s_i * P_i.  scalars: (N, 8) plain words (< the group order);
    points: (X, Y, Z) (N, 8) Montgomery words, affine or identity
    (Z in {0, 1}).  Returns a canonical Jacobian triple of (8,) tensors.

    Precondition of the kernel: affine-or-identity bases and canonical
    scalars; duplicate and opposite bases, zero scalars and identity lanes
    are exact (complete XYZZ formulas, no offset point)."""
    if scalars.device.type == "cpu":
        return msm_plain(scalars, points, curve)
    return msm_cuda(scalars, points, curve)


def msm_cuda(scalars: torch.Tensor, points, curve: CurveParams):
    global launches
    field = _build.field_id(curve.base_modulus)
    X, Y, Z = points
    n = scalars.shape[0]
    dev = scalars.device
    for t in (scalars, X, Y, Z):
        if (t.device != dev or t.dtype != torch.int32
                or tuple(t.shape) != (n, NUM_WORDS)):
            raise ValueError("msm_cuda: expects (N, 8) int32 tensors on one "
                             "CUDA device")
    if n == 0:
        from ..curves.torch_curve import jacobian_ops

        return jacobian_ops(curve.name).identity((), dev)
    scalars, X, Y, Z = (t.contiguous() for t in (scalars, X, Y, Z))
    nwin = num_windows(curve.scalar_modulus.bit_length())
    nchunks = chunks_for(n)
    thr = _thresholds_on(nwin, WINDOW, dev)
    buckets = torch.empty(nwin * nchunks * NBUCKET, _XYZZ_WORDS,
                          dtype=torch.int32, device=dev)
    ngroups = -(-nchunks // REDUCE_GROUP)
    partial = torch.empty(nwin * ngroups * NBUCKET, _XYZZ_WORDS,
                          dtype=torch.int32, device=dev)
    wb = torch.empty(nwin * NBUCKET, _XYZZ_WORDS, dtype=torch.int32, device=dev)
    ws = torch.empty(nwin, _XYZZ_WORDS, dtype=torch.int32, device=dev)
    out = torch.empty(3, NUM_WORDS, dtype=torch.int32, device=dev)
    err = _build.lib().mira_msm_bucket(
        field, scalars.data_ptr(), X.data_ptr(), Y.data_ptr(), Z.data_ptr(), n, nwin,
        nchunks, REDUCE_GROUP, thr.data_ptr(), buckets.data_ptr(),
        partial.data_ptr(), wb.data_ptr(), ws.data_ptr(), out.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(err, "msm_bucket")
    launches += 1
    return (out[0], out[1], out[2])


def fixed_table(points, curve: CurveParams, window: int) -> torch.Tensor:
    """The (N, 2^(w-1), 2, 8) table of affine multiples 1P..(2^(w-1))P of
    bases (X, Y, Z) (N, 8) Montgomery words, affine or identity; an
    identity base gets (0, 0) entries."""
    if points[0].device.type == "cpu":
        return precompute_fixed_table_plain(points, curve, window)
    return fixed_table_cuda(points, curve, window)


def fixed_table_cuda(points, curve: CurveParams, window: int) -> torch.Tensor:
    global table_launches
    field = _build.field_id(curve.base_modulus)
    if window not in FIXED_WINDOWS:
        raise ValueError(f"fixed_table_cuda: window {window} not in {FIXED_WINDOWS}")
    X, Y, Z = points
    n = X.shape[0]
    dev = X.device
    for t in (X, Y, Z):
        if (t.device != dev or t.dtype != torch.int32
                or tuple(t.shape) != (n, NUM_WORDS)):
            raise ValueError("fixed_table_cuda: expects (N, 8) int32 tensors on "
                             "one CUDA device")
    X, Y, Z = (t.contiguous() for t in (X, Y, Z))
    ntab = 1 << (window - 1)
    tab = torch.empty(n, ntab, 2, NUM_WORDS, dtype=torch.int32, device=dev)
    if n == 0:
        return tab
    err = _build.lib().mira_fixed_table(
        field, X.data_ptr(), Y.data_ptr(), Z.data_ptr(), n, window,
        tab.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "fixed_table")
    table_launches += 1
    return tab


def msm_fixed(scalars: torch.Tensor, table: torch.Tensor, curve: CurveParams,
              window: int):
    """sum_i s_i * P_i over the multiples table of the P_i (`fixed_table`).
    scalars: (N, 8) plain words (< 2^256).  Returns a canonical Jacobian
    triple of (8,) tensors.  Duplicate and opposite bases, zero scalars and
    identity lanes are exact (complete XYZZ formulas)."""
    if scalars.device.type == "cpu":
        return msm_fixed_plain(scalars, table, curve, window)
    return msm_fixed_cuda(scalars, table, curve, window)


def msm_fixed_cuda(scalars: torch.Tensor, table: torch.Tensor,
                   curve: CurveParams, window: int):
    global fixed_launches
    field = _build.field_id(curve.base_modulus)
    if window not in FIXED_WINDOWS:
        raise ValueError(f"msm_fixed_cuda: window {window} not in {FIXED_WINDOWS}")
    n = scalars.shape[0]
    dev = scalars.device
    ntab = 1 << (window - 1)
    if (scalars.dtype != torch.int32 or tuple(scalars.shape) != (n, NUM_WORDS)
            or table.device != dev or table.dtype != torch.int32
            or tuple(table.shape) != (n, ntab, 2, NUM_WORDS)):
        raise ValueError("msm_fixed_cuda: expects (N, 8) int32 scalars and an "
                         f"(N, {ntab}, 2, 8) int32 table on one CUDA device")
    if n == 0:
        from ..curves.torch_curve import jacobian_ops

        return jacobian_ops(curve.name).identity((), dev)
    scalars, table = scalars.contiguous(), table.contiguous()
    nwin = num_windows(curve.scalar_modulus.bit_length(), window)
    nchunks = chunks_for(n)
    thr = _thresholds_on(nwin, window, dev)
    acc = torch.empty(nwin * nchunks, _XYZZ_WORDS, dtype=torch.int32, device=dev)
    ngroups = -(-nchunks // REDUCE_GROUP)
    partial = torch.empty(nwin * ngroups, _XYZZ_WORDS, dtype=torch.int32,
                          device=dev)
    ws = torch.empty(nwin, _XYZZ_WORDS, dtype=torch.int32, device=dev)
    out = torch.empty(3, NUM_WORDS, dtype=torch.int32, device=dev)
    err = _build.lib().mira_msm_fixed(
        field, scalars.data_ptr(), table.data_ptr(), n, window, nwin, nchunks,
        REDUCE_GROUP, thr.data_ptr(), acc.data_ptr(), partial.data_ptr(),
        ws.data_ptr(), out.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "msm_fixed")
    fixed_launches += 1
    return (out[0], out[1], out[2])


_thr_cache = {}


def _thresholds_on(nwin: int, window: int, dev) -> torch.Tensor:
    key = (nwin, window, str(dev))
    t = _thr_cache.get(key)
    if t is None:
        t = torch.from_numpy(carry_thresholds(nwin, window).view(np.int32)).to(dev)
        _thr_cache[key] = t
    return t
