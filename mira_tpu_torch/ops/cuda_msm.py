"""MSM kernels on the card: the bucket MSM (csrc/msm_bucket.cu), the port
of mira_tpu/ops/pallas_msm.py `msm_pallas(method="bucket")`; the fixed-base
MSM (csrc/msm_fixed.cu), the port of `msm_pallas_fixed`; its multiples
table (csrc/fixed_table.cu), the port of `precompute_fixed_table`; the
shared-Horner Pippenger (csrc/msm_pippenger.cu), the port of
`msm_pallas(method="pippenger" / "pippenger-u4")`; and the per-lane
double-and-add (csrc/msm_lane.cu), the port of `msm_pallas(method="window")`
and of its bit-serial kernel ("lane").

ops/msm.py `msm(..., method=)` takes a CPU tensor to an engine's plain
version and a CUDA tensor to its kernel here; `msm_fixed` and
`fixed_table` do the same for the fixed-base kernels.  There is no
fallback between the two.
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
    PIPPENGER_WINDOW,
    WINDOW,
    msm_fixed_plain,
    num_windows,
    pippenger_windows,
    precompute_fixed_table_plain,
)

launches = 0  # bucket-MSM kernel launches (one per MSM on the card)
fixed_launches = 0  # fixed-base MSM launches
table_launches = 0  # multiples-table builds
pippenger_launches = 0  # kernel 4 (signed 5-bit Pippenger) MSMs
pippenger_u4_launches = 0  # kernel 5 (unsigned 4-bit Pippenger) MSMs
window_launches = 0  # kernel 6 (per-lane 4-bit windows) MSMs
lane_launches = 0  # kernel 7 (per-lane bit-serial) MSMs
PIPPENGER_MAX_CHUNKS = 32768  # threads of the Pippenger kernel's first pass
LANE_BLOCK = 128  # lanes per block of the per-lane kernel (csrc LANE_T)
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


def _check_msm_args(scalars, points, what: str):
    """(n, device, contiguous (scalars, X, Y, Z)) of (N, 8) int32 tensors on
    one CUDA device; anything else raises."""
    X, Y, Z = points
    n = scalars.shape[0]
    dev = scalars.device
    for t in (scalars, X, Y, Z):
        if (t.device != dev or t.device.type != "cuda" or t.dtype != torch.int32
                or tuple(t.shape) != (n, NUM_WORDS)):
            raise ValueError(f"{what}: expects (N, 8) int32 tensors on one "
                             "CUDA device")
    return n, dev, tuple(t.contiguous() for t in (scalars, X, Y, Z))


def _identity(curve: CurveParams, dev):
    from ..curves.torch_curve import jacobian_ops

    return jacobian_ops(curve.name).identity((), dev)


def msm_cuda(scalars: torch.Tensor, points, curve: CurveParams):
    """Kernel 1, the bucket MSM; ops/msm.py `msm_plain` is its plain version.
    scalars: (N, 8) plain words (< the group order); points: (X, Y, Z)
    (N, 8) Montgomery words, affine or identity (Z in {0, 1}).  Returns a
    canonical Jacobian triple of (8,) tensors.  Duplicate and opposite
    bases, zero scalars and identity lanes are exact (complete XYZZ
    formulas, no offset point)."""
    global launches
    field = _build.field_id(curve.base_modulus)
    n, dev, (scalars, X, Y, Z) = _check_msm_args(scalars, points, "msm_cuda")
    if n == 0:
        return _identity(curve, dev)
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


def pippenger_chunks(n: int) -> int:
    """Threads of the Pippenger kernel's first pass: ~4 points each, at most
    PIPPENGER_MAX_CHUNKS (then more points per thread)."""
    return max(1, min(PIPPENGER_MAX_CHUNKS, -(-n // 4)))


def msm_pippenger_cuda(scalars: torch.Tensor, points, curve: CurveParams,
                       signed: bool = True):
    """Kernel 4 (signed 5-bit digits) or 5 (unsigned 4-bit); ops/msm.py
    `msm_pippenger_plain` is its plain version.  Bases affine or identity;
    duplicate and opposite bases are exact (complete XYZZ additions)."""
    global pippenger_launches, pippenger_u4_launches
    field = _build.field_id(curve.base_modulus)
    n, dev, (sc, X, Y, Z) = _check_msm_args(scalars, points, "msm_pippenger_cuda")
    if n == 0:
        return _identity(curve, dev)
    nwin = pippenger_windows(curve.scalar_modulus.bit_length(), signed)
    nchunks = pippenger_chunks(n)
    group = max(1, int(nchunks ** 0.5))  # two reduce passes of ~sqrt chains
    thr = _thresholds_on(nwin, PIPPENGER_WINDOW, dev) if signed else sc
    acc = torch.empty(nwin * nchunks, _XYZZ_WORDS, dtype=torch.int32, device=dev)
    partial = torch.empty(nwin * -(-nchunks // group), _XYZZ_WORDS,
                          dtype=torch.int32, device=dev)
    ws = torch.empty(nwin, _XYZZ_WORDS, dtype=torch.int32, device=dev)
    out = torch.empty(3, NUM_WORDS, dtype=torch.int32, device=dev)
    err = _build.lib().mira_msm_pippenger(
        field, int(signed), sc.data_ptr(), X.data_ptr(), Y.data_ptr(),
        Z.data_ptr(), n, nwin, nchunks, group, thr.data_ptr(), acc.data_ptr(),
        partial.data_ptr(), ws.data_ptr(), out.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "msm_pippenger")
    if signed:
        pippenger_launches += 1
    else:
        pippenger_u4_launches += 1
    return (out[0], out[1], out[2])


def msm_lane_cuda(scalars: torch.Tensor, points, curve: CurveParams,
                  window: int):
    """Kernel 6 (window 4) or 7 (window 1, bit-serial), with the sum over
    lanes on the card; ops/msm.py `msm_lane_plain` is its plain version."""
    global window_launches, lane_launches
    field = _build.field_id(curve.base_modulus)
    if window not in (4, 1):
        raise ValueError(f"msm_lane_cuda: window {window} not in (4, 1)")
    n, dev, (sc, X, Y, Z) = _check_msm_args(scalars, points, "msm_lane_cuda")
    if n == 0:
        return _identity(curve, dev)
    partial = torch.empty(-(-n // LANE_BLOCK), _XYZZ_WORDS, dtype=torch.int32,
                          device=dev)
    out = torch.empty(3, NUM_WORDS, dtype=torch.int32, device=dev)
    err = _build.lib().mira_msm_lane(
        field, window, sc.data_ptr(), X.data_ptr(), Y.data_ptr(), Z.data_ptr(),
        n, curve.scalar_modulus.bit_length(), partial.data_ptr(), out.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "msm_lane")
    if window == 4:
        window_launches += 1
    else:
        lane_launches += 1
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
        return _identity(curve, dev)
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
