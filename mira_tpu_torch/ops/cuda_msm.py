"""Bucket MSM on the card (csrc/msm_bucket.cu), the port of
mira_tpu/ops/pallas_msm.py `msm_pallas(method="bucket")`.

`msm` takes a CPU tensor to the plain version (ops/msm.py `msm_plain`) and a
CUDA tensor to the kernel; there is no fallback between the two.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from mira_tpu.curves.host import CurveParams

from .. import _build
from ..fields.limbs import NUM_WORDS
from .msm import NBUCKET, WINDOW, msm_plain, num_windows

launches = 0  # kernel launches (one per MSM on the card)
_XYZZ_WORDS = 4 * NUM_WORDS
REDUCE_GROUP = 32  # chunks per thread in the kernel's first bucket-reduce pass


@lru_cache(maxsize=None)
def carry_thresholds(nwin: int) -> np.ndarray:
    """(nwin, 8) uint32 words of 15 * (32^w - 1) / 31: the incoming carry of
    window w is 1 iff the scalar's low 5w bits exceed it."""
    out = np.zeros((nwin, NUM_WORDS), dtype=np.uint32)
    for w in range(nwin):
        t = (NBUCKET - 1) * ((1 << (WINDOW * w)) - 1) // ((1 << WINDOW) - 1)
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
    thr = _thresholds_on(nwin, dev)
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


_thr_cache = {}


def _thresholds_on(nwin: int, dev) -> torch.Tensor:
    key = (nwin, str(dev))
    t = _thr_cache.get(key)
    if t is None:
        t = torch.from_numpy(carry_thresholds(nwin).view(np.int32)).to(dev)
        _thr_cache[key] = t
    return t
