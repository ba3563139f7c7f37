"""Multi-scalar multiplication: scalar encoding and the plain PyTorch bucket
MSM (port of mira_tpu/ops/msm.py).

`msm_plain` is the plain version of the CUDA bucket kernel
(ops/cuda_msm.py, csrc/msm_bucket.cu): the same sum_i s_i * P_i, computed
with vectorised tensor ops.  Scalars are recoded into signed 5-bit digits
(the carry threaded window by window); every (window, digit) pair with a
nonzero digit becomes an entry of bucket (window, |digit|); entries are
sorted by bucket and summed by a segmented halving tree of complete
Jacobian additions; each window then forms sum_v v*B_v by running sums and
Horner's rule joins the windows.
"""

from __future__ import annotations

import torch

from mira_tpu.curves.host import CurveParams

from ..curves.torch_curve import jacobian_ops
from ..fields.limbs import Lz, ints_to_words

WINDOW = 5
NBUCKET = 1 << (WINDOW - 1)  # digit magnitudes 1..16


def num_windows(num_bits: int) -> int:
    """Signed-digit windows for scalars of num_bits bits (one extra window
    takes the final carry)."""
    return (num_bits + WINDOW - 1) // WINDOW + 1


def encode_scalars(values, scalar_modulus: int, device="cpu") -> torch.Tensor:
    """Scalars (ints / host field elements) -> PLAIN (non-Montgomery) words."""
    ints = [(v if isinstance(v, int) else v.v) % scalar_modulus for v in values]
    return torch.from_numpy(ints_to_words(ints)).to(device)


def signed_digits(scalars: torch.Tensor, nwin: int) -> torch.Tensor:
    """(N, 8) plain words -> (N, nwin) int64 signed digits in [-16, 15] with
    sum_w d_w * 32^w == s."""
    w = scalars.to(torch.int64) & 0xFFFFFFFF
    w = torch.cat((w, torch.zeros_like(w[:, :2])), dim=1)  # room past bit 255
    bits = torch.arange(nwin, device=w.device) * WINDOW
    wi, off = bits // 32, bits % 32
    raw = ((w[:, wi] >> off) | (w[:, wi + 1] << (32 - off))) & 31
    digits = torch.empty_like(raw)
    carry = torch.zeros_like(raw[:, 0])
    for k in range(nwin):
        t = raw[:, k] + carry
        carry = (t >= NBUCKET).to(torch.int64)
        digits[:, k] = t - 2 * NBUCKET * carry
    return digits


def _segment_sum(ops, ids: torch.Tensor, pts):
    """Sum lazy Jacobian points sharing an id; ids sorted.  Returns
    (unique ids, sums) by a halving tree within each segment."""
    while True:
        m = ids.shape[0]
        pos = torch.arange(m, device=ids.device)
        first = torch.ones(m, dtype=torch.bool, device=ids.device)
        first[1:] = ids[1:] != ids[:-1]
        start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0)[0]
        rank = pos - start
        ev = torch.nonzero(rank % 2 == 0).squeeze(1)
        nxt = torch.clamp(ev + 1, max=m - 1)
        partner = (ev + 1 < m) & (ids[nxt] == ids[ev])
        if not bool(partner.any()):
            return ids, pts
        a = tuple(c[ev] for c in pts)
        b = tuple(c[nxt] for c in pts)
        pts = ops.lselect(partner, ops.ladd(a, b), a)
        ids = ids[ev]


@torch.inference_mode()
def msm_plain(scalars: torch.Tensor, points, curve: CurveParams):
    """scalars: (N, 8) plain words (< the group order); points: (X, Y, Z)
    (N, 8) Montgomery words, affine or identity (Z in {0, 1}).  Returns a
    canonical Jacobian triple of (8,) word tensors."""
    ops = jacobian_ops(curve.name)
    lf = ops.lf
    dev = scalars.device
    X, Y, Z = points
    nwin = num_windows(curve.scalar_modulus.bit_length())
    digits = signed_digits(scalars, nwin)
    digits = digits * (~lf.is_zero(Z)).to(torch.int64)[:, None]
    pt_idx, win = torch.nonzero(digits, as_tuple=True)
    if pt_idx.numel() == 0:
        return ops.identity((), dev)
    d = digits[pt_idx, win]
    ids = win * NBUCKET + d.abs() - 1
    order = torch.argsort(ids, stable=True)
    ids, pt_idx, neg = ids[order], pt_idx[order], (d[order] < 0)

    ex = lf.lz(X[pt_idx])
    ey = lf.lz(Y[pt_idx])
    ey = lf.where(neg, -ey, ey)
    ez = lf.lz(Z[pt_idx])
    ids, sums = _segment_sum(ops, ids, (ex, ey, ez))

    # dense (window, magnitude) bucket table, identity where empty
    top = int(ids.max()) // NBUCKET + 1
    buckets = ops.lidentity((top * NBUCKET,), dev)
    buckets = tuple(
        Lz(lf, b.t.clone().index_copy_(0, ids, lf.settle(s).t), 1)
        for b, s in zip(buckets, sums)
    )
    buckets = tuple(Lz(lf, b.t.reshape(top, NBUCKET, -1), 1) for b in buckets)

    # per window: sum_v v * B_v by running sums from the top magnitude
    run = ops.lidentity((top,), dev)
    tot = run
    for v in range(NBUCKET - 1, -1, -1):
        run = ops.ladd(run, tuple(b[:, v] for b in buckets))
        tot = ops.ladd(tot, run)

    acc = tuple(c[top - 1] for c in tot)
    for w in range(top - 2, -1, -1):
        for _ in range(WINDOW):
            acc = ops.ldouble(acc)
        acc = ops.ladd(acc, tuple(c[w] for c in tot))
    return ops.canon(acc)
