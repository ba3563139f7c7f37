"""Multi-scalar multiplication: scalar encoding and the plain PyTorch MSMs
(port of mira_tpu/ops/msm.py and of the fixed-base table build of
mira_tpu/ops/pallas_msm.py).

`msm_plain` is the plain version of the CUDA bucket kernel
(ops/cuda_msm.py, csrc/msm_bucket.cu): the same sum_i s_i * P_i, computed
with vectorised tensor ops.  Scalars are recoded into signed 5-bit digits
(the carry threaded window by window); every (window, digit) pair with a
nonzero digit becomes an entry of bucket (window, |digit|); entries are
sorted by bucket and summed by a segmented halving tree of complete
Jacobian additions; each window then forms sum_v v*B_v by running sums and
Horner's rule joins the windows.

`precompute_fixed_table_plain` and `msm_fixed_plain` are the plain versions
of the fixed-base kernels (csrc/fixed_table.cu, csrc/msm_fixed.cu): a table
of the affine multiples 1P..(2^(w-1))P of every base, and an MSM that looks
each signed w-bit digit up in it, sums each window and joins the windows by
Horner's rule.
"""

from __future__ import annotations

import torch

from ..curves.host import CurveParams

from ..curves.torch_curve import jacobian_ops
from ..fields.limbs import Lz, ints_to_words

WINDOW = 5
NBUCKET = 1 << (WINDOW - 1)  # digit magnitudes 1..16


def num_windows(num_bits: int, window: int = WINDOW) -> int:
    """Signed-digit windows for scalars of num_bits bits (one extra window
    takes the final carry)."""
    return (num_bits + window - 1) // window + 1


def fixed_base_window(n: int) -> int:
    """Table window of a fixed-base MSM of width n: mira_tpu's rule
    (pallas_msm.py `fixed_base_window`), so that the port builds the same
    tables for the same widths; w = 5 halves the table past 2^20 points."""
    return 6 if n <= (1 << 20) else 5


def encode_scalars(values, scalar_modulus: int, device="cpu") -> torch.Tensor:
    """Scalars (ints / host field elements) -> PLAIN (non-Montgomery) words."""
    ints = [(v if isinstance(v, int) else v.v) % scalar_modulus for v in values]
    return torch.from_numpy(ints_to_words(ints)).to(device)


def signed_digits(scalars: torch.Tensor, nwin: int,
                  window: int = WINDOW) -> torch.Tensor:
    """(N, 8) plain words -> (N, nwin) int64 signed digits in
    [-2^(w-1), 2^(w-1) - 1] with sum_k d_k * 2^(w*k) == s."""
    half = 1 << (window - 1)
    w = scalars.to(torch.int64) & 0xFFFFFFFF
    # room past bit 255: windows may start up to bit w*nwin
    w = torch.cat((w, torch.zeros_like(w[:, :2])), dim=1)
    bits = (torch.arange(nwin, device=w.device) * window).clamp(max=8 * 32)
    wi, off = bits // 32, bits % 32
    raw = ((w[:, wi] >> off) | (w[:, wi + 1] << (32 - off))) & (2 * half - 1)
    digits = torch.empty_like(raw)
    carry = torch.zeros_like(raw[:, 0])
    for k in range(nwin):
        t = raw[:, k] + carry
        carry = (t >= half).to(torch.int64)
        digits[:, k] = t - 2 * half * carry
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


# -- fixed-base MSM ----------------------------------------------------------
# A table holds, for each base P_i and v = 1..ntab (ntab = 2^(w-1)), the
# affine multiple v*P_i as (x, y) Montgomery words: shape (N, ntab, 2, 8),
# so one lookup is 64 contiguous bytes.  The identity's multiples are stored
# as (0, 0), which lies on neither curve (b != 0) and marks the identity.


@torch.inference_mode()
def precompute_fixed_table_plain(points, curve: CurveParams, window: int):
    """(X, Y, Z) (N, 8) Montgomery words, affine or identity -> the
    (N, 2^(w-1), 2, 8) table of affine multiples: Jacobian multiples
    1P..vP, then one batch inversion of their Z per lane."""
    ops = jacobian_ops(curve.name)
    lf = ops.lf
    ntab = 1 << (window - 1)
    mults = [tuple(points)]
    if ntab >= 2:
        mults.append(ops.double(mults[0]))
    for _ in range(3, ntab + 1):
        mults.append(ops.add(mults[-1], mults[0]))
    Zs = [m[2] for m in mults]
    prefix = [Zs[0]]
    for v in range(1, ntab):
        prefix.append(lf.mul(prefix[-1], Zs[v]))
    run = lf.inv(prefix[-1])  # 0 on an identity lane, which zeroes it
    invs = [None] * ntab
    for v in range(ntab - 1, 0, -1):
        invs[v] = lf.mul(run, prefix[v - 1])
        run = lf.mul(run, Zs[v])
    invs[0] = run
    cols = []
    for (X, Y, _), zi in zip(mults, invs):
        zi2 = lf.square(zi)
        cols.append(torch.stack((lf.mul(X, zi2), lf.mul(Y, lf.mul(zi2, zi))), 1))
    return torch.stack(cols, 1)


def _tree_sum(ops, pts):
    """Sum lazy Jacobian points over the last batch axis by a halving tree
    of complete additions: (G, M) -> (G,)."""
    while pts[0].shape[1] > 1:
        m = pts[0].shape[1]
        if m % 2:
            ident = ops.lidentity((pts[0].shape[0], 1), pts[0].t.device)
            pts = tuple(Lz(c.f, torch.cat((c.t, i.t), -2), max(c.w, i.w))
                        for c, i in zip(pts, ident))
            m += 1
        h = m // 2
        pts = ops.ladd(tuple(c[:, :h] for c in pts), tuple(c[:, h:] for c in pts))
    return tuple(c[:, 0] for c in pts)


@torch.inference_mode()
def msm_fixed_plain(scalars: torch.Tensor, table: torch.Tensor,
                    curve: CurveParams, window: int):
    """sum_i s_i * P_i over a table of P_i's multiples
    (`precompute_fixed_table_plain`).  scalars: (N, 8) plain words.  Signed
    w-bit digits, a lookup of |d|*P (y negated for d < 0) per (point,
    window), the sum S_w of each window, and sum_w 2^(w*k) * S_w by Horner.
    Returns a canonical Jacobian triple of (8,) word tensors."""
    ops = jacobian_ops(curve.name)
    lf = ops.lf
    dev = scalars.device
    n = scalars.shape[0]
    nwin = num_windows(curve.scalar_modulus.bit_length(), window)
    if n == 0:
        return ops.identity((), dev)
    digits = signed_digits(scalars, nwin, window).T.contiguous()  # (nwin, N)
    lane = torch.arange(n, device=dev)
    group = max(1, (1 << 21) // n)  # windows per pass: bounds the temporaries
    sums = []
    for w0 in range(0, nwin, group):
        d = digits[w0 : w0 + group]
        ent = table[lane, (d.abs() - 1).clamp(min=0)]  # (g, N, 2, 8)
        x, y = ent[..., 0, :], ent[..., 1, :]
        live = (d != 0) & ~(lf.is_zero(x) & lf.is_zero(y))
        ey = lf.lz(y)
        pts = (lf.lz(x), lf.where(d < 0, -ey, ey),
               lf.lz(lf.select(live, lf.one(live.shape, dev), lf.zero(live.shape, dev))))
        sums.append(_tree_sum(ops, pts))
    S = tuple(Lz(lf, torch.cat([lf.settle(s[i]).t for s in sums]), 1)
              for i in range(3))
    acc = tuple(c[nwin - 1] for c in S)
    for k in range(nwin - 2, -1, -1):
        for _ in range(window):
            acc = ops.ldouble(acc)
        acc = ops.ladd(acc, tuple(c[k] for c in S))
    return ops.canon(acc)
