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

`msm_pippenger_plain` and `msm_lane_plain` are the plain versions of the
other generic-base engines of mira_tpu's `msm_pallas` (csrc/msm_pippenger.cu;
ops/cuda_msm.py `msm_lane_cuda` on the C calls of kernels 5 and 1), and
`msm(..., method=)` picks an engine by mira_tpu's method name, the plain
version for a CPU tensor and the kernel for a CUDA one.
`pippenger_msm_model` is the Pippenger kernels' chunked algorithm on these
tensors (a w = 5 table per chunk of bases, window sums added over the
chunks, one Horner), as `bucket_msm_model` and `fixed_table_model` are
kernel 1's and kernel 3b's.
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


def unsigned_digits(scalars: torch.Tensor, nwin: int, window: int) -> torch.Tensor:
    """(N, 8) plain words -> (N, nwin) int64 raw w-bit digits, window k
    holding bits [w*k, w*k + w) of the scalar (zero past bit 255)."""
    w = scalars.to(torch.int64) & 0xFFFFFFFF
    # room past bit 255: windows may start up to bit w*nwin
    w = torch.cat((w, torch.zeros_like(w[:, :2])), dim=1)
    bits = (torch.arange(nwin, device=w.device) * window).clamp(max=8 * 32)
    wi, off = bits // 32, bits % 32
    return ((w[:, wi] >> off) | (w[:, wi + 1] << (32 - off))) & ((1 << window) - 1)


def signed_digits(scalars: torch.Tensor, nwin: int,
                  window: int = WINDOW) -> torch.Tensor:
    """(N, 8) plain words -> (N, nwin) int64 signed digits in
    [-2^(w-1), 2^(w-1) - 1] with sum_k d_k * 2^(w*k) == s."""
    half = 1 << (window - 1)
    raw = unsigned_digits(scalars, nwin, window)
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


# -- kernel 1's layout on the card, as plain index arithmetic ------------------
# csrc/msm_bucket.cu recodes the scalars into signed c-bit digits, sorts the
# (point, window) pairs with a nonzero digit by bucket (window, |digit|),
# cuts the sorted records into equal segments of SEG (one thread each),
# merges the runs that cross a segment boundary in levels of MERGE_SEG heads,
# sums each window's buckets by the bits of their magnitude and joins the
# per-(window, bit) sums with weights 2^(c*w + k).  The functions below are
# that index arithmetic in plain Python/PyTorch, so that the CPU tests can
# hold it to mira_tpu; `bucket_msm_model` runs it end to end on host points.

BUCKET_MAX_WINDOW = 16  # int16 digits; 2^15 counters in a block's shared memory
SEG = 32  # sorted records per accumulate thread, about (csrc/msm_bucket.cu)
MERGE_FIRST = 2  # heads per merge thread at the first merge level
MERGE_SEG = 8  # heads per merge thread at the later levels


def bucket_window(n: int, num_bits: int = 254) -> int:
    """Kernel 1's window c for N points: the c in 2..16 with the fewest
    Montgomery products in its design, num_windows(num_bits, c) * (10 N +
    14 (c - 1) 2^(c-2)): a mixed addition per point and window, and the
    per-bit bucket sums, which add every bucket (c - 1) / 2 times on average
    where a running sum adds it twice but in a chain of 2^c.  The smaller c
    on a tie."""
    return min(range(2, BUCKET_MAX_WINDOW + 1),
               key=lambda c: (num_windows(num_bits, c)
                              * (10 * n + 14 * (c - 1) * (1 << (c - 1)) // 2), c))


def bucket_layout(scalars: torch.Tensor, live: torch.Tensor, c: int, nwin: int):
    """The sort phase: (offsets, records) of the (N, 8) plain scalars at
    window c, lanes where `live` is False (identity bases) dropped.
    records (M, 2) int64: bucket id w * 2^(c-1) + |d| - 1 and point index
    << 1 | (d < 0), ordered by bucket id (within a bucket by point index;
    the kernel's order there is any); offsets (nwin * 2^(c-1) + 1) the
    exclusive scan of the bucket counts, offsets[-1] == M."""
    nb = 1 << (c - 1)
    d = (signed_digits(scalars, nwin, c) * live.to(torch.int64)[:, None]).T
    w, i = torch.nonzero(d, as_tuple=True)
    dv = d[w, i]
    bid = w * nb + dv.abs() - 1
    order = torch.argsort(bid, stable=True)
    records = torch.stack((bid[order], ((i << 1) | (dv < 0))[order]), 1)
    counts = torch.bincount(bid, minlength=nwin * nb)
    offsets = torch.cat((torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)))
    return offsets, records


def segment_runs(keys, seg: int):
    """The equal-segment split of one level: `keys` (sorted bucket ids,
    equal keys adjacent, -1 for an empty slot) cut into segments of `seg`.
    Returns per segment its runs [(key, start, stop, head)]: `head` when the
    run began in an earlier segment (it goes to the segment's head slot),
    else the segment owns it (it goes to its bucket).  -1 keys form no run."""
    keys = [int(k) for k in keys]
    out = []
    for p0 in range(0, len(keys), seg):
        runs = []
        for p in range(p0, min(len(keys), p0 + seg)):
            k = keys[p]
            if k < 0:
                continue
            if runs and runs[-1][0] == k and runs[-1][2] == p:
                runs[-1][2] = p + 1
            else:
                head = p == p0 and p > 0 and keys[p - 1] == k
                runs.append([k, p, p + 1, head])
        out.append([tuple(r) for r in runs])
    return out


def merge_levels(nseg: int, first: int = MERGE_FIRST, rest: int = MERGE_SEG):
    """Head slots per level of the merge: the accumulate phase's nseg, then
    ceil(n / first) and ceil(n / rest) per later level until one is left
    (the kernel's loop)."""
    sizes = [nseg]
    while sizes[-1] > 1:
        sizes.append(-(-sizes[-1] // (first if len(sizes) == 1 else rest)))
    return sizes


def magnitudes_with_bit(k: int, c: int):
    """The magnitudes 1..2^(c-1) with bit k set, in the order `bucket_bits`
    (csrc/msm_bucket.cu) enumerates them."""
    nb = 1 << (c - 1)
    if k == c - 1:
        return [nb]
    return [((j >> k) << (k + 1)) | (1 << k) | (j & ((1 << k) - 1))
            for j in range(nb >> 1)]


def bucket_msm_model(scalars, points, curve: CurveParams, c: int,
                     seg: int = SEG, merge_first: int = MERGE_FIRST,
                     merge_seg: int = MERGE_SEG):
    """Kernel 1's algorithm on host points (curves/host.py AffinePoint):
    layout, equal segments with head slots and owned runs, the merge levels,
    the per-(window, bit) sums and the weights 2^(c*w + k).  scalars: ints
    below the group order; points: AffinePoints.  Returns an AffinePoint."""
    from ..curves.host import AffinePoint

    nwin = num_windows(curve.scalar_modulus.bit_length(), c)
    nb = 1 << (c - 1)
    ident = AffinePoint.identity(curve)
    live = torch.tensor([not p.is_inf for p in points])
    offsets, records = bucket_layout(
        encode_scalars(scalars, curve.scalar_modulus), live, c, nwin)
    buckets = {}
    keys = records[:, 0].tolist()
    nseg = -(-nwin * len(points) // seg)
    heads, hkeys = [ident] * nseg, [-1] * nseg
    for s, runs in enumerate(segment_runs(keys, seg)):
        for k, p0, p1, head in runs:
            acc = ident
            for r in records[p0:p1, 1].tolist():
                pt = points[r >> 1]
                acc = acc.add(pt.neg() if r & 1 else pt)
            if head:
                heads[s], hkeys[s] = acc, k
            else:
                buckets[k] = acc
    mseg = merge_first
    while len(hkeys) > 1:
        n_out = -(-len(hkeys) // mseg)
        h2, k2 = [ident] * n_out, [-1] * n_out
        for s, runs in enumerate(segment_runs(hkeys, mseg)):
            for k, p0, p1, head in runs:
                acc = ident
                for p in range(p0, p1):
                    acc = acc.add(heads[p])
                if head:
                    h2[s], k2[s] = acc, k
                else:
                    buckets[k] = buckets[k].add(acc)
        heads, hkeys = h2, k2
        mseg = merge_seg
    terms = []  # C_{w,k}, the weight of term w * c + k is 2^(w * c + k)
    for w in range(nwin):
        for k in range(c):
            C = ident
            for v in magnitudes_with_bit(k, c):
                idx = w * nb + v - 1
                if int(offsets[idx + 1]) != int(offsets[idx]):
                    C = C.add(buckets[idx])
            terms.append(C)
    total = ident
    for C in reversed(terms):
        total = total.double().add(C)
    return total


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


TABLE_BLOCK = 128  # lanes per block of csrc/fixed_table.cu (TAB_T)


def fixed_table_model(points, curve: CurveParams, window: int,
                      block: int = TABLE_BLOCK):
    """Kernel 3b's algorithm on host integers: per lane an affine doubling
    and mixed Jacobian additions (Z_{e+1} = Z_e H_e, the H's kept), then per
    block of `block` lanes a product tree of the lanes' last Z (1 for an
    identity lane), one inversion of its root and the walk back down the
    tree, and per lane the walk back down its chain.  points: AffinePoints
    of `curve`.  Returns per lane the 2^(w-1) affine (x, y) of 1P..2^(w-1)P,
    (0, 0) for an identity lane."""
    p = curve.base_modulus
    ntab = 1 << (window - 1)
    chains = []  # per lane: (live, [(X, Y)], [H], Z_last)
    for P in points:
        if P.is_inf:
            chains.append((False, None, None, 1))
            continue
        x, y = P.x.v, P.y.v
        A, B = x * x % p, y * y % p  # affine doubling, Z3 = 2y
        C = B * B % p
        D = 2 * ((x + B) ** 2 - A - C) % p
        E = 3 * A % p
        X = (E * E - 2 * D) % p
        Y = (E * (D - X) - 8 * C) % p
        Z = 2 * y % p
        xy, hs = [(x, y), (X, Y)], []
        for _ in range(2, ntab):  # + (x, y), mixed
            Z1Z1 = Z * Z % p
            H = (x * Z1Z1 - X) % p
            R = (y * Z * Z1Z1 - Y) % p
            HH = H * H % p
            HHH = H * HH % p
            V = X * HH % p
            X3 = (R * R - HHH - 2 * V) % p
            Y = (R * (V - X3) - Y * HHH) % p
            X, Z = X3, Z * H % p
            xy.append((X, Y))
            hs.append(H)
        chains.append((Z != 0, xy, hs, Z if Z else 1))
    out = []
    for b0 in range(0, len(points), block):
        lanes = chains[b0 : b0 + block]
        tree = [0] * block + [c[3] for c in lanes] + [1] * (block - len(lanes))
        for k in range(block - 1, 0, -1):
            tree[k] = tree[2 * k] * tree[2 * k + 1] % p
        tree[1] = pow(tree[1], p - 2, p)
        for k in range(1, block):
            a, b = tree[2 * k], tree[2 * k + 1]
            tree[2 * k], tree[2 * k + 1] = tree[k] * b % p, tree[k] * a % p
        for t, (live, xy, hs, _) in enumerate(lanes):
            if not live:
                out.append([(0, 0)] * ntab)
                continue
            zi = tree[block + t]
            row = [xy[0]] + [None] * (ntab - 1)
            for e in range(ntab - 1, 0, -1):
                zi2 = zi * zi % p
                row[e] = (xy[e][0] * zi2 % p, xy[e][1] * zi2 * zi % p)
                if e > 1:
                    zi = zi * hs[e - 2] % p
            out.append(row)
    return out


def tree_sum(ops, pts):
    """Sum lazy Jacobian points over the last batch axis by a halving tree
    of complete additions (the lower half plus the upper half, an identity
    appended to an odd level): (G, M) -> (G,)."""
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


def window_sums(ops, digits: torch.Tensor, table: torch.Tensor):
    """The per-window sums S_w of a table-driven MSM: digits (nwin, N)
    int64 signed or unsigned, table (N, ntab, 2, 8) affine multiples (0, 0
    for an identity lane); window w adds |d|*P_i (y negated for d < 0) over
    the lanes i.  Returns a lazy Jacobian (nwin,) point."""
    lf = ops.lf
    dev = digits.device
    nwin, n = digits.shape
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
        sums.append(tree_sum(ops, pts))
    return tuple(Lz(lf, torch.cat([lf.settle(s[i]).t for s in sums]), 1)
                 for i in range(3))


def horner(ops, S, window: int):
    """sum_w 2^(window*w) * S_w of a lazy (nwin,) point, by Horner's rule
    from the top window down."""
    nwin = S[0].shape[0]
    acc = tuple(c[nwin - 1] for c in S)
    for k in range(nwin - 2, -1, -1):
        for _ in range(window):
            acc = ops.ldouble(acc)
        acc = ops.ladd(acc, tuple(c[k] for c in S))
    return acc


@torch.inference_mode()
def msm_fixed_plain(scalars: torch.Tensor, table: torch.Tensor,
                    curve: CurveParams, window: int):
    """sum_i s_i * P_i over a table of P_i's multiples
    (`precompute_fixed_table_plain`).  scalars: (N, 8) plain words.  Signed
    w-bit digits, a lookup of |d|*P (y negated for d < 0) per (point,
    window), the sum S_w of each window, and sum_w 2^(w*k) * S_w by Horner.
    Returns a canonical Jacobian triple of (8,) word tensors."""
    ops = jacobian_ops(curve.name)
    n = scalars.shape[0]
    nwin = num_windows(curve.scalar_modulus.bit_length(), window)
    if n == 0:
        return ops.identity((), scalars.device)
    digits = signed_digits(scalars, nwin, window).T.contiguous()  # (nwin, N)
    return ops.canon(horner(ops, window_sums(ops, digits, table), window))


# -- generic-base engines: shared-Horner Pippenger and per-lane MSMs -----------
# The plain versions of kernels 4 and 5 (csrc/msm_pippenger.cu) and 6 and 7
# (ops/cuda_msm.py `msm_lane_cuda`), one step of the TPU kernel each,
# vectorised over lanes: for kernels 6 and 7 the TPU kernels' per-lane
# double-and-add, which the card's routes do not share, so that their
# equality on the card is an independent check.  Bases are affine or the
# identity (Z in {0, 1}); every point operation is the complete one, so
# duplicate and opposite bases are exact too.

PIPPENGER_WINDOW = 5  # kernel 4: signed 5-bit digits, table 1P..16P
U4_WINDOW = 4  # kernel 5: unsigned 4-bit digits, table 1P..15P
LANE_WINDOWS = {"window": 4, "lane": 1}  # kernel 6: 4-bit windows; 7: bit-serial
METHODS = ("bucket", "pippenger", "pippenger-u4", "window", "lane")


def pippenger_windows(num_bits: int, signed: bool) -> int:
    """Windows of kernel 4 (signed: one more takes the last carry) or 5."""
    if signed:
        return num_windows(num_bits, PIPPENGER_WINDOW)
    return -(-num_bits // U4_WINDOW)


def _stack(lf, pts):
    """A list of lazy (N,) points -> one lazy (len, N) point."""
    return tuple(Lz(lf, torch.stack([lf.settle(p[i]).t for p in pts]), 1)
                 for i in range(3))


def _pippenger_table(ops, P, signed: bool):
    """The per-lane multiples of kernels 4/5: 1P..16P with the odd ones
    chained off 2P and the even ones doubled from their halves (signed), or
    1P..15P by a chain of additions of P (unsigned)."""
    tab = [P, ops.ldouble(P)]
    if not signed:
        for _ in range(2, 15):
            tab.append(ops.ladd(tab[-1], P))
        return tab
    tab += [None] * 14
    for v in range(3, 16, 2):
        tab[v - 1] = ops.ladd(tab[v - 3], tab[1])
    for v in range(4, 17, 2):
        tab[v - 1] = ops.ldouble(tab[v // 2 - 1])
    return tab


@torch.inference_mode()
def msm_pippenger_plain(scalars: torch.Tensor, points, curve: CurveParams,
                        signed: bool = True):
    """Kernel 4 (signed) or 5 (unsigned) in plain PyTorch: recoded digits,
    the per-lane table of multiples, the sum over lanes of each window's
    selected multiples (y negated for a negative digit), and Horner's rule
    over the window sums.  Returns a canonical Jacobian triple."""
    ops = jacobian_ops(curve.name)
    lf = ops.lf
    dev = scalars.device
    n = scalars.shape[0]
    if n == 0:
        return ops.identity((), dev)
    window = PIPPENGER_WINDOW if signed else U4_WINDOW
    nwin = pippenger_windows(curve.scalar_modulus.bit_length(), signed)
    digits = _pippenger_digits(scalars, nwin, signed).T.contiguous()
    T = _stack(lf, _pippenger_table(ops, ops.lz(points), signed))  # (ntab, N)
    lane = torch.arange(n, device=dev)
    group = max(1, (1 << 21) // n)  # windows per pass: bounds the temporaries
    sums = []
    for w0 in range(0, nwin, group):
        d = digits[w0 : w0 + group]  # (g, N)
        idx = (d.abs() - 1).clamp(min=0)
        x, y, z = (c[idx, lane] for c in T)
        sel = (x, lf.where(d < 0, -y, y),
               lf.where(d != 0, z, lf.lz_raw(0, z.shape, dev)))
        sums.append(tree_sum(ops, sel))
    S = tuple(Lz(lf, torch.cat([lf.settle(s[i]).t for s in sums]), 1)
              for i in range(3))
    return ops.canon(horner(ops, S, window))


def _pippenger_digits(scalars: torch.Tensor, nwin: int, signed: bool):
    """(N, nwin) digits of kernel 4 (signed 5-bit) or 5 (unsigned 4-bit)."""
    if signed:
        return signed_digits(scalars, nwin, PIPPENGER_WINDOW)
    return unsigned_digits(scalars, nwin, U4_WINDOW)


@torch.inference_mode()
def pippenger_msm_model(scalars: torch.Tensor, points, curve: CurveParams,
                        signed: bool, chunk: int):
    """Kernels 4 and 5's algorithm on the port's tensors (ops/cuda_msm.py
    `pippenger_phases`): the bases cut into chunks of `chunk`; per chunk
    the w = 5 table of affine multiples 1P..16P (kernel 3b's function,
    `precompute_fixed_table_plain`), the chunk's digits (signed 5-bit, or
    unsigned 4-bit indexing the table's first 15 entries) and each window's
    sum of the looked-up entries; those window sums added over the chunks;
    one Horner (5 or 4 doublings a window).  scalars: (N, 8) plain words;
    points (X, Y, Z) affine or identity.  Returns a canonical Jacobian
    triple."""
    if chunk < 1:
        raise ValueError(f"pippenger_msm_model: chunk {chunk} < 1")
    ops = jacobian_ops(curve.name)
    n = scalars.shape[0]
    if n == 0:
        return ops.identity((), scalars.device)
    nwin = pippenger_windows(curve.scalar_modulus.bit_length(), signed)
    S = None
    for c0 in range(0, n, chunk):
        part = slice(c0, c0 + chunk)
        table = precompute_fixed_table_plain(tuple(c[part] for c in points), curve,
                                             PIPPENGER_WINDOW)
        digits = _pippenger_digits(scalars[part], nwin, signed).T.contiguous()
        sums = window_sums(ops, digits, table)
        S = sums if S is None else ops.ladd(S, sums)
    return ops.canon(horner(ops, S, PIPPENGER_WINDOW if signed else U4_WINDOW))


@torch.inference_mode()
def msm_lane_plain(scalars: torch.Tensor, points, curve: CurveParams,
                   window: int):
    """Kernel 6 (window 4) or 7 (window 1, bit-serial) in plain PyTorch:
    every lane runs double-and-add over its own scalar from the top window
    down (`window` doublings, then the lane's multiple of its digit from a
    table of 1P..(2^window - 1)P), and the lanes are summed by the halving
    tree (`tree_sum`).  Returns a canonical Jacobian triple."""
    ops = jacobian_ops(curve.name)
    lf = ops.lf
    dev = scalars.device
    n = scalars.shape[0]
    if n == 0:
        return ops.identity((), dev)
    nwin = -(-curve.scalar_modulus.bit_length() // window)
    digits = unsigned_digits(scalars, nwin, window)
    P = ops.lz(points)
    tab = [P]  # tab[d] = (d + 1) P, as the TPU's kernel 6 builds it
    for d in range(1, (1 << window) - 1):
        tab.append(ops.ldouble(tab[d // 2]) if d % 2 else ops.ladd(tab[d - 1], P))
    T = _stack(lf, tab)
    lane = torch.arange(n, device=dev)
    acc = ops.lidentity((n,), dev)
    for w in range(nwin - 1, -1, -1):
        for _ in range(window):
            acc = ops.ldouble(acc)
        d = digits[:, w]
        idx = (d - 1).clamp(min=0)
        acc = ops.lselect(d > 0, ops.ladd(acc, tuple(c[idx, lane] for c in T)), acc)
    return ops.canon(tuple(c[0] for c in tree_sum(ops, tuple(c[None] for c in acc))))


def plain_engine(method: str):
    """The plain version of the engine `method`, f(scalars, points, curve),
    on tensors of any device: what `msm` runs for a CPU tensor, and what
    the kernels are held to on the card."""
    if method not in METHODS:
        raise ValueError(f"msm: method {method!r} not in {METHODS}")
    if method == "bucket":
        return msm_plain
    if method in LANE_WINDOWS:
        return lambda s, P, c: msm_lane_plain(s, P, c, LANE_WINDOWS[method])
    return lambda s, P, c: msm_pippenger_plain(s, P, c, method == "pippenger")


def msm(scalars: torch.Tensor, points, curve: CurveParams, method: str = "bucket"):
    """sum_i s_i * P_i by the engine `method` (mira_tpu's `msm_pallas`
    names): "bucket" (kernel 1), "pippenger" (4), "pippenger-u4" (5),
    "window" (6) or "lane" (7).  scalars: (N, 8) plain words below the group
    order; points: (X, Y, Z) (N, 8) Montgomery words, affine or identity.
    A CPU tensor takes the engine's plain version, a CUDA tensor its kernel.
    Returns a canonical Jacobian triple of (8,) tensors."""
    plain = plain_engine(method)
    if scalars.device.type == "cpu":
        return plain(scalars, points, curve)
    from . import cuda_msm

    if method == "bucket":
        return cuda_msm.msm_cuda(scalars, points, curve)
    if method in LANE_WINDOWS:
        return cuda_msm.msm_lane_cuda(scalars, points, curve, LANE_WINDOWS[method])
    return cuda_msm.msm_pippenger_cuda(scalars, points, curve, method == "pippenger")
