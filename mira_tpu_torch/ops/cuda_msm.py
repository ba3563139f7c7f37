"""MSM kernels on the card: the bucket MSM (csrc/msm_bucket.cu), the port
of mira_tpu/ops/pallas_msm.py `msm_pallas(method="bucket")`; the fixed-base
MSM (csrc/msm_fixed.cu), the port of `msm_pallas_fixed`; its multiples
table (csrc/fixed_table.cu), the port of `precompute_fixed_table`; the
shared-Horner Pippenger (csrc/msm_pippenger.cu over the table build and
the accumulation of the fixed-base MSM), the port of
`msm_pallas(method="pippenger" / "pippenger-u4")`; and the ports of the
per-lane kernels of `msm_pallas(method="window")` and of its bit-serial
kernel ("lane"), which share the doublings over the call instead: the
first on the unsigned 4-bit Pippenger's C calls, the second on the bucket
MSM's (`lane_phases`).

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
from ..curves.torch_curve import jacobian_ops
from ..fields.limbs import NUM_WORDS, limb_field
from ..utils import tracing
from .msm import (
    LANE_WINDOWS,
    PIPPENGER_WINDOW,
    U4_WINDOW,
    WINDOW,
    bucket_window,
    merge_levels,
    msm_fixed_plain,
    num_windows,
    pippenger_windows,
    precompute_fixed_table_plain,
)

# bases per multiples table of kernels 4 and 5: at 2^21 bases on the H100,
# chunks of 2^18, 2^19 and 2^20 took 71.2, 72.1 and 73.3 ms and 472, 828
# and 1,596 MiB of scratch (chip_smoke.py `engine_extras`)
PIPPENGER_CHUNK = 1 << 18
FIXED_WINDOWS = (5, 6)  # the windows the fixed-base kernels are built for
_XYZZ_WORDS = 4 * NUM_WORDS
RB_SPAN = 1024  # parts per block of csrc/msm_common.cuh window_reduce
FIXED_BLOCK = 128  # threads of an accumulate block of csrc/msm_fixed.cu (FIX_T)
# csrc/msm_bucket.cu packs a record as (point index << 1 | sign) and counts
# records, offsets and cursors in 32 bits: N x nwin must stay below 2^31
BUCKET_MAX_RECORDS = 1 << 31


@lru_cache(maxsize=None)
def carry_thresholds(nwin: int, window: int = WINDOW) -> np.ndarray:
    """(nwin, 8) uint32 words of (2^(w-1) - 1) * (2^(w*k) - 1) / (2^w - 1)
    for window k: the incoming carry of window k is 1 iff the scalar's low
    w*k bits exceed it.  A threshold of 2^256 or more (no carry can arrive)
    is clamped to 2^256 - 1.  The closed form of `signed_digits`' carries,
    which the kernels thread from window to window instead; the tests hold
    the recodings to it."""
    out = np.zeros((nwin, NUM_WORDS), dtype=np.uint32)
    half = 1 << (window - 1)
    for w in range(nwin):
        t = (half - 1) * ((1 << (window * w)) - 1) // ((1 << window) - 1)
        t = min(t, (1 << 256) - 1)
        out[w] = [(t >> (32 * k)) & 0xFFFFFFFF for k in range(NUM_WORDS)]
    return out


def reduce_tmp_points(nwin: int, nparts: int) -> int:
    """XYZZ points that msm_common.cuh `reduce_windows` needs for its
    intermediate levels when it sums (nwin, nparts) points per window (at
    least one, so that the buffer has an address)."""
    total = 0
    while nparts > RB_SPAN:
        nparts = -(-nparts // RB_SPAN)
        total += nwin * nparts
    return max(1, total)


def bits_groups(c: int) -> int:
    """Blocks of csrc/msm_bucket.cu `bucket_bits` per (window, bit)."""
    return max(1, -(-(1 << (c - 2)) // RB_SPAN))


def check_bucket_records(n: int, nwin: int):
    """Raise ValueError unless kernel 1's n x nwin (point, window) records
    fit its 32-bit indices (BUCKET_MAX_RECORDS)."""
    if n * nwin >= BUCKET_MAX_RECORDS:
        raise ValueError(f"msm_bucket: {n} points x {nwin} windows = "
                         f"{n * nwin} records, at least 2^31")


def _xyzz(n: int, dev) -> torch.Tensor:
    return torch.empty(max(1, n), _XYZZ_WORDS, dtype=torch.int32, device=dev)


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


def _check_affine(Z: torch.Tensor, curve: CurveParams, what: str):
    """Raise ValueError unless every base is affine (Z = 1, Montgomery R) or
    the identity (Z = 0): kernel 3b's affine doubling and mixed additions
    take any other Z for 1.  One check on the card, one synchronisation."""
    one = limb_field(curve.base_modulus).one((1,), Z.device)
    if not ((Z == one).all(-1) | (Z == 0).all(-1)).all():
        raise ValueError(f"{what}: every base must be affine (Z = 1) or the "
                         "identity (Z = 0)")


def _identity(curve: CurveParams, dev):
    return jacobian_ops(curve.name).identity((), dev)


def msm_cuda(scalars: torch.Tensor, points, curve: CurveParams):
    """Kernel 1, the bucket MSM; ops/msm.py `msm_plain` is its plain version.
    scalars: (N, 8) plain words (< the group order); points: (X, Y, Z)
    (N, 8) Montgomery words, affine or identity (Z in {0, 1}).  Returns a
    canonical Jacobian triple of (8,) tensors.  Duplicate and opposite
    bases, zero scalars and identity lanes are exact (complete XYZZ
    formulas, no offset point)."""
    phases, out = bucket_phases(scalars, points, curve)
    if out is None:
        return phases
    for name, run in phases:
        _build.check(run(), f"msm_bucket {name}")
    tracing.count("msm_bucket")
    return (out[0], out[1], out[2])


def bucket_phases(scalars: torch.Tensor, points, curve: CurveParams,
                  c: int = 0):
    """Kernel 1 as its four C calls: ([(phase, call)], out), the calls
    returning a cudaError_t, to be made in order ("sort", "accumulate",
    "reduce", "finish"); `msm_cuda` makes them, and a timing harness may
    time them one by one.  c: the window, bucket_window(N) unless given.
    For N = 0 returns (the identity, None)."""
    field = _build.field_id(curve.base_modulus)
    n, dev, (sc, X, Y, Z) = _check_msm_args(scalars, points, "msm_cuda")
    if n == 0:
        return _identity(curve, dev), None
    c = c or bucket_window(n, curve.scalar_modulus.bit_length())
    nwin = num_windows(curve.scalar_modulus.bit_length(), c)
    check_bucket_records(n, nwin)
    m = nwin << (c - 1)
    i32 = dict(dtype=torch.int32, device=dev)
    digits = torch.empty(nwin, n, dtype=torch.int16, device=dev)
    counts, cursor = torch.empty(m, **i32), torch.empty(m, **i32)
    offsets = torch.empty(m + 1, **i32)
    records = torch.empty(nwin * n, 2, **i32)
    lib, st = _build.lib(), _build.stream_ptr(dev)
    seg = lib.mira_msm_bucket_seg(field, n, nwin)  # ~SEG, whole waves
    nseg = -(-nwin * n // seg)
    slots = sum(merge_levels(nseg))
    buckets, heads = _xyzz(m, dev), _xyzz(slots, dev)
    hkeys = torch.empty(slots, **i32)
    ng = bits_groups(c)
    bits, tmp = _xyzz(nwin * c * ng, dev), _xyzz(reduce_tmp_points(nwin, c * ng), dev)
    ws = _xyzz(nwin, dev)
    out = torch.empty(3, NUM_WORDS, **i32)
    ptr = torch.Tensor.data_ptr
    phases = [
        ("sort", lambda: lib.mira_msm_bucket_sort(
            ptr(sc), ptr(Z), n, c, nwin, ptr(digits), ptr(counts), ptr(offsets),
            ptr(cursor), ptr(records), st)),
        ("accumulate", lambda: lib.mira_msm_bucket_acc(
            field, ptr(records), ptr(offsets), m, nseg, seg, ptr(X), ptr(Y),
            ptr(buckets), ptr(heads), ptr(hkeys), st)),
        ("reduce", lambda: lib.mira_msm_bucket_reduce(
            field, nseg, c, nwin, ptr(offsets), ptr(buckets), ptr(heads),
            ptr(hkeys), ptr(bits), ptr(tmp), ptr(ws), st)),
        ("finish", lambda: lib.mira_msm_bucket_finish(
            field, ptr(ws), nwin, c, ptr(out), st)),
    ]
    return phases, out


def pippenger_chunks(n: int, chunk: int = PIPPENGER_CHUNK):
    """Kernels 4 and 5's chunks of the bases: [(first base, bases)], each of
    at most `chunk` bases, whose tables are built and consumed one after
    another in one scratch buffer."""
    if chunk < 1:
        raise ValueError(f"msm_pippenger: chunk {chunk} < 1")
    return [(c0, min(chunk, n - c0)) for c0 in range(0, n, chunk)]


def pippenger_scratch_bytes(nwin: int, largest_chunk: int, nparts: int) -> int:
    """Device bytes of kernels 4 and 5's scratch for one call: the w = 5
    table of the largest chunk and its chain factors (1 KiB + 448 B a base),
    its digits (2 B a base and window), the window partials of every chunk
    side by side, the reduce's levels and the window sums (128 B a point),
    and the output (96 B)."""
    ntab = 1 << (PIPPENGER_WINDOW - 1)
    per_base = ntab * 64 + (ntab - 2) * 32 + 2 * nwin
    points = nwin * nparts + reduce_tmp_points(nwin, nparts) + nwin
    return largest_chunk * per_base + points * _XYZZ_WORDS * 4 + 3 * NUM_WORDS * 4


def msm_pippenger_cuda(scalars: torch.Tensor, points, curve: CurveParams,
                       signed: bool = True, chunk: int = PIPPENGER_CHUNK):
    """Kernel 4 (signed 5-bit digits) or 5 (unsigned 4-bit); ops/msm.py
    `msm_pippenger_plain` is its plain version, `pippenger_msm_model` its
    algorithm.  Bases affine or identity (others raise ValueError); duplicate
    and opposite bases, identity lanes and zero scalars are exact (complete
    XYZZ formulas).  Returns a canonical Jacobian triple of (8,) tensors.
    Counted as `msm_pippenger` or `msm_pippenger_u4` alone: its table build
    and accumulation are kernels 3b's and 3's code, but not their calls."""
    phases, out = pippenger_phases(scalars, points, curve, signed, chunk)
    if out is None:
        return phases
    for name, run in phases:
        _build.check(run(), f"msm_pippenger {name}")
    tracing.count("msm_pippenger" if signed else "msm_pippenger_u4")
    return (out[0], out[1], out[2])


def pippenger_phases(scalars: torch.Tensor, points, curve: CurveParams,
                     signed: bool = True, chunk: int = PIPPENGER_CHUNK):
    """Kernels 4 and 5 as their C calls: ([(phase, call)], out), to be made
    in order, as `bucket_phases`.  Per chunk of at most `chunk` bases
    (`pippenger_chunks`): "table" (kernel 3b's w = 5 table of the chunk's
    bases), "recode" (its scalars' digits, window-major) and "accumulate"
    (kernel 3's accumulation at w = 5, its partials in the chunk's columns
    of one (nwin, parts) array); then one "finish" (the reduce over every
    chunk's partials and one Horner).  For N = 0 returns (the identity,
    None)."""
    what = "msm_pippenger_cuda"
    field = _build.field_id(curve.base_modulus)
    n, dev, (sc, X, Y, Z) = _check_msm_args(scalars, points, what)
    chunks = pippenger_chunks(n, chunk)
    if n == 0:
        return _identity(curve, dev), None
    _check_affine(Z, curve, what)
    nwin = pippenger_windows(curve.scalar_modulus.bit_length(), signed)
    w = PIPPENGER_WINDOW
    lib, st = _build.lib(), _build.stream_ptr(dev)
    nblks = [lib.mira_msm_fixed_blocks(field, w, nc, nwin) for _, nc in chunks]
    nparts = FIXED_BLOCK * sum(nblks)
    m = chunks[0][1]  # the largest chunk
    ntab = 1 << (w - 1)
    i32 = dict(dtype=torch.int32, device=dev)
    tab = torch.empty(m, ntab, 2, NUM_WORDS, **i32)
    hs = torch.empty(ntab - 2, m, NUM_WORDS, **i32)  # kernel 3b's chain factors
    digits = torch.empty(nwin, m, dtype=torch.int16, device=dev)
    parts = _xyzz(nwin * nparts, dev)
    tmp, ws = _xyzz(reduce_tmp_points(nwin, nparts), dev), _xyzz(nwin, dev)
    out = torch.empty(3, NUM_WORDS, **i32)

    def call(fn, *args):
        # the closure holds the tensors (views of a chunk's rows included)
        # until the call, which passes their data pointers
        return lambda: fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                            for a in args))

    phases, col = [], 0
    for (c0, nc), nblk in zip(chunks, nblks):
        rows = slice(c0, c0 + nc)
        phases += [
            ("table", call(lib.mira_fixed_table, field, X[rows], Y[rows], Z[rows],
                           nc, w, tab, hs, st)),
            ("recode", call(lib.mira_msm_pippenger_recode, sc[rows], nc,
                            int(signed), nwin, digits, st)),
            ("accumulate", call(lib.mira_msm_fixed_acc, field, w, digits, tab, nc,
                                nwin, nblk, parts[col:], nparts, st)),
        ]
        col += nblk * FIXED_BLOCK
    phases.append(("finish", call(
        lib.mira_msm_pippenger_finish, field, w if signed else U4_WINDOW, parts,
        nwin, nparts, tmp, ws, out, st)))
    return phases, out


def lane_parts(n: int, num_bits: int, records: int = BUCKET_MAX_RECORDS):
    """Kernel 7's parts of its n bases: [(first base, bases)], consecutive
    and none empty, the fewest parts of near-equal size each of whose
    bases x num_windows(num_bits, bucket_window(bases)) records stays below
    `records` (kernel 1's limit, `check_bucket_records`, unless a smaller
    one is given).  One part up to ~2^26.9 bases at 254 bits."""
    k = 1
    while n:
        m = -(-n // k)
        parts = [(c0, min(m, n - c0)) for c0 in range(0, n, m)]
        if all(nc * num_windows(num_bits, bucket_window(nc, num_bits)) < records
               for _, nc in parts):
            return parts
        k += 1
    return []


def lane_phases(scalars: torch.Tensor, points, curve: CurveParams, window: int,
                records: int = BUCKET_MAX_RECORDS):
    """Kernel 6 (window 4) or 7 (window 1) as C calls, one part of the
    bases at a time: yields ([(phase, call)], out) per part, each part's
    scratch allocated when it is reached.  Kernel 6 is one part, kernel 5's
    `pippenger_phases(signed=False)` (the unsigned 4-bit digits and the
    1P..15P multiples of the TPU kernel, summed per window over the lanes
    and joined by one Horner); kernel 7 is kernel 1's `bucket_phases` over
    each of `lane_parts`, at the part's own window (no table of multiples,
    as the TPU kernel keeps none).  Bases with N = 0 yield nothing."""
    if window not in LANE_WINDOWS.values():
        raise ValueError(f"msm_lane_cuda: window {window} not in (4, 1)")
    n = scalars.shape[0]
    if n == 0:
        return
    if window == 4:
        yield pippenger_phases(scalars, points, curve, signed=False)
        return
    for c0, nc in lane_parts(n, curve.scalar_modulus.bit_length(), records):
        rows = slice(c0, c0 + nc)
        yield bucket_phases(scalars[rows], tuple(c[rows] for c in points), curve)


def msm_lane_cuda(scalars: torch.Tensor, points, curve: CurveParams,
                  window: int, records: int = BUCKET_MAX_RECORDS):
    """Kernel 6 (window 4) or 7 (window 1, bit-serial); ops/msm.py
    `msm_lane_plain`, the TPU kernels' per-lane double-and-add, is its
    plain version.  scalars: (N, 8) plain words below the group order;
    points: (X, Y, Z) (N, 8) Montgomery words, affine or identity (kernel 6
    raises ValueError on others).  The calls of `lane_phases`, the parts'
    results added by the complete Jacobian addition; `records` as in
    `lane_parts`.  Returns a canonical Jacobian triple of (8,) tensors.
    Counted as `msm_window` or `msm_lane` alone, never as the kernels whose
    C calls it makes."""
    _, dev, _ = _check_msm_args(scalars, points, "msm_lane_cuda")
    total = None
    for phases, out in lane_phases(scalars, points, curve, window, records):
        for name, run in phases:
            _build.check(run(), f"msm_lane {name}")
        del phases  # the part's scratch, before the next part's
        part = (out[0], out[1], out[2])
        total = part if total is None else jacobian_ops(curve.name).add(total, part)
    if total is None:  # N = 0: nothing launched
        return _identity(curve, dev)
    tracing.count("msm_window" if window == 4 else "msm_lane")
    return total


def fixed_table(points, curve: CurveParams, window: int) -> torch.Tensor:
    """The (N, 2^(w-1), 2, 8) table of affine multiples 1P..(2^(w-1))P of
    bases (X, Y, Z) (N, 8) Montgomery words, affine or identity; an
    identity base gets (0, 0) entries."""
    if points[0].device.type == "cpu":
        return precompute_fixed_table_plain(points, curve, window)
    return fixed_table_cuda(points, curve, window)


def fixed_table_cuda(points, curve: CurveParams, window: int) -> torch.Tensor:
    """Kernel 3b (csrc/fixed_table.cu); `precompute_fixed_table_plain` is its
    plain version, `fixed_table_model` its algorithm on host integers.  The
    bases must be affine (Z = 1) or the identity (Z = 0): the kernel's
    affine doubling and mixed additions take any other Z for 1, so other
    bases raise ValueError (one check on the card per build)."""
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
    _check_affine(Z, curve, "fixed_table_cuda")
    ntab = 1 << (window - 1)
    tab = torch.empty(n, ntab, 2, NUM_WORDS, dtype=torch.int32, device=dev)
    if n == 0:
        return tab
    # the chain's factors H_e, Z_{e+1} = Z_e H_e, for the walk back
    hs = torch.empty(ntab - 2, n, NUM_WORDS, dtype=torch.int32, device=dev)
    err = _build.lib().mira_fixed_table(
        field, X.data_ptr(), Y.data_ptr(), Z.data_ptr(), n, window,
        tab.data_ptr(), hs.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "fixed_table")
    tracing.count("fixed_table")
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
    phases, out = fixed_phases(scalars, table, curve, window)
    if out is None:
        return phases
    for name, run in phases:
        _build.check(run(), f"msm_fixed {name}")
    tracing.count("msm_fixed")
    return (out[0], out[1], out[2])


def fixed_phases(scalars: torch.Tensor, table: torch.Tensor,
                 curve: CurveParams, window: int):
    """Kernel 3 as its three C calls: ([(phase, call)], out), to be made in
    order ("recode", "accumulate", "finish"), as `bucket_phases`."""
    field = _build.field_id(curve.base_modulus)
    if window not in FIXED_WINDOWS:
        raise ValueError(f"msm_fixed_cuda: window {window} not in {FIXED_WINDOWS}")
    n = scalars.shape[0]
    dev = scalars.device
    ntab = 1 << (window - 1)
    if (scalars.dtype != torch.int32 or tuple(scalars.shape) != (n, NUM_WORDS)
            or dev.type != "cuda" or table.device != dev
            or table.dtype != torch.int32
            or tuple(table.shape) != (n, ntab, 2, NUM_WORDS)):
        raise ValueError("msm_fixed_cuda: expects (N, 8) int32 scalars and an "
                         f"(N, {ntab}, 2, 8) int32 table on one CUDA device")
    if n == 0:
        return _identity(curve, dev), None
    scalars, table = scalars.contiguous(), table.contiguous()
    nwin = num_windows(curve.scalar_modulus.bit_length(), window)
    lib, st = _build.lib(), _build.stream_ptr(dev)
    nblk = lib.mira_msm_fixed_blocks(field, window, n, nwin)
    digits = torch.empty(nwin, n, dtype=torch.int16, device=dev)
    nparts = nblk * FIXED_BLOCK  # one accumulator per thread
    partial, ws = _xyzz(nwin * nparts, dev), _xyzz(nwin, dev)
    tmp = _xyzz(reduce_tmp_points(nwin, nparts), dev)
    out = torch.empty(3, NUM_WORDS, dtype=torch.int32, device=dev)
    ptr = torch.Tensor.data_ptr
    phases = [
        ("recode", lambda: lib.mira_msm_fixed_recode(
            ptr(scalars), n, window, nwin, ptr(digits), st)),
        ("accumulate", lambda: lib.mira_msm_fixed_acc(
            field, window, ptr(digits), ptr(table), n, nwin, nblk, ptr(partial),
            nparts, st)),
        ("finish", lambda: lib.mira_msm_fixed_finish(
            field, window, ptr(partial), nwin, nblk, ptr(tmp), ptr(ws), ptr(out),
            st)),
    ]
    return phases, out
