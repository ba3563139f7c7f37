"""NTT kernels on the card: the four-step transform (csrc/ntt_fourstep.cu),
the port of mira_tpu/ops/ntt.py `_ntt_fourstep_jit`, and the per-stage
butterfly (csrc/ntt_stage.cu), the port of `_ntt_pallas_jit`.  ops/ntt.py
`ntt` dispatches here for CUDA tensors; the plain versions live there
(`ntt_plain`, `stage_plain`).  Nothing here falls back to them.

Every entry point takes one (n, 8) array or a batch (B, n, 8) of arrays of
one size; a batch is one launch of each kernel (more blocks), not a loop.

The four-step transform is two or three column passes of one kernel
(`fourstep_split` says which, `fourstep_passes` gives each pass's strides,
tile and twiddle); tests/test_torch_ntt.py's `fourstep_model` runs the same
passes in plain PyTorch, index for index.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import _build
from ..fields.limbs import NUM_WORDS, limb_field
from ..utils import tracing
from .ntt import _log2, _twiddle_table, get_omega, power_table

FOURSTEP_MIN_LOG = 2  # n1 = 2^(log n // 2) must be at least 2
FOURSTEP_MAX_LOG = 24  # the sizes the kernel is tested and timed at
# From this size on the transform is three passes (size-n2 columns cut in
# two), below it two: a 2^11 column would need 512 threads at 4 a thread,
# more than a tile holds.
THREE_PASS_MIN_LOG = 21
# From this size on a thread holds 4 elements of its column (2 stages a
# group), below it 2 (a group a stage): the smaller transforms are bound by
# a thread's chain of products, the larger by the products' rate.
RADIX4_MIN_LOG = 18
# csrc/ntt_fourstep.cu `PassArgs`, in order
PASS_FIELDS = ("lm", "R", "C", "log_w", "sh_in", "sl_in", "sp_in", "sh_out",
               "sl_out", "sp_out", "twiddle", "lo_mask", "kmul", "hmul",
               "log_n", "log_lo", "bstride", "ncols", "load_cfast",
               "store_cfast")


def _check(a: torch.Tensor, what: str) -> int:
    """Validate an (n, 8) or (B, n, 8) word tensor; returns the batch B."""
    if (a.device.type != "cuda" or a.dtype != torch.int32 or a.dim() not in (2, 3)
            or a.shape[-1] != NUM_WORDS):
        raise ValueError(f"{what}: expects an (n, 8) or (B, n, 8) int32 tensor "
                         "on a CUDA device")
    return a.shape[0] if a.dim() == 3 else 1


@lru_cache(maxsize=None)
def _scale(modulus: int, n: int, device: str) -> torch.Tensor:
    """The inverse transform's divisor 1/n as one Montgomery element."""
    return limb_field(modulus).const(pow(n, -1, modulus), (1,),
                                     device).contiguous()


def stage_cuda(a: torch.Tensor, tw: torch.Tensor, half: int, modulus: int,
               gather: bool = False, scale=None, out=None):
    """One butterfly stage (ops/ntt.py `stage_plain` is its plain version).
    `gather` reads the inputs through the bit reversal
    of their indices (the transform's first stage); `scale` multiplies both
    outputs by one element (its last); `out` may be `a` itself unless
    `gather`."""
    field = _build.field_id(modulus)
    batch = _check(a, "stage_cuda")
    n = a.shape[-2]
    log_n = _log2(n)
    log_half = _log2(half)
    if log_n < 1 or log_half >= log_n:
        raise ValueError(f"stage_cuda: half {half} does not fit size {n}")
    if tuple(tw.shape) != (n // 2, NUM_WORDS) or tw.device != a.device:
        raise ValueError("stage_cuda: expects an (n/2, 8) twiddle table on "
                         "the device of the input")
    a, tw = a.contiguous(), tw.contiguous()
    if out is None:
        out = torch.empty_like(a)
    if gather and out.data_ptr() == a.data_ptr():
        raise ValueError("stage_cuda: a gathering stage cannot run in place")
    err = _build.lib().mira_ntt_stage(
        field, a.data_ptr(), out.data_ptr(), tw.data_ptr(), log_n, log_half,
        int(gather), None if scale is None else scale.data_ptr(), batch,
        _build.stream_ptr(a.device))
    _build.check(err, "ntt_stage")
    tracing.count("ntt_stage")
    return out


def ntt_stage_cuda(a: torch.Tensor, modulus: int, inverse: bool = False):
    """The whole transform as log n stage launches: the first gathers through
    the bit reversal into a new buffer, the rest run in place on it, the last
    carries the inverse's 1/n."""
    _check(a, "ntt_stage_cuda")
    n = a.shape[-2]
    log_n = _log2(n)
    if log_n == 0:
        return a
    dev = str(a.device)
    tw = _twiddle_table(modulus, log_n, inverse, dev)
    scale = _scale(modulus, n, dev) if inverse else None
    out = stage_cuda(a, tw, 1, modulus, gather=True,
                     scale=scale if log_n == 1 else None)
    for s in range(1, log_n):
        stage_cuda(out, tw, 1 << s, modulus, out=out,
                   scale=scale if s == log_n - 1 else None)
    return out


def fourstep_split(log_n: int, passes: int = 0) -> tuple:
    """Column logs of the four-step passes, in order: two passes (l2, l1)
    with l1 = log n // 2, or three (lv, lu, l1) with l1 = log n // 3 and
    lv + lu = l2.  `passes` 0 takes the rule: three from THREE_PASS_MIN_LOG
    on; two passes are taken only below it."""
    if passes == 0:
        passes = 3 if log_n >= THREE_PASS_MIN_LOG else 2
    if passes == 2 and log_n >= THREE_PASS_MIN_LOG:
        raise ValueError(f"fourstep_split: 2^{log_n} in two passes needs columns "
                         f"longer than a tile holds (three from "
                         f"2^{THREE_PASS_MIN_LOG})")
    if passes == 2:
        l1 = log_n // 2
        return (log_n - l1, l1)
    l1 = log_n // 3
    lu = (log_n - l1) // 2
    return (log_n - l1 - lu, lu, l1)


def fourstep_radix(log_n: int) -> int:
    """Elements a thread holds of its column, as a log: 2 from
    RADIX4_MIN_LOG on, else 1."""
    return 2 if log_n >= RADIX4_MIN_LOG else 1


def pass_shape(lm: int, ncols: int, radix: int) -> tuple:
    """(R, C) of a pass over `ncols` columns of 2^lm: 2^R elements a thread
    (R = radix, but at most lm, and 2 where a column would need more than
    the kernel's 256 threads at 1), tiles of C columns of 128 threads at
    R = 1 and of 256 at 2."""
    R = min(radix, lm)
    if 1 << (lm - R) > 256:
        R = 2
    tc = 1 << (lm - R)
    threads = 128 if R == 1 else 256
    return R, min(max(1, threads // tc), ncols)


@lru_cache(maxsize=None)
def fourstep_passes(log_n: int, split: tuple, radix: int = 0) -> tuple:
    """Each pass of the four-step transform as a dict of PASS_FIELDS: column
    `col` = hi * 2^log_w + lo of a pass reads element p of its column at
    hi * sh_in + lo * sl_in + p * sp_in and writes frequency k at hi * sh_out
    + lo * sl_out + k * sp_out; a twiddled pass multiplies frequency k by
    w^((lo & lo_mask) * (k * kmul + hi * hmul)), as the product of two
    power-table entries (twiddle 1) or, where that exponent is a multiple of
    2^log_lo, as one entry (twiddle 2).  With i = i1 + n1 i2 and k = k1 n2 +
    k2: split (l2, l1) is the columns i1 of the (n2, n1) input (with the mid
    twiddle w^(i1 k2)), written as rows k2 of an (n2, n1) array, then the
    rows k2 of that array, written at k1 n2 + k2; split (lv, lu, l1) cuts the
    first pass in two, i2 = u + Nu v and k2 = ku Nv + kv: the columns (u, i1)
    over v (twiddle w^(n1 u kv), one entry of the powers of w^n1), then the
    columns (kv, i1) over u (twiddle w^(i1 k2)).  `radix` 0 takes the rule
    (`fourstep_radix`); 1 or 2 gives the passes of the rule's other radix,
    for tests/test_torch_ntt.py's model at sizes the rule runs at 1."""
    if sum(split) != log_n or len(split) not in (2, 3) or min(split) < 1:
        raise ValueError(f"fourstep split {split} does not cut 2^{log_n}")
    if radix not in (0, 1, 2):
        raise ValueError(f"fourstep radix {radix} outside 1..2")
    n = 1 << log_n
    l1 = split[-1]
    n1, n2 = 1 << l1, n >> l1
    log_lo = (log_n + 1) // 2
    common = {"sh_in": 0, "sh_out": 0, "twiddle": 0, "lo_mask": -1, "kmul": 1,
              "hmul": 0, "log_n": log_n, "log_lo": log_lo, "bstride": n}
    passes = []
    if len(split) == 2:
        passes.append({**common, "lm": split[0], "ncols": n1, "log_w": l1,
                       "sl_in": 1, "sp_in": n1, "sl_out": 1, "sp_out": n1,
                       "twiddle": 1})
    else:
        lv, lu = split[0], split[1]
        nu, nv = 1 << lu, 1 << lv
        passes.append({**common, "lm": lv, "ncols": nu * n1, "log_w": lu + l1,
                       "sl_in": 1, "sp_in": nu * n1, "sl_out": 1,
                       "sp_out": nu * n1, "twiddle": 2, "lo_mask": -n1,
                       "log_lo": l1})
        passes.append({**common, "lm": lu, "ncols": nv * n1, "log_w": l1,
                       "sh_in": nu * n1, "sl_in": 1, "sp_in": n1, "sh_out": n1,
                       "sl_out": 1, "sp_out": nv * n1, "twiddle": 1,
                       "kmul": nv, "hmul": 1})
    passes.append({**common, "lm": l1, "ncols": n2, "log_w": log_n - l1,
                   "sl_in": n1, "sp_in": 1, "sl_out": 1, "sp_out": n2})
    for p in passes:
        p["R"], p["C"] = pass_shape(p["lm"], p["ncols"],
                                    radix or fourstep_radix(log_n))
        p["load_cfast"] = int(p["sl_in"] == 1)
        p["store_cfast"] = int(p["sl_out"] == 1)
    return tuple(passes)


@lru_cache(maxsize=None)
def fourstep_tables(modulus: int, log_n: int, split: tuple, inverse: bool,
                    device: str):
    """Each pass's tables: its column twiddles (w_m^0 .. w_m^(m/2 - 1), m =
    2^lm) and its mid twiddle's two power tables: for twiddle 1, w^0 ..
    w^(2^log_lo - 1) and the powers of w^(2^log_lo), 2^(log n - log_lo) of
    them, so that w^e for e < n is one product of two entries; for twiddle
    2, the n / 2^log_lo powers of w^(2^log_lo) (twice); for a pass without
    twiddle, which reads neither, its column twiddles in their place.  The
    inverse's 1/n is folded into the first pass's table (the first pass is
    twiddled)."""
    w = get_omega(modulus, log_n, inverse)
    out = []
    for i, par in enumerate(fourstep_passes(log_n, split)):
        tw = _twiddle_table(modulus, par["lm"], inverse, device).contiguous()
        if not par["twiddle"]:
            out.append((tw, tw, tw))
            continue
        log_lo = par["log_lo"]
        hi = power_table(modulus, pow(w, 1 << log_lo, modulus),
                         1 << (log_n - log_lo), device)
        if i == 0 and inverse:
            hi = limb_field(modulus).mul(hi, _scale(modulus, 1 << log_n, device))
        lo = hi if par["twiddle"] == 2 else power_table(
            modulus, w, 1 << log_lo, device)
        out.append((tw, lo.contiguous(), hi.contiguous()))
    return tuple(out)


@lru_cache(maxsize=None)
def _launch_args(modulus: int, log_n: int, split: tuple, inverse: bool,
                 device: str):
    """Each pass's launch arguments after the buffers (its fields as an
    int64 array, its tables' pointers), built once, with what they point at
    kept alive beside them."""
    params = tuple((ctypes.c_longlong * len(PASS_FIELDS))(*(p[f] for f in PASS_FIELDS))
                   for p in fourstep_passes(log_n, split))
    tables = fourstep_tables(modulus, log_n, split, inverse, device)
    args = tuple((ctypes.addressof(par), *(t.data_ptr() for t in tabs))
                 for par, tabs in zip(params, tables))
    return args, (params, tables)


def _fourstep(a: torch.Tensor, modulus: int, inverse: bool, split: tuple):
    """The transform as the passes of `split`, one launch each; the input is
    left as it was.  Between passes the data moves between two buffers."""
    field = _build.field_id(modulus)
    batch = _check(a, "ntt_fourstep_cuda")
    if batch > 65535:
        raise ValueError(f"ntt_fourstep_cuda: batch {batch} above 65535")
    n = a.shape[-2]
    log_n = _log2(n)
    if not FOURSTEP_MIN_LOG <= log_n <= FOURSTEP_MAX_LOG:
        raise ValueError(
            f"ntt_fourstep_cuda: size 2^{log_n} outside 2^{FOURSTEP_MIN_LOG}.."
            f"2^{FOURSTEP_MAX_LOG}")
    args, _ = _launch_args(modulus, log_n, split, inverse, str(a.device))
    a = a.contiguous()
    # two buffers: the last pass writes the one returned, so the other, freed
    # on return, is the only scratch
    bufs = [torch.empty_like(a), torch.empty_like(a)]
    src, lib, stream = a, _build.lib(), _build.stream_ptr(a.device)
    for i, pass_args in enumerate(args):
        dst = bufs[(len(args) - 1 - i) % 2]
        err = lib.mira_ntt_pass(field, src.data_ptr(), dst.data_ptr(), *pass_args,
                                batch, stream)
        _build.check(err, "ntt_fourstep")
        src = dst
    tracing.count("ntt_fourstep")
    return src


def ntt_fourstep_cuda(a: torch.Tensor, modulus: int, inverse: bool = False):
    """The whole transform as the column passes of `fourstep_split`; the
    input is left as it was."""
    return _fourstep(a, modulus, inverse, fourstep_split(_log2(a.shape[-2])))
