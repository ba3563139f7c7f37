"""NTT kernels on the card: the four-step transform (csrc/ntt_fourstep.cu),
the port of mira_tpu/ops/ntt.py `_ntt_fourstep_jit`, and the per-stage
butterfly (csrc/ntt_stage.cu), the port of `_ntt_pallas_jit`.  ops/ntt.py
`ntt` dispatches here for CUDA tensors; the plain versions live there
(`ntt_plain`, `stage_plain`).  Nothing here falls back to them.

Every entry point takes one (n, 8) array or a batch (B, n, 8) of arrays of
one size; a batch is one launch of each kernel (more blocks), not a loop.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import _build
from ..fields.limbs import NUM_WORDS, limb_field
from .ntt import _log2, _twiddle_table, get_omega, power_table

fourstep_launches = 0  # four-step transforms launched (two kernels each)
stage_launches = 0  # butterfly stages launched
FOURSTEP_MIN_LOG = 2  # n1 = 2^(log n // 2) must be at least 2
FOURSTEP_MAX_LOG = 24  # a column of 2^12 elements fills the shared memory


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
    global stage_launches
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
    stage_launches += 1
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


@lru_cache(maxsize=None)
def _fourstep_tables(modulus: int, log_n: int, inverse: bool, device: str):
    """Twiddles of the two sub-transforms and the two factors of the mid
    twiddle w^(i1 k2) = mid_a[e mod n2] * mid_b[e div n2], e = i1 k2:
    n2/2 + n1/2 + n2 + n1 elements, kept on the device."""
    l1 = log_n // 2
    l2 = log_n - l1
    w = get_omega(modulus, log_n, inverse)
    tw1 = _twiddle_table(modulus, l2, inverse, device)
    tw2 = _twiddle_table(modulus, l1, inverse, device)
    mid_a = power_table(modulus, w, 1 << l2, device)
    mid_b = power_table(modulus, pow(w, 1 << l2, modulus), 1 << l1, device)
    return tuple(t.contiguous() for t in (tw1, tw2, mid_a, mid_b))


def ntt_fourstep_cuda(a: torch.Tensor, modulus: int, inverse: bool = False):
    """The whole transform as two kernels over the columns of the (n2, n1)
    and (n1, n2) views of the array; the input is left as it was."""
    global fourstep_launches
    field = _build.field_id(modulus)
    batch = _check(a, "ntt_fourstep_cuda")
    if batch > 65535:
        raise ValueError(f"ntt_fourstep_cuda: batch {batch} above 65535")
    n = a.shape[-2]
    log_n = _log2(n)
    if not FOURSTEP_MIN_LOG <= log_n <= FOURSTEP_MAX_LOG:
        raise ValueError(
            f"ntt_fourstep_cuda: size 2^{log_n} outside 2^{FOURSTEP_MIN_LOG}.."
            f"2^{FOURSTEP_MAX_LOG} (a column must fit in shared memory)")
    dev = str(a.device)
    tw1, tw2, mid_a, mid_b = _fourstep_tables(modulus, log_n, inverse, dev)
    scale = _scale(modulus, n, dev) if inverse else None
    a = a.contiguous()
    tmp = torch.empty_like(a)
    out = torch.empty_like(a)
    err = _build.lib().mira_ntt_fourstep(
        field, a.data_ptr(), tmp.data_ptr(), out.data_ptr(), log_n,
        tw1.data_ptr(), tw2.data_ptr(), mid_a.data_ptr(), mid_b.data_ptr(),
        None if scale is None else scale.data_ptr(), batch,
        _build.stream_ptr(a.device))
    _build.check(err, "ntt_fourstep")
    fourstep_launches += 1
    return out
