"""Radix-2 NTT (port of mira_tpu/ops/ntt.py): the host transform on Python
ints for protocol-side polynomials (`get_omega`, `ntt_host`, used by the
Groth16 prover in snark/groth16.py), and the device transform on (n, 8)
int32 Montgomery word tensors (`ntt`, `coset_ntt`, `coset_intt`).

Semantics are the reference FFT's (src/fft.rs:51-226): natural order in and
out, the inverse carries the 1/n divisor, coset powers [1, zeta, zeta^2, 1,
...].

`ntt` takes one (n, 8) array or a batch (B, n, 8) of arrays of one size (the
row transforms of parallel/ntt.py's distributed NTT): on the card a batch is
one launch of each kernel.

Dispatch of `ntt`: a CPU tensor takes the plain stage-by-stage version
(`ntt_plain`); a CUDA tensor takes a kernel of ops/cuda_ntt.py, chosen by
`engine`: "auto" is the four-step kernel (csrc/ntt_fourstep.cu) for
n >= FOURSTEP_MIN and the per-stage kernel (csrc/ntt_stage.cu) below that,
"fourstep" and "stage" force one.  Nothing falls from one engine to another:
a size an engine cannot hold raises ValueError.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..fields.limbs import NUM_WORDS, limb_field
from ..fields.params import field_params

ENGINES = ("auto", "fourstep", "stage")
# "auto" takes the four-step kernel from this size on: the size from which
# its device time (two launches) is below the stage kernel's (log n
# launches) on an H100 (chip_smoke.py times both engines around it, by
# events and by device time; PERF.md has the numbers).
FOURSTEP_MIN = 16
_HOST_TABLE = 4096  # twiddle tables up to this length are made on the host


def _bitrev_perm(log_n: int) -> list:
    n = 1 << log_n
    return [int(format(i, f"0{log_n}b")[::-1], 2) if log_n else 0
            for i in range(n)]


@lru_cache(maxsize=None)
def get_omega(modulus: int, log_n: int, inverse: bool = False) -> int:
    """omega for domain size 2^log_n (reference fft.rs:12-23: square
    ROOT_OF_UNITY down from 2-adicity S)."""
    params = field_params(modulus)
    if log_n > params.s:
        raise ValueError(f"domain 2^{log_n} exceeds 2-adicity {params.s}")
    w = params.root_of_unity_inv if inverse else params.root_of_unity
    for _ in range(log_n, params.s):
        w = (w * w) % modulus
    return w


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"NTT size {n} is not a power of two")
    return log_n


def ntt_host(vals, modulus: int, inverse: bool = False):
    """Values <-> coefficients over the 2^k-th roots of unity, Python ints."""
    n = len(vals)
    log_n = _log2(n)
    w = get_omega(modulus, log_n, inverse)
    a = [vals[p] for p in _bitrev_perm(log_n)]
    half_tw = [1] * max(n // 2, 1)
    for i in range(1, n // 2):
        half_tw[i] = (half_tw[i - 1] * w) % modulus
    for s in range(log_n):
        half = 1 << s
        step = n // (2 * half)
        for base in range(0, n, 2 * half):
            for k in range(half):
                t = (a[base + half + k] * half_tw[k * step]) % modulus
                a[base + half + k] = (a[base + k] - t) % modulus
                a[base + k] = (a[base + k] + t) % modulus
    if inverse:
        ninv = pow(n, -1, modulus)
        a = [(x * ninv) % modulus for x in a]
    return a


# -- device tables ------------------------------------------------------------
def _powers(w: int, count: int, modulus: int) -> list:
    out = [1] * count
    for i in range(1, count):
        out[i] = (out[i - 1] * w) % modulus
    return out


def power_table(modulus: int, w: int, count: int, device) -> torch.Tensor:
    """(count, 8) Montgomery words of w^0 .. w^(count-1).  Short tables come
    from the host; a long one is the outer product of two short ones, one
    plain product on the device."""
    lf = limb_field(modulus)
    if count <= _HOST_TABLE:
        return lf.encode(_powers(w, count, modulus), device)
    if count % _HOST_TABLE:
        raise ValueError(f"power table length {count} is not a multiple of "
                         f"{_HOST_TABLE}")
    low = lf.encode(_powers(w, _HOST_TABLE, modulus), device)
    high = lf.encode(_powers(pow(w, _HOST_TABLE, modulus),
                             count // _HOST_TABLE, modulus), device)
    return lf.mul(high[:, None, :], low[None, :, :]).reshape(count, NUM_WORDS)


@lru_cache(maxsize=None)
def _twiddle_table(modulus: int, log_n: int, inverse: bool, device: str):
    """Montgomery twiddles w^0 .. w^(n/2 - 1) of the size-2^log_n domain
    (as in reference fft.rs:75-81), one row at least."""
    w = get_omega(modulus, log_n, inverse)
    return power_table(modulus, w, max((1 << log_n) // 2, 1), device)


@lru_cache(maxsize=None)
def _bitrev_index(log_n: int, device: str) -> torch.Tensor:
    idx = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


# -- plain versions -------------------------------------------------------------
def stage_plain(a: torch.Tensor, tw: torch.Tensor, half: int, modulus: int):
    """One butterfly stage on an (n, 8) array (or a (B, n, 8) batch) whose
    pairs are (i, i + half) inside blocks of 2 * half: (u, v) ->
    (u + t v, u - t v) with t = tw[k * n / (2 half)] for the pair's offset k.
    The plain version of csrc/ntt_stage.cu."""
    lf = limb_field(modulus)
    n = a.shape[-2]
    x = a.reshape(*a.shape[:-2], n // (2 * half), 2, half, NUM_WORDS)
    u = lf.lz(x[..., 0, :, :])
    prod = lf.lz(x[..., 1, :, :]) * lf.lz(tw[:: n // (2 * half)])
    return torch.stack((lf.canon(u + prod), lf.canon(u - prod)),
                       dim=-3).reshape(a.shape)


def transform_plain(a: torch.Tensor, tw: torch.Tensor, modulus: int):
    """Bit-reversal gather and all log n butterfly stages over the twiddle
    table `tw` (n/2 powers of the domain's root), without any divisor."""
    n = a.shape[-2]
    log_n = _log2(n)
    a = a[..., _bitrev_index(log_n, str(a.device)), :]
    for s in range(log_n):
        a = stage_plain(a, tw, 1 << s, modulus)
    return a


def ntt_plain(a: torch.Tensor, modulus: int, inverse: bool = False):
    """Stage-by-stage NTT in plain PyTorch (the counterpart of mira_tpu's
    `_ntt_jit`): bit-reversal gather, log n butterfly stages, and the 1/n
    divisor of the inverse."""
    lf = limb_field(modulus)
    n = a.shape[-2]
    log_n = _log2(n)
    if log_n == 0:
        return a
    tw = _twiddle_table(modulus, log_n, inverse, str(a.device))
    a = transform_plain(a, tw, modulus)
    if inverse:
        a = lf.mul(a, lf.const(pow(n, -1, modulus), (1,), a.device))
    return a


# -- entry points ---------------------------------------------------------------
def ntt(a: torch.Tensor, modulus: int, inverse: bool = False,
        engine: str = "auto"):
    """Forward/inverse NTT of an (n, 8) Montgomery word tensor, or of each
    array of a (B, n, 8) batch, on the device of `a`.  Output is in standard order; the inverse includes the
    1/n divisor (reference fft.rs:160-174).  `engine` picks the kernel on a
    CUDA tensor (see the module docstring); a CPU tensor always takes the
    plain version."""
    if engine not in ENGINES:
        raise ValueError(f"ntt: engine {engine!r} not in {ENGINES}")
    if a.dim() not in (2, 3) or a.shape[-1] != NUM_WORDS or a.dtype != torch.int32:
        raise ValueError("ntt: expects an (n, 8) or (B, n, 8) int32 word tensor")
    n = a.shape[-2]
    log_n = _log2(n)
    get_omega(modulus, log_n)  # raises past the field's 2-adicity
    if log_n == 0:
        return a
    if a.device.type == "cpu":
        return ntt_plain(a, modulus, inverse)
    from . import cuda_ntt

    if engine == "auto":
        engine = "fourstep" if n >= FOURSTEP_MIN else "stage"
    if engine == "fourstep":
        return cuda_ntt.ntt_fourstep_cuda(a, modulus, inverse)
    return cuda_ntt.ntt_stage_cuda(a, modulus, inverse)


_COSET_CHUNK = 1 << 20  # elements per plain product of a coset scaling


@lru_cache(maxsize=None)
def _coset_three(modulus: int, into: bool, device: str) -> torch.Tensor:
    """(1, z, z^2) (or the inverse order, (1, z^2, z)) in Montgomery form."""
    z = field_params(modulus).zeta
    z2 = (z * z) % modulus
    first, second = (z, z2) if into else (z2, z)
    return limb_field(modulus).encode([1, first, second], device)


def _coset_scale(a: torch.Tensor, modulus: int, into: bool) -> torch.Tensor:
    """a[i] * [1, z, z^2, 1, z, z^2, ...][i], mirroring distribute_powers_zeta
    (reference fft.rs:205-226).  Elementwise field work in plain PyTorch on
    the device of `a`, a chunk at a time so that the lazy limbs of a large
    array stay small."""
    lf = limb_field(modulus)
    three = _coset_three(modulus, into, str(a.device))
    n = a.shape[0]
    out = []
    for i in range(0, n, _COSET_CHUNK):
        j = min(n, i + _COSET_CHUNK)
        pw = three[torch.arange(i, j, device=a.device) % 3]
        out.append(lf.mul(a[i:j], pw))
    return out[0] if len(out) == 1 else torch.cat(out)


def coset_ntt(a: torch.Tensor, modulus: int, engine: str = "auto"):
    """Evaluate coefficients on the coset zeta*H (reference coset_fft)."""
    return ntt(_coset_scale(a, modulus, True), modulus, engine=engine)


def coset_intt(a: torch.Tensor, modulus: int, engine: str = "auto"):
    """Values on zeta*H -> coefficients (reference coset_ifft)."""
    return _coset_scale(ntt(a, modulus, inverse=True, engine=engine), modulus,
                        False)
