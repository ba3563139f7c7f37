"""Host part of the radix-2 NTT (port of mira_tpu/ops/ntt.py `get_omega`,
`ntt_host`): Python-int transforms for protocol-side polynomials such as the
Groth16 prover's (snark/groth16.py).  Semantics (bit reversal, twiddle
order, inverse divisor) are the reference FFT's (src/fft.rs:51-226).  The
device NTT kernels of mira_tpu (ops/ntt.py `_fourstep_kernels`,
`_butterfly_pallas`) are not ported yet."""

from __future__ import annotations

from mira_tpu.fields.params import field_params


def _bitrev_perm(log_n: int) -> list:
    n = 1 << log_n
    return [int(format(i, f"0{log_n}b")[::-1], 2) if log_n else 0
            for i in range(n)]


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


def ntt_host(vals, modulus: int, inverse: bool = False):
    """Values <-> coefficients over the 2^k-th roots of unity, Python ints."""
    n = len(vals)
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"NTT size {n} is not a power of two")
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
