"""Row-wise field linear combinations on Montgomery word arrays: K outputs
out_k[i] = sum_j c_kj * in_j[i] mod p over J inputs of n rows, in
Montgomery form or, with plain=True, in plain form (what
`LimbField.to_plain` gives); `to_plain` is the case of one input and the
coefficient 1.

On the card this is csrc/field_lincomb.cu, one launch a call; on a CPU
tensor it is `lincomb_plain`, lazy-limb arithmetic on fields/limbs.py
`LimbField` in blocks of rows.  A CUDA tensor never takes the plain
version.  The kernel replaces no Pallas kernel: mira_tpu leaves the same
work to XLA, in `_combine_slices_sat_jit` / `_combine_slices_jit`
(nifs/vanilla.py), `_witness_fold_jit` (plonk/structure.py) and the cross
terms' `to_plain` (ops/commitment.py); those call sites of the port go
through this module.

The coefficients are plain Python ints; the wrapper puts them in
Montgomery form and passes them by value in the launch's parameters
(`pack_args`), so a launch needs no copy from the host and waits on
nothing: the wrapper makes no host sync.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import _build
from ..fields import limbs
from ..fields.limbs import NUM_WORDS, ints_to_words, limb_field
from ..utils import tracing

MAX_J = 16  # inputs of a call (csrc/field_lincomb.cu LC_MAX_J)
MAX_K = 16  # outputs of a call (LC_MAX_K)
MAX_COEFS = 96  # K x J of a call (LC_MAX_COEFS)


class LincombArgs(ctypes.Structure):
    """csrc/field_lincomb.cu's `LincombArgs`, field for field."""

    _fields_ = [
        ("inputs", ctypes.c_void_p * MAX_J),
        ("outs", ctypes.c_void_p * MAX_K),
        ("coefs", (ctypes.c_uint32 * NUM_WORDS) * MAX_COEFS),
        ("n", ctypes.c_int64),
        ("J", ctypes.c_int32),
        ("K", ctypes.c_int32),
        ("plain", ctypes.c_int32),
    ]


def _check_fits(K: int, J: int):
    if not (1 <= J <= MAX_J and 1 <= K <= MAX_K and K * J <= MAX_COEFS):
        raise ValueError(f"field_lincomb: {K} x {J} coefficients do not fit one "
                         f"launch (J <= {MAX_J}, K <= {MAX_K}, K x J <= {MAX_COEFS})")


def pack_args(modulus: int, coefs: Sequence[Sequence[int]]) -> LincombArgs:
    """The launch's parameters with the K x J coefficients (plain ints, any
    sign) in Montgomery form, row k at k * J; pointers and n left zero."""
    K, J = len(coefs), len(coefs[0])
    _check_fits(K, J)
    r = limb_field(modulus).r_mod_p
    words = ints_to_words([(c % modulus) * r % modulus for row in coefs for c in row])
    args = LincombArgs()
    ctypes.memmove(args.coefs, words.tobytes(), words.nbytes)
    args.J, args.K = J, K
    return args


def _check(inputs, coefs):
    if not inputs:
        raise ValueError("field_lincomb: no inputs")
    if len(inputs) > MAX_J:
        raise ValueError(f"field_lincomb: {len(inputs)} inputs, at most {MAX_J}")
    for x in inputs:
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.int32
                or x.dim() != 2 or x.shape != inputs[0].shape
                or x.shape[1] != NUM_WORDS):
            raise ValueError("field_lincomb: expects (n, 8) int32 inputs of one "
                             "row count")
        if x.device != inputs[0].device:
            raise ValueError("field_lincomb: inputs lie on more than one device")
    if any(len(row) != len(inputs) for row in coefs):
        raise ValueError("field_lincomb: every row of coefficients needs one "
                         "coefficient per input")
    if coefs:
        _check_fits(len(coefs), len(inputs))


def lincomb(modulus: int, inputs: Sequence[torch.Tensor],
            coefs: Sequence[Sequence[int]], plain: bool = False):
    """out_k = sum_j coefs[k][j] * inputs[j] on (n, 8) Montgomery words of
    one device: the K outputs, in Montgomery form or, with plain=True, in
    plain form."""
    _check(inputs, coefs)
    if not coefs:
        return []
    if inputs[0].device.type == "cuda":
        return _launch(modulus, inputs, coefs, plain)
    return lincomb_plain(modulus, inputs, coefs, plain)


def to_plain(modulus: int, x: torch.Tensor) -> torch.Tensor:
    """x * R^-1 of (n, 8) Montgomery words: `LimbField.to_plain`, one launch
    on the card."""
    return lincomb(modulus, [x], [[1]], plain=True)[0]


def lincomb_plain(modulus: int, inputs: Sequence[torch.Tensor],
                  coefs: Sequence[Sequence[int]], plain: bool = False):
    """The plain version: lazy products on `LimbField`, one canonicalisation
    an output, over blocks of `limbs._ROWS` rows (a block's lazy limbs take
    17 int64 an element for each input)."""
    lf = limb_field(modulus)
    n, dev = inputs[0].shape[0], inputs[0].device
    outs = [torch.empty(n, NUM_WORDS, dtype=torch.int32, device=dev) for _ in coefs]
    for lo in range(0, n, limbs._ROWS):
        block = [x[lo : lo + limbs._ROWS] for x in inputs]
        lz = [lf.lz(x) for x in block]
        for k, row in enumerate(coefs):
            acc = None
            for c, x, xl in zip(row, block, lz):
                c %= modulus
                if not c:
                    continue
                t = xl if c == 1 else xl * lf.lz_const(c, x.shape[:-1], dev)
                acc = t if acc is None else acc + t
            out = lf.canon(acc) if acc is not None else lf.zero((len(block[0]),), dev)
            outs[k][lo : lo + limbs._ROWS] = lf.to_plain(out) if plain else out
    return outs


def _launch(modulus: int, inputs, coefs, plain: bool):
    """The kernel: one C call."""
    field = _build.field_id(modulus)
    dev = inputs[0].device
    n = inputs[0].shape[0]
    # the kernel reads and writes 16 bytes at a time
    inputs = [x if x.is_contiguous() and x.data_ptr() % 16 == 0
              else x.clone(memory_format=torch.contiguous_format) for x in inputs]
    outs = [torch.empty(n, NUM_WORDS, dtype=torch.int32, device=dev) for _ in coefs]
    if n == 0:
        return outs
    args = pack_args(modulus, coefs)
    args.n, args.plain = n, int(plain)
    for j, x in enumerate(inputs):
        args.inputs[j] = x.data_ptr()
    for k, o in enumerate(outs):
        args.outs[k] = o.data_ptr()
    err = _build.lib().mira_field_lincomb(
        field, ctypes.addressof(args), ctypes.sizeof(args), _build.stream_ptr(dev))
    _build.check(err, "field_lincomb")
    tracing.count("field_lincomb")
    return outs
