"""Native C++ fold evaluator (port of mira_tpu/polynomial/native_evaluator.py).

The expression, with its witness-free subtrees split off and evaluated on
the host per fold point, compiles into mira_tpu's SSA op list (one register
per unique node, common subexpressions shared: `fold_evaluator._compile_ops`
without the register compaction) and runs row-parallel on the host's cores
in native/evaluator.cpp `mira_eval_fold` (4x64-bit __int128 Montgomery
arithmetic, threads over row chunks).  It shares no code with the fold
kernel (csrc/fold_eval.cu) beyond the op list's compiler, which makes it
the decider's and the cross terms' second route (`MIRA_FOLD_EVAL=native`,
plonk/structure.py `fold_eval_impl`).

Field layout at the ABI: little-endian 4x64 Montgomery limbs, the byte image
of the port's (n, 8) int32 Montgomery words, so the conversion is a numpy
view, not arithmetic.  There is no fallback: without the native library
(no g++ to build it) the constructor raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from ..fields.limbs import NUM_WORDS, R_BITS, ints_to_words
from ..fields.native64 import to_mont
from ..utils.native_lib import available, load
from .evaluator import advice_round_col
from .expression import Expression
from .fold_evaluator import (
    _compile_ops,
    _eval_scalar,
    _split_scalar_subtrees,
    query_layout,
)


def words_to_64(t) -> np.ndarray:
    """(..., 8) int32 Montgomery words (tensor or array) -> C-contiguous
    (..., 4) uint64 host array (a view where the words are on the host)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(t, dtype="<i4").view("<u8")


def words_from_64(a: np.ndarray, device) -> torch.Tensor:
    """(..., 4) uint64 -> (..., 8) int32 word tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype="<u8").view("<i4")).to(device)


def _mont64(vals, modulus: int) -> np.ndarray:
    """Python ints -> (n, 4) uint64 Montgomery limbs."""
    r = 1 << R_BITS
    return ints_to_words([(v % modulus) * r % modulus for v in vals]).view("<u8")


class NativeFoldEvaluator:
    """Multi-point fold evaluation on the native row VM, with the query
    layout and scalar-subtree split of `fold_evaluator.FoldEvaluator`."""

    def __init__(self, expr: Expression, modulus: int, num_advice: int,
                 num_lookup: int, selectors, fixed, nrow: int):
        if not available():
            raise RuntimeError(
                "NativeFoldEvaluator: native/libmiraeval.so is missing and could "
                "not be built (g++)")
        self.expr = expr
        self.modulus = modulus
        self.num_advice = num_advice
        self.nrow = nrow
        self.qslot, self.advice_idx_rot, static_cols = query_layout(
            expr, num_advice, num_lookup, selectors, fixed, nrow)
        # (n_sq, nrow, 4) uint64 Montgomery limbs, pre-rotated
        plain = (np.stack(static_cols) if static_cols
                 else np.zeros((1, nrow, NUM_WORDS), np.int32))
        self.static64 = to_mont(modulus, plain.view("<u8"))
        self._programs = {}

    def _program(self, n_ch_base: int):
        """(scalar subtrees, ops (n_ops, 4) int32, consts (n_c, 4) uint64)
        for a challenge count; mira_tpu's SSA encoding, n_regs = n_ops."""
        prog = self._programs.get(n_ch_base)
        if prog is None:
            rewritten, scalars = _split_scalar_subtrees(self.expr, n_ch_base)
            ops, consts = _compile_ops(rewritten, self.qslot, self.modulus)
            prog = (scalars, np.asarray(ops, dtype=np.int32),
                    ints_to_words(consts or [0]).view("<u8"))
            self._programs[n_ch_base] = prog
        return prog

    def _stack64(self, Ws, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the queried advice columns, rotated: (n_aq,
        hi - lo, 4) uint64."""
        nrow = self.nrow
        Ws64 = [words_to_64(w) for w in Ws]
        out = np.zeros((max(len(self.advice_idx_rot), 1), hi - lo, 4), np.uint64)
        for a, (idx, rot) in enumerate(self.advice_idx_rot):
            rnd, colj = advice_round_col(self.num_advice, idx, len(Ws))
            col = Ws64[rnd][colj * nrow : (colj + 1) * nrow]
            out[a] = (np.roll(col, -rot, axis=0) if rot else col)[lo:hi]
        return out

    def fold_eval_multi(self, W1s, W2s, j_values: Sequence[int],
                        ch1: Sequence[int], ch2: Sequence[int], rows=None,
                        as64: bool = False):
        """P(W1 + j*W2) for every j on rows [lo, hi) (all rows without
        `rows`).  ch1/ch2: plain-int challenge vectors (the challenge at
        point j is ch1 + j*ch2 mod p).  Returns (n_j, hi - lo, 8) Montgomery
        words on W1s[0]'s device, or with `as64` the VM's (n_j, hi - lo, 4)
        uint64 host buffer."""
        p, nrow = self.modulus, self.nrow
        lo, hi = (0, nrow) if rows is None else rows
        if not 0 <= lo <= hi <= nrow:
            raise ValueError(f"native fold_eval: rows {rows} outside [0, {nrow})")
        scalars, op_arr, c64 = self._program(len(ch1))
        w1 = self._stack64(W1s, lo, hi)
        w2 = self._stack64(W2s, lo, hi)
        stat = np.ascontiguousarray(self.static64[:, lo:hi])
        n_j = len(j_values)
        ch_rows = []
        for j in j_values:
            chj = [(a + j * b) % p for a, b in zip(ch1, ch2)]
            ch_rows.append(chj + [_eval_scalar(s, p, chj) for s in scalars])
        n_ch = max(len(ch1) + len(scalars), 1)
        flat = [v for row in ch_rows for v in row]
        ch64 = _mont64(flat, p) if flat else np.zeros((n_j, 4), np.uint64)
        jm64 = _mont64([j % p for j in j_values], p)
        mod64 = ints_to_words([p]).view("<u8")
        out = np.zeros((n_j, hi - lo, 4), dtype=np.uint64)

        def ptr(a, ty=ctypes.c_uint64):
            return a.ctypes.data_as(ctypes.POINTER(ty))

        if n_j and hi > lo:
            load().mira_eval_fold(
                ptr(mod64), ptr(op_arr, ctypes.c_int32), op_arr.shape[0],
                op_arr.shape[0], ptr(stat), ptr(w1), ptr(w2), ptr(ch64), n_ch,
                ptr(jm64), n_j, hi - lo, ptr(c64), 0, ptr(out))
        return out if as64 else words_from_64(out, W1s[0].device)
