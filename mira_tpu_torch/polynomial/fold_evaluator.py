"""Multi-point fold evaluator (port of
mira_tpu/polynomial/pallas_evaluator.py `PallasFoldEvaluator`).

Evaluates the homogeneous compressed gate polynomial P(W1 + j*W2) on every
row for every fold point j.  The expression (with its witness-free subtrees
split off and evaluated on the host per fold point) is compiled into the
row-VM op list of mira_tpu's native evaluator, with common subexpressions
shared and registers compacted by liveness.  On a CUDA tensor the op list
runs in csrc/fold_eval.cu (one thread per row); on a CPU tensor the same op
list runs as plain torch ops over whole columns (`fold_eval_plain`).  A call
may take a range of rows (`rows=(lo, hi)`, a mesh rank's block): the
columns stay whole, so a rotation reads its rows wherever they lie.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..polynomial.expression import (
    Challenge,
    Const,
    Expression,
    Neg,
    Poly,
    Product,
    Query,
    Scaled,
    Sum,
)

from .. import _build
from ..fields.limbs import NUM_WORDS, R_BITS, Lz, ints_to_words, limb_field
from .evaluator import advice_round_col

OP_LOAD_STATIC = 0
OP_LOAD_FOLD = 1
OP_LOAD_CH = 2
OP_LOAD_CONST = 3
OP_ADD = 4
OP_MUL = 5
OP_NEG = 6
OP_OUTPUT = 7

launches = 0  # fold_eval kernel launches


def fold_eval_block(n_regs: int, n_ops: int) -> int:
    """The host-side mirror of csrc/fold_eval.cu `mira_fold_eval_block`,
    which makes the choice: rows per block, 128 halved down to 32 until the
    block's registers (32 bytes each a row) and its copy of the op program
    (16 bytes an op) fit its 232,448 bytes of shared memory.  Raises
    ValueError where even 32 rows do not."""
    for block in (128, 64, 32):
        if n_ops * 16 + n_regs * 32 * block <= 232448:
            return block
    raise ValueError(f"fold_eval: {n_regs} registers and {n_ops} ops do not "
                     "fit one 32-row block's shared memory")


def _split_scalar_subtrees(expr: Expression, n_ch_base: int):
    """Replace every maximal witness-free subtree (Const/Challenge ops only)
    with a synthetic Challenge slot n_ch_base + s; returns (rewritten expr,
    [scalar exprs]).  The scalars are evaluated on the host per fold point."""
    free_memo = {}

    def is_free(e) -> bool:
        key = id(e)
        if key not in free_memo:
            if isinstance(e, (Const, Challenge)):
                free_memo[key] = True
            elif isinstance(e, (Neg, Scaled)):
                free_memo[key] = is_free(e.a)
            elif isinstance(e, (Sum, Product)):
                free_memo[key] = is_free(e.a) and is_free(e.b)
            else:
                free_memo[key] = False
        return free_memo[key]

    scalars: List[Expression] = []

    def rewrite(e):
        if is_free(e) and not isinstance(e, (Const, Challenge)):
            scalars.append(e)
            return Challenge(n_ch_base + len(scalars) - 1)
        if isinstance(e, Neg):
            return Neg(rewrite(e.a))
        if isinstance(e, Scaled):
            return Scaled(rewrite(e.a), e.k)
        if isinstance(e, Sum):
            return Sum(rewrite(e.a), rewrite(e.b))
        if isinstance(e, Product):
            return Product(rewrite(e.a), rewrite(e.b))
        return e

    return rewrite(expr), scalars


def _eval_scalar(expr: Expression, modulus: int, ch_vals: Sequence[int]) -> int:
    return expr.evaluate(
        constant=lambda c: c % modulus,
        poly=lambda q: (_ for _ in ()).throw(
            ValueError("scalar subtree queried a column")
        ),
        challenge=lambda i: ch_vals[i] % modulus,
        negated=lambda a: (-a) % modulus,
        sum_=lambda a, b: (a + b) % modulus,
        product=lambda a, b: (a * b) % modulus,
        scaled=lambda a, k: (a * k) % modulus,
    )


def _collect_queries(expr: Expression) -> List[Query]:
    seen, out = set(), []

    def poly(q):
        if q not in seen:
            seen.add(q)
            out.append(q)

    expr.evaluate(
        constant=lambda c: None,
        poly=poly,
        challenge=lambda i: None,
        negated=lambda a: None,
        sum_=lambda a, b: None,
        product=lambda a, b: None,
        scaled=lambda a, k: None,
    )
    return out


def _compile_ops(expr: Expression, qslot, modulus: int):
    """Expression -> (ops [(op, a, b, dst)], constants [Montgomery ints]).
    Common subexpressions share one SSA register per unique node."""
    ops: List[tuple] = []
    consts: List[int] = []
    const_slot = {}
    memo = {}
    mont_r = 1 << R_BITS

    def const_of(v: int) -> int:
        v = v % modulus
        if v not in const_slot:
            const_slot[v] = len(consts)
            consts.append(v * mont_r % modulus)
        return const_slot[v]

    def emit(op, a, b=-1) -> int:
        dst = len(ops)
        ops.append((op, a, b, dst))
        return dst

    def go(e) -> int:
        if isinstance(e, Poly):
            key = ("q", e.query)
        elif isinstance(e, Challenge):
            key = ("c", e.index)
        elif isinstance(e, Const):
            key = ("k", e.value % modulus)
        else:
            a = go(e.a)
            if isinstance(e, Neg):
                key = ("n", a)
            elif isinstance(e, Scaled):
                key = ("s", a, e.k % modulus)
            else:
                b = go(e.b)
                lo, hi = min(a, b), max(a, b)
                key = (("+" if isinstance(e, Sum) else "*"), lo, hi)
        if key in memo:
            return memo[key]
        if key[0] == "q":
            kind, slot = qslot[e.query]
            r = emit(OP_LOAD_STATIC if kind == "s" else OP_LOAD_FOLD, slot)
        elif key[0] == "c":
            r = emit(OP_LOAD_CH, e.index)
        elif key[0] == "k":
            r = emit(OP_LOAD_CONST, const_of(e.value))
        elif key[0] == "n":
            r = emit(OP_NEG, key[1])
        elif key[0] == "s":
            kr = emit(OP_LOAD_CONST, const_of(e.k))
            r = emit(OP_MUL, key[1], kr)
        else:
            r = emit(OP_ADD if key[0] == "+" else OP_MUL, key[1], key[2])
        memo[key] = r
        return r

    out_reg = go(expr)
    ops.append((OP_OUTPUT, out_reg, -1, out_reg))
    return ops, consts


def compact_registers(ops: List[tuple]):
    """Rename SSA registers so a register is reused once its value is dead;
    returns (ops, n_regs).  Operands are read before the destination is
    written, so an op may write into a register it frees."""
    last_use = {}
    for i, (op, a, b, _dst) in enumerate(ops):
        if op in (OP_ADD, OP_MUL):
            last_use[a] = i
            last_use[b] = i
        elif op in (OP_NEG, OP_OUTPUT):
            last_use[a] = i
    loc, free, out, n_regs = {}, [], [], 0
    for i, (op, a, b, dst) in enumerate(ops):
        reads = (a, b) if op in (OP_ADD, OP_MUL) else (
            (a,) if op in (OP_NEG, OP_OUTPUT) else ())
        ra = loc[a] if a in loc and a in reads else a
        rb = loc[b] if b in loc and b in reads else b
        for r in set(reads):
            if last_use.get(r) == i:
                free.append(loc[r])
        if op == OP_OUTPUT:
            out.append((op, ra, -1, ra))
            continue
        if free:
            reg = free.pop()
        else:
            reg = n_regs
            n_regs += 1
        loc[dst] = reg
        out.append((op, ra, rb, reg))
    return out, max(n_regs, 1)


class FoldEvaluator:
    """Multi-point fold evaluation of one expression on `device`.

    Query layout follows evaluator.EvalDomain: indices cover selectors,
    fixed, then the W1 fold-variable range.  `fixed` holds each fixed
    column's plain words up to its last nonzero value
    (PlonkStructure.fixed_words)."""

    def __init__(self, expr: Expression, modulus: int, num_advice: int,
                 num_lookup: int, selectors, fixed, nrow: int, device="cpu"):
        self.expr = expr
        self.modulus = modulus
        self.num_advice = num_advice
        self.lf = limb_field(modulus)
        self.nrow = nrow
        self.device = torch.device(device)
        n_sel, n_fix = len(selectors), len(fixed)
        max_width = num_advice + 5 * num_lookup

        self.advice_idx_rot: List[tuple] = []
        self.qslot = {}
        static_cols = []
        for q in _collect_queries(expr):
            rot = q.rotation % nrow
            if q.index < n_sel + n_fix:
                self.qslot[q] = ("s", len(static_cols))
                # plain words, zero-padded to nrow
                part = (ints_to_words([1 if b else 0 for b in selectors[q.index]])
                        if q.index < n_sel else fixed[q.index - n_sel])
                words = np.zeros((nrow, NUM_WORDS), dtype=np.int32)
                words[: len(part)] = part
                static_cols.append((words, rot))
            else:
                idx = q.index - n_sel - n_fix
                if idx >= max_width:
                    raise ValueError(
                        "fold evaluator only supports first-instance queries")
                self.qslot[q] = ("a", len(self.advice_idx_rot))
                self.advice_idx_rot.append((idx, rot))

        # (n_sq, nrow, 8) Montgomery words, pre-rotated
        if static_cols:
            self.static_stack = torch.empty(len(static_cols), nrow, NUM_WORDS,
                                            dtype=torch.int32, device=self.device)
            for i, (words, rot) in enumerate(static_cols):
                plain = torch.from_numpy(np.roll(words, -rot, axis=0) if rot else words)
                self.static_stack[i] = self.lf.from_plain(plain.to(self.device))
        else:
            self.static_stack = torch.zeros(1, nrow, NUM_WORDS,
                                            dtype=torch.int32,
                                            device=self.device)
        self._programs = {}

    def _program(self, n_ch_base: int):
        """(scalar subtrees, ops, n_regs, consts) for a challenge count."""
        prog = self._programs.get(n_ch_base)
        if prog is None:
            rewritten, scalars = _split_scalar_subtrees(self.expr, n_ch_base)
            ops, consts = _compile_ops(rewritten, self.qslot, self.modulus)
            ops, n_regs = compact_registers(ops)
            ops_t = torch.tensor(np.asarray(ops, dtype=np.int32),
                                 device=self.device)
            consts_t = torch.from_numpy(
                ints_to_words(consts or [0])).to(self.device)
            prog = (scalars, ops, ops_t, n_regs, consts_t)
            self._programs[n_ch_base] = prog
        return prog

    def _stack_advice(self, Ws) -> torch.Tensor:
        """Round vectors -> (n_aq, nrow, 8) stacked queried columns."""
        cols = []
        for idx, rot in self.advice_idx_rot:
            rnd, colj = advice_round_col(self.num_advice, idx, len(Ws))
            col = Ws[rnd][colj * self.nrow : (colj + 1) * self.nrow]
            cols.append(torch.roll(col, -rot, dims=0) if rot else col)
        if not cols:
            return torch.zeros(1, self.nrow, NUM_WORDS, dtype=torch.int32,
                               device=self.device)
        return torch.stack(cols).contiguous()

    def fold_eval_multi(self, W1s, W2s, j_values: Sequence[int],
                        ch1: Sequence[int], ch2: Sequence[int], rows=None):
        """P(W1 + j*W2) for every j on rows [lo, hi) (all rows without
        `rows`).  ch1/ch2: plain-int challenge vectors of the two instances
        (the challenge at point j is ch1 + j*ch2 mod p).  Returns (n_j,
        hi - lo, 8) Montgomery words."""
        p = self.modulus
        lf = self.lf
        scalars, ops, ops_t, n_regs, consts = self._program(len(ch1))
        w1 = self._stack_advice(list(W1s))
        w2 = self._stack_advice(list(W2s))
        jm = lf.encode([j % p for j in j_values], self.device)
        ch_rows = []
        for j in j_values:
            chj = [(a + j * b) % p for a, b in zip(ch1, ch2)]
            ch_rows.append(chj + [_eval_scalar(s, p, chj) for s in scalars])
        n_ch = max(len(ch1) + len(scalars), 1)
        if ch_rows and ch_rows[0]:
            ch = lf.encode([v for row in ch_rows for v in row], self.device)
            ch = ch.reshape(len(j_values), n_ch, NUM_WORDS)
        else:
            ch = torch.zeros(len(j_values), 1, NUM_WORDS, dtype=torch.int32,
                             device=self.device)
        if self.device.type == "cpu":
            return fold_eval_plain(lf, ops, self.static_stack, w1, w2, ch, jm,
                                   consts, rows)
        return fold_eval_cuda(lf, ops_t, n_regs, self.static_stack, w1, w2,
                              ch, jm, consts, rows)


def _row_range(rows, nrow: int):
    lo, hi = (0, nrow) if rows is None else rows
    if not 0 <= lo <= hi <= nrow:
        raise ValueError(f"fold_eval: rows {rows} outside [0, {nrow})")
    return lo, hi


@torch.inference_mode()
def fold_eval_plain(lf, ops, stat, w1, w2, ch, jm, consts,
                    rows=None) -> torch.Tensor:
    """Plain torch version of the fold_eval kernel: the same op list,
    interpreted over whole columns (the rows [lo, hi) of them with `rows`)
    on lazy field values."""
    lo, hi = _row_range(rows, stat.shape[1])
    stat, w1, w2 = stat[:, lo:hi], w1[:, lo:hi], w2[:, lo:hi]
    n_j, nrow = jm.shape[0], hi - lo
    dev = stat.device
    out = torch.empty(n_j, nrow, NUM_WORDS, dtype=torch.int32, device=dev)
    for j in range(n_j):
        jv = lf.lz(jm[j]).t.expand(nrow, -1)
        jv = Lz(lf, jv, 1)
        regs = {}
        for op, a, b, dst in ops:
            if op == OP_LOAD_STATIC:
                r = lf.lz(stat[a])
            elif op == OP_LOAD_FOLD:
                r = lf.lz(w1[a]) + jv * lf.lz(w2[a])
            elif op == OP_LOAD_CH:
                r = Lz(lf, lf.lz(ch[j, a]).t.expand(nrow, -1), 1)
            elif op == OP_LOAD_CONST:
                r = Lz(lf, lf.lz(consts[a]).t.expand(nrow, -1), 1)
            elif op == OP_ADD:
                r = regs[a] + regs[b]
            elif op == OP_MUL:
                r = regs[a] * regs[b]
            elif op == OP_NEG:
                r = -regs[a]
            else:
                out[j] = lf.canon(regs[a])
                continue
            regs[dst] = r
    return out


def fold_eval_cuda(lf, ops_t, n_regs, stat, w1, w2, ch, jm, consts, rows=None):
    """Launch csrc/fold_eval.cu on rows [lo, hi) (all rows without `rows`);
    returns (n_j, hi - lo, 8) Montgomery words."""
    global launches
    field = _build.field_id(lf.modulus)
    nrow = stat.shape[1]
    lo, hi = _row_range(rows, nrow)
    n_j, n_ops = jm.shape[0], ops_t.shape[0]
    dev = stat.device
    for t in (stat, w1, w2, ch, jm, consts):
        if (t.device != dev or dev.type != "cuda" or t.dtype != torch.int32
                or t.shape[-1] != NUM_WORDS):
            raise ValueError("fold_eval_cuda: expects int32 word tensors on "
                             "one CUDA device")
    if w1.shape[1] != nrow or w2.shape[1] != nrow:
        raise ValueError("fold_eval_cuda: the columns differ in length")
    if _build.lib().mira_fold_eval_block(n_regs, n_ops) == 0:
        raise ValueError(f"fold_eval_cuda: {n_regs} registers and {n_ops} ops do "
                         "not fit one 32-row block's shared memory")
    stat, w1, w2, ch, jm, consts, ops_t = (
        t.contiguous() for t in (stat, w1, w2, ch, jm, consts, ops_t))
    out = torch.empty(n_j, hi - lo, NUM_WORDS, dtype=torch.int32, device=dev)
    if hi == lo or n_j == 0:
        return out
    err = _build.lib().mira_fold_eval(
        field, ops_t.data_ptr(), n_ops, n_regs, stat.data_ptr(),
        w1.data_ptr(), w2.data_ptr(), ch.data_ptr(), ch.shape[1],
        jm.data_ptr(), n_j, consts.data_ptr(), nrow, lo, hi - lo,
        out.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, "fold_eval")
    launches += 1
    return out

