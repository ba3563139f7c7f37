"""Expression evaluation over circuit tables (port of
mira_tpu/polynomial/evaluator.py).

* `eval_rows_host` — Python-int row evaluation, the golden reference.
* `ColumnEvaluator` — plain torch evaluation of a whole column at once on
  lazy field values (rotations are `torch.roll`); an audit evaluator
  independent of the fold evaluator's op list.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from mira_tpu.polynomial.expression import Expression, Query

from ..fields.limbs import limb_field


@dataclasses.dataclass
class EvalDomain:
    """Everything needed to resolve query indices (see mira_tpu)."""

    modulus: int
    num_advice: int
    num_lookup: int
    challenges: List[int]
    selectors: List[List[bool]]
    fixed: List[List[int]]
    W1s: List[List[int]]
    W2s: List[List[int]]

    @property
    def nrow(self) -> int:
        if self.fixed:
            return len(self.fixed[0])
        if self.selectors:
            return len(self.selectors[0])
        raise ValueError("fixed & selectors both empty")

    def advice_round_col(self, index: int, num_witness: int):
        return advice_round_col(self.num_advice, index, num_witness)


def advice_round_col(num_advice: int, index: int, num_witness: int):
    """Map a fold-var index (within one instance) to (round, column)."""
    if index < num_advice:
        return (0, index)
    lookup_index = (index - num_advice) // 5
    sub = (index - num_advice) % 5
    first_round, sub = (True, sub) if sub < 3 else (False, sub - 3)
    if num_witness == 2:
        if first_round:
            return (0, num_advice + lookup_index * 3 + sub)
        return (1, lookup_index * 2 + sub)
    if num_witness == 3:
        if first_round:
            return (1, lookup_index * 3 + sub)
        return (2, lookup_index * 2 + sub)
    raise ValueError(f"invalid num_witness {num_witness}")


def eval_rows_host(expr: Expression, data: EvalDomain) -> List[int]:
    """Evaluate `expr` on every row; returns python ints."""
    p = data.modulus
    nrow = data.nrow
    max_width = data.num_advice + 5 * data.num_lookup
    n_sel, n_fix = len(data.selectors), len(data.fixed)

    def column(q: Query) -> List[int]:
        if q.index < n_sel:
            col = [1 if b else 0 for b in data.selectors[q.index]]
        elif q.index < n_sel + n_fix:
            col = data.fixed[q.index - n_sel]
        else:
            idx = q.index - n_sel - n_fix
            if idx < max_width:
                Ws, num_witness = data.W1s, len(data.W1s)
            else:
                idx -= max_width
                Ws, num_witness = data.W2s, len(data.W2s)
            rnd, colj = data.advice_round_col(idx, num_witness)
            col = Ws[rnd][colj * nrow : (colj + 1) * nrow]
        rot = q.rotation % nrow
        if rot:
            col = list(col[rot:]) + list(col[:rot])
        return col

    return expr.evaluate(
        constant=lambda c: [c % p] * nrow,
        poly=lambda q: column(q),
        challenge=lambda i: [data.challenges[i] % p] * nrow,
        negated=lambda a: [(-x) % p for x in a],
        sum_=lambda a, b: [(x + y) % p for x, y in zip(a, b)],
        product=lambda a, b: [(x * y) % p for x, y in zip(a, b)],
        scaled=lambda a, k: [(x * k) % p for x in a],
    )


class ColumnEvaluator:
    """Plain torch column evaluation of one expression: static columns are
    encoded once on `device`; witness rounds are (len, 8) Montgomery word
    tensors; returns (nrow, 8) Montgomery words."""

    def __init__(self, expr: Expression, modulus: int, num_advice: int,
                 num_lookup: int, selectors, fixed, nrow: int, device="cpu"):
        self.expr = expr
        self.lf = limb_field(modulus)
        self.modulus = modulus
        self.num_advice = num_advice
        self.num_lookup = num_lookup
        self.nrow = nrow
        self.n_sel = len(selectors)
        self.n_fix = len(fixed)
        self.static_cols = [
            self.lf.encode([1 if b else 0 for b in col], device)
            for col in selectors
        ] + [self.lf.encode(col, device) for col in fixed]

    def _resolve(self, q: Query, W1s, W2s) -> torch.Tensor:
        max_width = self.num_advice + 5 * self.num_lookup
        if q.index < self.n_sel + self.n_fix:
            col = self.static_cols[q.index]
        else:
            idx = q.index - self.n_sel - self.n_fix
            if idx < max_width:
                Ws = W1s
            else:
                idx -= max_width
                Ws = W2s
            rnd, colj = advice_round_col(self.num_advice, idx, len(Ws))
            col = Ws[rnd][colj * self.nrow : (colj + 1) * self.nrow]
        rot = q.rotation % self.nrow
        return torch.roll(col, -rot, dims=0) if rot else col

    def _run(self, W1s, W2s, challenges) -> torch.Tensor:
        lf = self.lf
        dev = self.static_cols[0].device if self.static_cols else W1s[0].device
        shape = (self.nrow,)
        out = self.expr.evaluate(
            constant=lambda c: lf.lz_const(c, shape, dev),
            poly=lambda q: lf.lz(self._resolve(q, W1s, W2s)),
            challenge=lambda i: lf.lz_const(challenges[i], shape, dev),
            negated=lambda a: -a,
            sum_=lambda a, b: a + b,
            product=lambda a, b: a * b,
            scaled=lambda a, k: a * lf.lz_const(k, shape, dev),
        )
        return lf.canon(out)

    def __call__(self, W1s: Sequence, W2s: Sequence, challenges: Sequence[int]):
        """challenges: python ints."""
        return self._run(list(W1s), list(W2s), [c % self.modulus for c in challenges])

    def fold_eval(self, W1s: Sequence, W2s: Sequence, j: int,
                  challenges: Sequence[int]):
        """P(W1 + j*W2) with the challenges already folded."""
        lf = self.lf
        Wj = [
            lf.canon(lf.lz(a) + lf.lz(b) * lf.lz_const(j, a.shape[:-1], a.device))
            for a, b in zip(W1s, W2s)
        ]
        return self(Wj, (), challenges)
