"""Symbolic expression IR for Plonkish gates and folding transforms.

Semantics mirror the reference's polynomial IR
(src/polynomial/expression.rs): the same node set
(Constant/Polynomial/Challenge/Negated/Sum/Product/Scaled), the same query
index space (selectors < fixed < advice < lookup-vars, advice/lookup are the
"fold vars"), the same homogenization (pad sub-degrees with powers of a fresh
challenge u) and degree computation.  The `GroupedPoly` expansion by powers of
the folding challenge follows grouped_poly.rs:88-268.

The reference's `visualize()` string format is reproduced so its unit-test
strings (expression.rs:549-606, grouped_poly.rs:294-461) serve as parity
anchors here.

Copied from mira_tpu/polynomial/expression.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Query:
    index: int
    rotation: int = 0


@dataclasses.dataclass
class QueryIndexContext:
    num_selectors: int = 0
    num_fixed: int = 0
    num_advice: int = 0
    num_challenges: int = 0
    num_lookups: int = 0

    def num_fold_vars(self) -> int:
        return self.num_advice + 5 * self.num_lookups

    def shift_advice_index(self, idx: int) -> int:
        return idx + self.num_fold_vars()

    def shift_lookup_index(self, idx: int) -> int:
        return idx + self.num_fold_vars()


# query subtypes
SELECTOR, FIXED, ADVICE, LOOKUP = range(4)


def query_subtype(q: Query, ctx: QueryIndexContext) -> int:
    if q.index < ctx.num_selectors:
        return SELECTOR
    if q.index < ctx.num_selectors + ctx.num_fixed:
        return FIXED
    if q.index < ctx.num_selectors + ctx.num_fixed + ctx.num_advice:
        return ADVICE
    if q.index < ctx.num_selectors + ctx.num_fixed + ctx.num_advice + 5 * ctx.num_lookups:
        return LOOKUP
    raise ValueError(f"unknown query index {q.index} for {ctx}")


class Expression:
    """Base node. Values (constants/scalars) are plain python ints mod the
    ambient field; the modulus is supplied at evaluation time."""

    def __add__(self, o):
        return Sum(self, _coerce(o))

    def __sub__(self, o):
        return Sum(self, Neg(_coerce(o)))

    def __mul__(self, o):
        if isinstance(o, int) and not isinstance(o, bool):
            return Scaled(self, o)
        return Product(self, _coerce(o))

    def __neg__(self):
        return Neg(self)

    # -- traversal ----------------------------------------------------------
    def evaluate(self, constant, poly, challenge, negated, sum_, product, scaled):
        raise NotImplementedError

    def num_challenges(self) -> int:
        s = set()
        self.collect_challenges(s)
        return len(s)

    def collect_challenges(self, s: set):
        pass

    def degree(self, ctx: QueryIndexContext) -> int:
        return self.evaluate(
            constant=lambda c: 0,
            poly=lambda q: 1 if query_subtype(q, ctx) in (ADVICE, LOOKUP) else 0,
            challenge=lambda i: 1,
            negated=lambda a: a,
            sum_=max,
            product=lambda a, b: a + b,
            scaled=lambda a, k: a,
        )

    def visualize(self) -> str:
        raise NotImplementedError

    def __str__(self):
        return self.visualize()

    # -- homogenization (expression.rs:356-429) -----------------------------
    def homogeneous(self, ctx: QueryIndexContext) -> Tuple["Expression", int]:
        """Returns (homogeneous expression, degree)."""
        u = ctx.num_challenges  # index of the fresh homogenizing challenge
        return self._homo(ctx, u)

    def _homo(self, ctx, u):
        raise NotImplementedError

    # -- grouping by fold-challenge powers (grouped_poly.rs:88-138) ----------
    def grouped(self, ctx: QueryIndexContext) -> "GroupedPoly":
        if isinstance(self, Const):
            return GroupedPoly([self])
        if isinstance(self, Poly):
            terms: List[Optional[Expression]] = [self]
            st = query_subtype(self.query, ctx)
            if st == ADVICE:
                terms.append(
                    Poly(Query(ctx.shift_advice_index(self.query.index), self.query.rotation))
                )
            elif st == LOOKUP:
                terms.append(
                    Poly(Query(ctx.shift_lookup_index(self.query.index), self.query.rotation))
                )
            return GroupedPoly(terms)
        if isinstance(self, Challenge):
            return GroupedPoly(
                [Challenge(self.index), Challenge(self.index + ctx.num_challenges)]
            )
        if isinstance(self, Neg):
            return self.a.grouped(ctx).neg()
        if isinstance(self, Sum):
            return self.a.grouped(ctx).add(self.b.grouped(ctx))
        if isinstance(self, Product):
            return self.a.grouped(ctx).mul(self.b.grouped(ctx))
        if isinstance(self, Scaled):
            return self.a.grouped(ctx).scale(self.k)
        raise TypeError(type(self))


def _coerce(o) -> Expression:
    if isinstance(o, Expression):
        return o
    if isinstance(o, int):
        return Const(o)
    raise TypeError(type(o))


def _fmt_const(c: int) -> str:
    h = format(c, "x").lstrip("0")
    return f"0x{h}"


class Const(Expression):
    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = value

    def evaluate(self, constant, poly, challenge, negated, sum_, product, scaled):
        return constant(self.value)

    def _homo(self, ctx, u):
        return Const(self.value), 0

    def visualize(self):
        return _fmt_const(self.value)


class Poly(Expression):
    __slots__ = ("query",)

    def __init__(self, query: Query):
        self.query = query

    def evaluate(self, constant, poly, challenge, negated, sum_, product, scaled):
        return poly(self.query)

    def _homo(self, ctx, u):
        deg = 1 if query_subtype(self.query, ctx) in (ADVICE, LOOKUP) else 0
        return Poly(self.query), deg

    def visualize(self):
        r = self.query.rotation
        rot = "" if r == 0 else (f"[{r}]" if r < 0 else f"[+{r}]")
        return f"Z_{self.query.index}{rot}"


class Challenge(Expression):
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def evaluate(self, constant, poly, challenge, negated, sum_, product, scaled):
        return challenge(self.index)

    def collect_challenges(self, s):
        s.add(self.index)

    def _homo(self, ctx, u):
        return Challenge(self.index), 1

    def visualize(self):
        return f"r_{self.index}"


class Neg(Expression):
    __slots__ = ("a",)

    def __init__(self, a: Expression):
        self.a = a

    def evaluate(self, constant, poly, challenge, negated, sum_, product, scaled):
        return negated(self.a.evaluate(constant, poly, challenge, negated, sum_, product, scaled))

    def collect_challenges(self, s):
        self.a.collect_challenges(s)

    def _homo(self, ctx, u):
        e, d = self.a._homo(ctx, u)
        return Neg(e), d

    def visualize(self):
        return f"-{self.a.visualize()}"


class Sum(Expression):
    __slots__ = ("a", "b")

    def __init__(self, a: Expression, b: Expression):
        self.a = a
        self.b = b

    def evaluate(self, constant, poly, challenge, negated, sum_, product, scaled):
        ev = lambda e: e.evaluate(constant, poly, challenge, negated, sum_, product, scaled)
        return sum_(ev(self.a), ev(self.b))

    def collect_challenges(self, s):
        self.a.collect_challenges(s)
        self.b.collect_challenges(s)

    def _homo(self, ctx, u):
        (la, da), (rb, db) = self.a._homo(ctx, u), self.b._homo(ctx, u)
        if da > db:
            return Sum(la, Product(rb, challenge_in_degree(u, da - db))), da
        if da < db:
            return Sum(Product(la, challenge_in_degree(u, db - da)), rb), db
        return Sum(la, rb), da

    def visualize(self):
        if isinstance(self.b, Neg):
            return f"{self.a.visualize()} - {self.b.a.visualize()}"
        return f"{self.a.visualize()} + {self.b.visualize()}"


class Product(Expression):
    __slots__ = ("a", "b")

    def __init__(self, a: Expression, b: Expression):
        self.a = a
        self.b = b

    def evaluate(self, constant, poly, challenge, negated, sum_, product, scaled):
        ev = lambda e: e.evaluate(constant, poly, challenge, negated, sum_, product, scaled)
        return product(ev(self.a), ev(self.b))

    def collect_challenges(self, s):
        self.a.collect_challenges(s)
        self.b.collect_challenges(s)

    def _homo(self, ctx, u):
        (la, da), (rb, db) = self.a._homo(ctx, u), self.b._homo(ctx, u)
        return Product(la, rb), da + db

    def visualize(self):
        left = f"({self.a.visualize()})" if isinstance(self.a, Sum) else self.a.visualize()
        right = f"({self.b.visualize()})" if isinstance(self.b, Sum) else self.b.visualize()
        return f"{left} * {right}"


class Scaled(Expression):
    __slots__ = ("a", "k")

    def __init__(self, a: Expression, k: int):
        self.a = a
        self.k = k

    def evaluate(self, constant, poly, challenge, negated, sum_, product, scaled):
        return scaled(
            self.a.evaluate(constant, poly, challenge, negated, sum_, product, scaled), self.k
        )

    def collect_challenges(self, s):
        self.a.collect_challenges(s)

    def _homo(self, ctx, u):
        e, d = self.a._homo(ctx, u)
        return Scaled(e, self.k), d

    def visualize(self):
        return f'"{_fmt_const(self.k)}" * {self.a.visualize()}'


def challenge_in_degree(index: int, degree: int) -> Expression:
    result: Expression = Challenge(index)
    for _ in range(2, degree + 1):
        result = Product(result, Challenge(index))
    return result


# ---------------------------------------------------------------------------
# GroupedPoly
# ---------------------------------------------------------------------------


class GroupedPoly:
    """Expression grouped by powers of the fold challenge:
    `x^0*a + x^1*b + x^3*c -> [a, b, None, c]` (grouped_poly.rs:18-28)."""

    def __init__(self, terms: Optional[List[Optional[Expression]]] = None):
        self.terms: List[Optional[Expression]] = terms if terms is not None else []

    def __len__(self):
        return len(self.terms)

    def get(self, degree: int) -> Optional[Expression]:
        return self.terms[degree] if degree < len(self.terms) else None

    def iter_from_first(self):
        """All degree terms except the 0th (grouped_poly.rs:149-151)."""
        return list(self.terms[1:])

    def _resize(self, n):
        if len(self.terms) < n:
            self.terms.extend([None] * (n - len(self.terms)))

    def add(self, other: "GroupedPoly") -> "GroupedPoly":
        n = max(len(self.terms), len(other.terms))
        out: List[Optional[Expression]] = []
        for i in range(n):
            a = self.terms[i] if i < len(self.terms) else None
            b = other.terms[i] if i < len(other.terms) else None
            if a is not None and b is not None:
                out.append(Sum(a, b))
            elif a is not None:
                out.append(a)
            elif b is not None:
                out.append(b)
            else:
                out.append(None)
        return GroupedPoly(out)

    def sub(self, other: "GroupedPoly") -> "GroupedPoly":
        """Term-wise difference (grouped_poly.rs `sub`)."""
        return self.add(other.neg())

    def neg(self) -> "GroupedPoly":
        return GroupedPoly([Neg(t) if t is not None else None for t in self.terms])

    def scale(self, k: int) -> "GroupedPoly":
        return GroupedPoly(
            [Product(Const(k), t) if t is not None else None for t in self.terms]
        )

    def mul(self, other: "GroupedPoly") -> "GroupedPoly":
        # mirror grouped_poly.rs:216-268 (incl. operand ordering by length and
        # reverse iteration, so the built expression trees match)
        if len(self.terms) <= len(other.terms):
            lhs, rhs = other, self
        else:
            lhs, rhs = self, other
        res: List[Optional[Expression]] = []
        rhs_terms = [
            (d, e) for d, e in reversed(list(enumerate(rhs.terms))) if e is not None
        ]
        for ld in reversed(range(len(lhs.terms))):
            le = lhs.terms[ld]
            if le is None:
                continue
            for rd, re in rhs_terms:
                degree = ld + rd
                expr = Product(le, re)
                if degree >= len(res):
                    res.extend([None] * (degree + 1 - len(res)))
                if res[degree] is None:
                    res[degree] = expr
                else:
                    res[degree] = Sum(res[degree], expr)
        return GroupedPoly(res)

    def debug_strings(self) -> List[str]:
        return [
            f"{d};{t.visualize()}" for d, t in enumerate(self.terms) if t is not None
        ]


# ---------------------------------------------------------------------------
# Gate compression (plonk/util.rs:97-117)
# ---------------------------------------------------------------------------


def compress_expressions(exprs: List[Expression], challenge_index: int) -> Expression:
    """RLC of expressions with a challenge: e_0 + y*(e_1 + y*(...))-shaped
    fold matching the reference's associativity exactly."""
    y = Challenge(challenge_index)
    if len(exprs) > 1:
        acc: Expression = Const(0)
        for expr in exprs:
            acc = Sum(expr, Product(acc, y))
        return acc
    return exprs[0] if exprs else Const(0)


@dataclasses.dataclass
class CompressedGates:
    """compressed -> homogeneous -> grouped pipeline (plonk/mod.rs:79-134)."""

    compressed: Expression
    homogeneous: Expression
    homogeneous_degree: int
    grouped: GroupedPoly

    @classmethod
    def new(cls, exprs: List[Expression], ctx: QueryIndexContext) -> "CompressedGates":
        compressed = compress_expressions(exprs, ctx.num_challenges)
        ctx.num_challenges = compressed.num_challenges()
        homogeneous, degree = compressed.homogeneous(ctx)
        ctx.num_challenges = homogeneous.num_challenges()
        grouped = homogeneous.grouped(ctx)
        return cls(compressed, homogeneous, degree, grouped)
