"""The plain decider of a two-curve Nova-style IVC, in Python integers and
numpy, with the frozen host MSM of msm.py.

It judges the state that the program's timed path left behind, after the
window: the step counter and z_i of both sides, the public-IO hashes X0 and
X1 that bind both folded instances to the last fresh trace, both folded
accumulators (relaxed gate relation on every row, copy constraints, lookup
sums, every witness and error commitment) and the last fresh trace of the
secondary side (its SPS challenges, its gate relation, its commitments).

What it takes from the program: the outputs it judges (instances, witnesses,
E, z_i, the step counter) and the public parameters' structure of each side
(selectors, fixed columns, gate expressions, the copy permutation, the pp
digest points).  Re-deriving the structure would mean synthesising the
step-folding circuit again; it is the program's set-up state, and the
decider follows the program from it.  Everything else is worked out here
again: the hash chain of the step circuit, every transcript hash, the gate
values, the copies and every commitment.  Nothing here imports the program;
the program's objects are read by their attributes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from . import msm, poseidon
from .curves import CURVES, Curve, Point

CHALLENGE_BITS = 128
R = 1 << 256


# -- reading the program's outputs -------------------------------------------


def point(pt) -> Point:
    """The program's affine point as (x, y), or None at infinity."""
    if pt.is_identity():
        return None
    return int(pt.x.v), int(pt.y.v)


def words(t) -> np.ndarray:
    """A (n, 8) int32 word tensor of the program, on the host."""
    return np.ascontiguousarray(t.detach().cpu().numpy(), dtype="<i4")


def mont_column(w: np.ndarray, p: int) -> np.ndarray:
    """(n, 8) Montgomery words -> the plain values as an object array."""
    buf = w.tobytes()
    rinv = pow(R, -1, p)
    vals = np.array([int.from_bytes(buf[32 * i: 32 * i + 32], "little")
                     for i in range(w.shape[0])], dtype=object)
    return vals * rinv % p


def to_mont(values: Sequence[int], p: int) -> np.ndarray:
    """Plain ints -> (n, 8) int32 Montgomery words."""
    buf = b"".join((v * R % p).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype="<i4").reshape(len(values), 8).copy()


# -- gate relation --------------------------------------------------------------


def advice_round_col(num_advice: int, index: int, num_witness: int):
    """A fold variable's (witness round, column): advice columns in round 0,
    then five per lookup split over the rounds that hold them."""
    if index < num_advice:
        return 0, index
    lookup, sub = divmod(index - num_advice, 5)
    first, sub = (True, sub) if sub < 3 else (False, sub - 3)
    if num_witness == 2:
        return (0, num_advice + 3 * lookup + sub) if first else (1, 2 * lookup + sub)
    if num_witness == 3:
        return (1, 3 * lookup + sub) if first else (2, 2 * lookup + sub)
    raise ValueError(f"{num_witness} witness rounds")


class Columns:
    """The columns a gate expression queries, as object arrays of plain
    values, decoded once each."""

    def __init__(self, S, Ws):
        self.S, self.Ws = S, Ws
        self.p = S.curve.scalar_modulus
        self.nrow = 1 << S.k
        self.n_sel, self.n_fix = len(S.selectors), len(S.fixed_columns)
        self.cache: Dict[int, np.ndarray] = {}

    def get(self, index: int, rotation: int) -> np.ndarray:
        col = self.cache.get(index)
        if col is None:
            if index < self.n_sel:
                col = np.array([1 if b else 0 for b in self.S.selectors[index]], dtype=object)
            elif index < self.n_sel + self.n_fix:
                col = np.array([v % self.p for v in self.S.fixed_columns[index - self.n_sel]],
                               dtype=object)
            else:
                width = self.S.num_advice_columns + 5 * self.S.num_lookups()
                idx = index - self.n_sel - self.n_fix
                if idx >= width:
                    raise ValueError(f"query {index} reads a second instance")
                rnd, c = advice_round_col(self.S.num_advice_columns, idx, len(self.Ws))
                col = mont_column(self.Ws[rnd][c * self.nrow:(c + 1) * self.nrow], self.p)
            if len(col) < self.nrow:
                col = np.concatenate([col, np.zeros(self.nrow - len(col), dtype=object)])
            self.cache[index] = col
        rot = rotation % self.nrow
        return np.roll(col, -rot) if rot else col


def evaluate(expr, cols: Columns, challenges: Sequence[int]) -> np.ndarray:
    """The expression on every row.  The tree is walked by node type; a
    subtree shared by several parents is evaluated once."""
    p = cols.p
    memo: Dict[int, object] = {}

    def ev(e):
        key = id(e)
        if key in memo:
            return memo[key]
        kind = type(e).__name__
        if kind == "Const":
            out = e.value % p
        elif kind == "Poly":
            out = cols.get(e.query.index, e.query.rotation)
        elif kind == "Challenge":
            out = challenges[e.index] % p
        elif kind == "Neg":
            out = (-ev(e.a)) % p
        elif kind == "Sum":
            out = (ev(e.a) + ev(e.b)) % p
        elif kind == "Product":
            out = ev(e.a) * ev(e.b) % p
        elif kind == "Scaled":
            out = ev(e.a) * (e.k % p) % p
        else:
            raise TypeError(f"unknown expression node {kind}")
        memo[key] = out
        return out

    out = ev(expr)
    if not isinstance(out, np.ndarray):
        out = np.full(cols.nrow, out, dtype=object)
    return out


def gate_rows_wrong(S, Ws, challenges, which: str, E=None) -> int:
    """Rows where the expression (`homogeneous` against E, or `compressed`
    against 0) does not hold."""
    cols = Columns(S, Ws)
    expr = getattr(S.compressed_gates, which)
    out = evaluate(expr, cols, challenges)
    want = mont_column(E, cols.p) if E is not None else np.zeros(cols.nrow, dtype=object)
    return int(np.count_nonzero(out != want))


def lookup_sums_wrong(S, Ws) -> int:
    """Lookups whose two log-derivative sums differ."""
    n = S.num_lookups()
    if n == 0:
        return 0
    nrow, p = 1 << S.k, S.curve.scalar_modulus
    rnd = Ws[2 if S.has_vector_lookup() else 1]
    wrong = 0
    for i in range(n):
        h = mont_column(rnd[2 * i * nrow:(2 * i + 1) * nrow], p)
        g = mont_column(rnd[(2 * i + 1) * nrow:(2 * i + 2) * nrow], p)
        wrong += int((sum(h.tolist()) - sum(g.tolist())) % p != 0)
    return wrong


def copy_rows_wrong(S, instance: Sequence[int], W0: np.ndarray) -> int:
    """Entries of Z = instance || advice where P Z != Z."""
    P = S.permutation_matrix
    p = S.curve.scalar_modulus
    nrow = 1 << S.k
    Z = np.concatenate([to_mont([v % p for v in instance], p).reshape(-1, 8),
                        W0[: nrow * S.num_advice_columns]])
    if not np.all(P.v == 1):
        raise ValueError("a copy permutation with weights other than 1")
    return int(np.count_nonzero(np.any(Z[P.i] != Z[P.j], axis=1)))


# -- transcripts ----------------------------------------------------------------


def sponge(curve: Curve, ro):
    """A fresh random oracle over the curve's base field; ro = (t, rate, R_F, R_P)."""
    t, _rate, r_f, r_p = ro
    return poseidon.Sponge(curve.p, t, r_f, r_p)


def absorb_point(s: poseidon.Sponge, pt: Point):
    s.absorb([0, 0] if pt is None else list(pt))


def instance_hash(curve: Curve, ro, digest: Point, step: int, z0, zi, U,
                  limb_width: int, limbs_count: int) -> int:
    """X = H(pp digest, step, z_0, z_i, U) with U's scalars cut into bignat
    limbs, squeezed to 128 bits."""
    s = sponge(curve, ro)
    absorb_point(s, digest)
    s.absorb([step, *z0, *zi])
    for c in U.W_commitments:
        absorb_point(s, point(c))
    absorb_point(s, point(U.E_commitment))
    mask = (1 << limb_width) - 1
    for v in list(U.instance) + list(U.challenges):
        v %= curve.p
        if v >> (limb_width * limbs_count):
            raise ValueError("a scalar too wide for its limbs")
        s.absorb([(v >> (i * limb_width)) & mask for i in range(limbs_count)])
    s.absorb([U.u])
    for g in U.g1_elements:
        absorb_point(s, point(g))
    for g in U.g2_elements:
        s.absorb([0] * 4 if g.is_inf else [int(g.x.c0.v), int(g.x.c1.v),
                                           int(g.y.c0.v), int(g.y.c1.v)])
    s.absorb([int(e.v) for e in U.gt_element.elements])
    return s.squeeze(CHALLENGE_BITS)


def sps_challenges_wrong(curve: Curve, ro, u) -> int:
    """The fresh instance's SPS challenges against its transcript: the
    instance, then each round's commitment before its challenge."""
    if not u.challenges:
        return 0
    s = sponge(curve, ro)
    s.absorb(list(u.instance))
    wrong = 0
    for i, ch in enumerate(u.challenges):
        absorb_point(s, point(u.W_commitments[i]))
        wrong += int(s.squeeze(CHALLENGE_BITS) != ch)
    return wrong


# -- the structure followed -------------------------------------------------------


def expression_text(expr) -> str:
    """A canonical text of an expression tree, walked by node type."""
    memo: Dict[int, str] = {}

    def txt(e):
        key = id(e)
        if key not in memo:
            kind = type(e).__name__
            if kind == "Const":
                memo[key] = f"c{e.value}"
            elif kind == "Poly":
                memo[key] = f"q{e.query.index}@{e.query.rotation}"
            elif kind == "Challenge":
                memo[key] = f"x{e.index}"
            elif kind == "Neg":
                memo[key] = f"-({txt(e.a)})"
            elif kind == "Sum":
                memo[key] = f"({txt(e.a)}+{txt(e.b)})"
            elif kind == "Product":
                memo[key] = f"({txt(e.a)}*{txt(e.b)})"
            elif kind == "Scaled":
                memo[key] = f"({txt(e.a)}*c{e.k})"
            else:
                raise TypeError(f"unknown expression node {kind}")
        return memo[key]

    return txt(expr)


def structure_fingerprint(S) -> str:
    """sha256 of what the decider takes from a side's structure beyond the pp
    digest (which covers its sizes, fixed columns and copy permutation): its
    selectors and both gate expressions."""
    import hashlib

    h = hashlib.sha256(f"{S.k} {S.num_advice_columns} {S.num_lookups()}".encode())
    for col in S.selectors:
        h.update(np.packbits(np.asarray(col, dtype=bool)).tobytes())
    for which in ("compressed", "homogeneous"):
        h.update(expression_text(getattr(S.compressed_gates, which)).encode())
    return h.hexdigest()


def structure_wrong(pp, stated: dict) -> int:
    """The public parameters the decider follows against the configuration's
    stated ones: both pp digest points and both sides' fingerprints."""
    wrong = int([list(point(pp.digest_1)), list(point(pp.digest_2))]
                != [stated["digest_1"], stated["digest_2"]])
    wrong += int(structure_fingerprint(pp.primary.S) != stated["primary"])
    wrong += int(structure_fingerprint(pp.secondary.S) != stated["secondary"])
    return wrong


# -- the decider ----------------------------------------------------------------


class Key:
    """A side's commitment key: the points of its key file (Pedersen), or
    the linear mock key G * <weights, v> of the CPU tests."""

    def __init__(self, curve: Curve, rows: np.ndarray = None, mock_label: bytes = None,
                 mock_k: int = 0):
        self.curve = curve
        if rows is not None:
            self.xs, self.ys = msm.key_coords(rows)
            self.weights = None
        else:
            import hashlib

            seed = hashlib.shake_256(b"mira-mock-ck" + mock_label).digest(16 << mock_k)
            self.weights = np.array([int.from_bytes(seed[16 * i:16 * i + 16], "little")
                                     for i in range(1 << mock_k)], dtype=object)

    def commit(self, w: np.ndarray) -> Point:
        if self.weights is None:
            return msm.msm_words(self.curve, w, self.xs, self.ys, montgomery=True)
        vals = mont_column(w, self.curve.r)
        return self.curve.mul(self.curve.generator,
                              int(np.dot(self.weights[: len(vals)], vals)) % self.curve.r)


def commitments_wrong(key: Key, Ws, claimed) -> int:
    return sum(int(key.commit(w) != point(c)) for w, c in zip(Ws, claimed))


def decide(ivc, z0: Dict[str, List[int]], folds: int, zi_expected: Callable,
           keys: Dict[str, Key], ro, structure: dict) -> Dict[str, int]:
    """Judge the IVC after `folds` fold steps from z0 = {"primary": [...],
    "secondary": [...]}; zi_expected(side, z0, steps) gives a side's z
    after `steps` applications of its step function; `structure` is the
    configuration's statement of the public parameters
    (structure_wrong). Returns named counts of what is wrong; every one
    of them is 0 for a correct IVC."""
    pp = ivc.pp
    out = {"structure": structure_wrong(pp, structure), "steps": int(ivc.step != folds + 1)}
    wrong_z = 0
    for side in ("primary", "secondary"):
        ctx = getattr(ivc, side)
        wrong_z += int(list(ctx.z_0) != list(z0[side]))
        wrong_z += int(list(ctx.z_i) != list(zi_expected(side, z0[side], folds + 1)))
    out["z_values"] = wrong_z

    c1 = CURVES[pp.primary_curve.name]
    c2 = CURVES[pp.secondary_curve.name]
    U1, U2 = ivc.primary.relaxed_trace.U, ivc.secondary.relaxed_trace.U
    u_last = ivc.secondary_trace.u
    x0 = instance_hash(c2, ro, point(pp.digest_2), ivc.step, ivc.primary.z_0,
                       ivc.primary.z_i, U2, pp.limb_width, pp.limbs_count)
    x1 = instance_hash(c1, ro, point(pp.digest_1), ivc.step, ivc.secondary.z_0,
                       ivc.secondary.z_i, U1, pp.limb_width, pp.limbs_count)
    out["io_hashes"] = (int(x0 != u_last.instance[0] % c1.r)
                        + int(x1 != u_last.instance[1] % c2.r))

    gates = copies = lookups = commits = 0
    for side, curve in (("primary", c1), ("secondary", c2)):
        S = getattr(pp, side).S
        U = getattr(ivc, side).relaxed_trace.U
        W = getattr(ivc, side).relaxed_trace.W
        Ws, E = [words(w) for w in W.W], words(W.E)
        gates += gate_rows_wrong(S, Ws, list(U.challenges) + [U.u], "homogeneous", E)
        copies += copy_rows_wrong(S, U.instance, Ws[0])
        lookups += lookup_sums_wrong(S, Ws)
        commits += commitments_wrong(keys[side], Ws + [E],
                                     list(U.W_commitments) + [U.E_commitment])
        del Ws, E
    S2 = pp.secondary.S
    w_last = [words(w) for w in ivc.secondary_trace.w.W]
    out["sps_challenges"] = sps_challenges_wrong(CURVES[u_last.curve.name], ro, u_last)
    gates += gate_rows_wrong(S2, w_last, list(u_last.challenges), "compressed")
    lookups += lookup_sums_wrong(S2, w_last)
    commits += commitments_wrong(keys["secondary"], w_last, u_last.W_commitments)
    out.update(gate_rows=gates, copy_rows=copies, lookup_sums=lookups, commitments=commits)
    return out
