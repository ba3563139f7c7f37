"""The plain step functions and pairing checks of the snarkstar-b1
configuration.

Primary side: a sparse Merkle tree of `depth` levels (leaves at level 0,
the root at level depth - 1, so 2^(depth-1) leaves); an empty leaf is
H(0, 0), an empty node of level l + 1 is H(e_l, e_l), and a node is
H(left, right), H a fresh Poseidon sponge (T, RATE, R_F, R_P =
`node_hash`) over the two children squeezed to 255 bits.  A step sets
`batch_size` leaves, in order; z is [root].  Secondary side: the trivial
circuit, z unchanged.

`decide_more` judges the pairing data of the folded primary instance: its
Gt element against R(U) from real pairings of its folded G1/G2 elements
(reference/groth16.py), and every Groth16 proof that was folded against
the plain verifier.
"""

from reference import groth16, pairing, poseidon
from reference.decider import point


class Tree:
    def __init__(self, p: int, depth: int, node_hash):
        t, _rate, r_f, r_p = node_hash
        self.p, self.depth = p, depth
        self.hash = lambda a, b: poseidon.Sponge(p, t, r_f, r_p).absorb([a, b]).squeeze(255) % p
        self.empty = [self.hash(0, 0)]
        for _ in range(depth - 1):
            self.empty.append(self.hash(self.empty[-1], self.empty[-1]))
        self.nodes = {}

    def node(self, level: int, index: int) -> int:
        return self.nodes.get((level, index), self.empty[level])

    def set_leaf(self, index: int, value: int):
        if not 0 <= index < 1 << (self.depth - 1):
            raise ValueError(f"leaf {index} outside the tree")
        v = value % self.p
        self.nodes[(0, index)] = v
        for level in range(self.depth - 1):
            sibling = self.node(level, index ^ 1)
            v = self.hash(v, sibling) if index % 2 == 0 else self.hash(sibling, v)
            index //= 2
            self.nodes[(level + 1, index)] = v

    def root(self) -> int:
        return self.node(self.depth - 1, 0)


def z_after(cfg: dict, moduli, side: str, z0, steps: int, inputs: dict):
    """A side's z after `steps` steps from z0: the primary's root after the
    recorded updates (those before z0 replayed first, whose root must be
    z0), or [None] where the record does not lead there."""
    s = cfg[side]
    if s["circuit"] == "trivial":
        return list(z0)
    if s["circuit"] != "merkle":
        raise ValueError(f"no plain step function for {s['circuit']!r}")
    tree = Tree(moduli[0 if side == "primary" else 1], s["depth"], s["node_hash"])
    updates, start = inputs["updates"], inputs["start"]
    end = start + steps * s["batch_size"]
    for index, value in updates[:start]:
        tree.set_leaf(index, value)
    if [tree.root()] != list(z0) or len(updates) < end:
        return [None]
    for index, value in updates[start:end]:
        tree.set_leaf(index, value)
    return [tree.root()]


def g2(q):
    """The program's G2 point as ((x0, x1), (y0, y1)), or None at infinity."""
    if q.is_inf:
        return None
    return (int(q.x.c0.v), int(q.x.c1.v)), (int(q.y.c0.v), int(q.y.c1.v))


def verifying_key(vk) -> groth16.VerifyingKey:
    return groth16.VerifyingKey(point(vk.alpha_g1), g2(vk.beta_g2), g2(vk.gamma_g2),
                                g2(vk.delta_g2), [point(p) for p in vk.gamma_abc_g1])


def decide_more(ivc, system, cfg: dict) -> dict:
    """`gt_accumulator`: 1 where the folded primary instance's Gt element is
    not R(U); `groth16_proofs`: the folded proofs the plain verifier refuses."""
    vk_program, proofs = system.folded_proofs()
    vk = verifying_key(vk_program)
    refused = sum(int(not groth16.verify(vk, groth16.Proof(point(pf.a), g2(pf.b), point(pf.c)),
                                         public))
                  for pf, public in proofs)
    U = ivc.primary.relaxed_trace.U
    want = pairing.one()
    for i in range(cfg["primary"]["groth16"]["batch"]):
        a, c, x = (point(e) for e in U.g1_elements[3 * i:3 * i + 3])
        want = pairing.mul(want, groth16.relaxed_relation(vk, a, g2(U.g2_elements[i]), c, x,
                                                          U.u))
    gt = pairing.from_layout([int(e.v) for e in U.gt_element.elements])
    return {"gt_accumulator": int(want != gt), "groth16_proofs": refused}
