"""Sparse Merkle tree gadget: off-circuit tree + in-circuit update chip.

Mirrors src/gadgets/merkle_tree_gadget/: depth-32 tree with
default-value subtrees, node hash = Poseidon(T=5, RATE=4, R_F=R_P=10) of
(left, right), and `MerkleTreeUpdateChip.prove_next_update` re-hashing the
old/new paths level by level with copy constraints.

Copied from mira_tpu/gadgets/merkle.py; the port imports nothing of mira_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..fields.host import field
from ..ops.poseidon import PoseidonHash, get_spec
from .main_gate import CyclicAssigner, MainGateConfig
from .poseidon_chip import PoseidonChip

DEPTH = 32
T, RATE, R_F, R_P = 5, 4, 10, 10
NUM_BITS = 255
INDEX_LIMIT = 1 << 31


def merkle_hash(modulus: int, l: int, r: int) -> int:
    F = field(modulus)
    h = PoseidonHash(get_spec(modulus, T, RATE, R_F, R_P))
    h.update([F(l), F(r)])
    return h.output(F, NUM_BITS).v


@dataclasses.dataclass
class NodeUpdate:
    index: int
    old: int
    new: int
    sibling: Optional[int]  # None at the root


@dataclasses.dataclass
class Proof:
    path: List[NodeUpdate]  # level 0 (leaf) .. DEPTH-1 (root)

    def root(self) -> NodeUpdate:
        return self.path[-1]

    def verify(self, modulus: int) -> bool:
        for level in range(DEPTH - 1):
            u = self.path[level]
            left_sibling = u.index % 2 == 1  # sibling on the left
            if left_sibling:
                old_n = merkle_hash(modulus, u.sibling, u.old)
                new_n = merkle_hash(modulus, u.sibling, u.new)
            else:
                old_n = merkle_hash(modulus, u.old, u.sibling)
                new_n = merkle_hash(modulus, u.new, u.sibling)
            nxt = self.path[level + 1]
            if nxt.old != old_n or nxt.new != new_n:
                return False
        return True


class Tree:
    """Sparse Merkle tree with per-level default values
    (off_circuit.rs Tree)."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.filled: Dict[Tuple[int, int], int] = {}  # (level, index) -> value
        self.defaults = [merkle_hash(modulus, 0, 0)]
        for _ in range(1, DEPTH):
            d = self.defaults[-1]
            self.defaults.append(merkle_hash(modulus, d, d))

    def get(self, level: int, index: int) -> int:
        return self.filled.get((level, index), self.defaults[level])

    def root(self) -> int:
        return self.get(DEPTH - 1, 0)

    def update_leaf(self, index: int, value: int) -> Proof:
        assert index < INDEX_LIMIT
        path: List[NodeUpdate] = []
        cur_old = self.get(0, index)
        cur_new = value % self.modulus
        self.filled[(0, index)] = cur_new
        idx = index
        for level in range(DEPTH):
            if level == DEPTH - 1:
                path.append(NodeUpdate(idx, cur_old, cur_new, None))
                break
            sib_idx = idx + 1 if idx % 2 == 0 else idx - 1
            sibling = self.get(level, sib_idx)
            path.append(NodeUpdate(idx, cur_old, cur_new, sibling))
            if idx % 2 == 0:
                old_n = merkle_hash(self.modulus, cur_old, sibling)
                new_n = merkle_hash(self.modulus, cur_new, sibling)
            else:
                old_n = merkle_hash(self.modulus, sibling, cur_old)
                new_n = merkle_hash(self.modulus, sibling, cur_new)
            idx //= 2
            cur_old = self.get(level + 1, idx)
            assert cur_old == old_n, "tree inconsistency"
            cur_new = new_n
            self.filled[(level + 1, idx)] = cur_new
        return Proof(path)


class MerkleTreeUpdateChip:
    """In-circuit verification of one leaf update (chip.rs:16-103).

    Deviation from the reference: the reference picks the (left, right)
    hash-input order with a host-side branch on the path index
    (chip.rs `left_sibling`), which makes the circuit SHAPE depend on the
    witness.  Here the side flag is an assigned bit driving in-circuit
    conditional selects, so the synthesis structure is index-independent —
    a requirement for the witness-tape replay (table/tape.py) and the more
    standard Merkle-membership circuit design anyway."""

    def __init__(self, proof: Proof, modulus: int, check: bool = True):
        if check:
            assert proof.verify(modulus)
        self.proof = proof
        self.spec = get_spec(modulus, T, RATE, R_F, R_P)

    def prove_next_update(self, ctx, config: MainGateConfig) -> NodeUpdate:
        from .main_gate import MainGate

        mg = MainGate(config)
        assigner = CyclicAssigner(config.iter_advice_columns(), advice=True)
        assigned = []
        for u in self.proof.path:
            assigned.append(
                NodeUpdate(
                    index=u.index,
                    old=assigner.assign_next(ctx, u.old),
                    new=assigner.assign_next(ctx, u.new),
                    sibling=(
                        assigner.assign_next(ctx, u.sibling)
                        if u.sibling is not None
                        else None
                    ),
                )
            )
        assigner.finish(ctx)

        for level in range(DEPTH - 1):
            u = assigned[level]
            nxt = assigned[level + 1]
            # b = 1 => sibling on the left (odd index)
            b = mg.assign_bit(ctx, u.index % 2)
            pairs = [
                (
                    mg.conditional_select(ctx, u.sibling, node, b),
                    mg.conditional_select(ctx, node, u.sibling, b),
                )
                for node in (u.old, u.new)
            ]
            outs = []
            for l, r in pairs:
                chip = PoseidonChip(config, self.spec)
                chip.update([l, r])
                outs.append(chip.squeeze(ctx))
            ctx.constrain_equal(outs[0].cell, nxt.old.cell)
            ctx.constrain_equal(outs[1].cell, nxt.new.cell)
            assert outs[0].value == nxt.old.value
            assert outs[1].value == nxt.new.value
        return assigned[-1]
