"""Merkle-tree-update step circuit (port of mira_tpu/workloads/merkle.py):
the same circuit over the port's copy of the gadgets, with the main-gate
width taken from the port's step-folding circuit.  The step circuit of
SnarkStar's primary side (workloads/snarkstar.py)."""

from __future__ import annotations

from collections import deque
from typing import Deque, List

from ..gadgets.main_gate import MainGate
from ..gadgets.merkle import (
    INDEX_LIMIT,
    MerkleTreeUpdateChip,
    NodeUpdate,
    Proof,
    Tree,
)
from ..ivc.step_circuit import StepCircuit

from ..ivc.step_folding_circuit import MAIN_GATE_T


class MerkleTreeUpdateCircuit(StepCircuit):
    """Applies a batch of leaf updates per step; z = [root]
    (reference examples/merkle/circuit.rs).

    Tape-safe: the update chip's structure is index-independent (in-circuit
    side selects), so each step's proof batch binds as flat tape signals —
    per path node: (side bit, old, new, sibling)."""

    arity = 1
    tape_safe = True

    def __init__(self, modulus: int, batch_size: int = 1):
        self.modulus = modulus
        self.batch_size = batch_size
        self.tree = Tree(modulus)
        self.proof_batches: Deque[List[Proof]] = deque()

    def random_update_leaves(self, rng):
        batch = [
            self.tree.update_leaf(rng.randrange(INDEX_LIMIT), rng.randrange(self.modulus))
            for _ in range(self.batch_size)
        ]
        self.proof_batches.append(batch)

    def update_leaves(self, updates):
        """Apply up to batch_size (index, value) updates as one proof batch
        (reference examples/zkml/circuit.rs:101-118); returns (old, new) roots."""
        batch = [
            self.tree.update_leaf(idx, val)
            for idx, val in list(updates)[: self.batch_size]
        ]
        if not batch:
            raise ValueError("No updates provided")
        self.proof_batches.append(batch)
        return batch[0].root().old, batch[-1].root().new

    def pop_front_proof_batch(self):
        if self.proof_batches:
            self.proof_batches.popleft()

    def front_proof_batch(self) -> List[Proof]:
        return self.proof_batches[0]

    def configure(self, cs):
        return MainGate.configure(cs, MAIN_GATE_T)

    def process_step(self, z_i, k, modulus):
        return [self.front_proof_batch()[-1].root().new]

    def synthesize_step(self, config, ctx, z_in):
        prev = z_in[0]
        for proof in self.front_proof_batch():
            update = MerkleTreeUpdateChip(proof, self.modulus).prove_next_update(
                ctx, config
            )
            ctx.constrain_equal(prev.cell, update.old.cell)
            prev = update.new
        return [prev]

    def tape_signals(self):
        out = []
        for proof in self.front_proof_batch():
            for u in proof.path:
                out += [
                    u.index % 2,
                    u.old,
                    u.new,
                    0 if u.sibling is None else u.sibling,
                ]
        return out

    def wrap_for_tape(self, tape):
        view = _TapedMerkleView(self)
        batch = []
        for proof in self.front_proof_batch():
            path = []
            for u in proof.path:
                bit = tape.input(u.index % 2)
                old = tape.input(u.old)
                new = tape.input(u.new)
                sib = tape.input(0 if u.sibling is None else u.sibling)
                path.append(
                    NodeUpdate(
                        index=bit,
                        old=old,
                        new=new,
                        sibling=None if u.sibling is None else sib,
                    )
                )
            batch.append(Proof(path))
        view.wrapped_batch = batch
        return view


class _TapedMerkleView(StepCircuit):
    """Capture-time view of MerkleTreeUpdateCircuit: same synthesis over a
    proof batch whose values are tape inputs (validity of the concrete proof
    is still asserted inside the chip on .v values)."""

    tape_safe = True

    def __init__(self, inner: "MerkleTreeUpdateCircuit"):
        self.inner = inner
        self.arity = inner.arity
        self.modulus = inner.modulus
        self.wrapped_batch = []

    def configure(self, cs):
        return self.inner.configure(cs)

    def synthesize_step(self, config, ctx, z_in):
        prev = z_in[0]
        for proof in self.wrapped_batch:
            update = MerkleTreeUpdateChip(
                proof, self.modulus, check=False
            ).prove_next_update(ctx, config)
            ctx.constrain_equal(prev.cell, update.old.cell)
            prev = update.new
        return [prev]
