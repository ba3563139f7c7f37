"""The system under test for configurations of `"system": "snarkstar"`:
SnarkStar, Mira's accumulation of Groth16 proofs, on the program's
two-curve IVC (systems/ivc.py: keys, public parameters, problems).

The primary side's step circuit applies Merkle-tree leaf updates and its
instances carry real Groth16 proofs: each fresh instance takes the next
proof's [A, C, vk_x] and [B] (`Groth16FoldContext`), and the NIFS folds
them with real Gt cross terms.  Set-up captures the step circuit's tape on
one fixed leaf update; `draw_z0(rng)` then makes the seed's Groth16 keys and
pool of proofs, fills the tree's seeded leaves and feeds the zero step's
update and proof; every fold step (`fold`) feeds the next seeded update and
the next proof of the pool.  What was fed is recorded for the reference
(`step_inputs`, `folded_proofs`).  The program is imported inside the
functions, never at import.
"""

from __future__ import annotations

import random

from systems import ivc

CAPTURE_UPDATE = (0, 0)  # the leaf update the public parameters capture


class System(ivc.System):
    def __init__(self, cfg: dict, device, root: str):
        super().__init__(cfg, device, root)
        self.groth16 = cfg["primary"]["groth16"]
        self.r1cs = self.witness = None
        self.vk, self.pool, self.fed = None, [], 0
        self.ctx = None
        self.updates, self.start = [], 0
        self.rng = None
        self.ivc = None

    # -- set-up -------------------------------------------------------------
    def _circuit(self, side: dict, curve):
        if side["circuit"] != "merkle":
            return super()._circuit(side, curve)
        from mira_tpu_torch.gadgets import merkle
        from mira_tpu_torch.workloads.merkle import MerkleTreeUpdateCircuit

        node = [merkle.T, merkle.RATE, merkle.R_F, merkle.R_P]
        if [merkle.DEPTH, node] != [side["depth"], side["node_hash"]]:
            raise ValueError(f"the program's Merkle tree is depth {merkle.DEPTH}, node hash "
                             f"{node}; the configuration states {side['depth']}, "
                             f"{side['node_hash']}")
        sc = MerkleTreeUpdateCircuit(curve.scalar_modulus, side["batch_size"])
        self._update(sc, [CAPTURE_UPDATE] * side["batch_size"])
        return sc

    def _side(self, name: str, circuit, key):
        g = self.cfg[name].get("groth16")
        if g is None:
            return super()._side(name, circuit, key)
        from mira_tpu_torch.ivc.public_params import CircuitSide

        return CircuitSide(circuit, key, self.cfg["k"], num_g1=g["num_g1"], num_g2=g["num_g2"],
                           gt_degree=g["gt_degree"], gt_cross_terms=g["gt_cross_terms"])

    def setup(self):
        from mira_tpu_torch.snark.groth16 import benchmark_r1cs

        super().setup()
        self.circuits[0].pop_front_proof_batch()  # the capture's update
        self.r1cs, self.witness = benchmark_r1cs(self.groth16["num_constraints"])

    def draw_z0(self, rng: random.Random) -> dict:
        """The seed's Groth16 keys and pool of proofs, the seeded leaves,
        then the zero step's update and proof; z0 is the tree's root."""
        from mira_tpu_torch.snark.groth16 import Groth16FoldContext, prove, setup

        g = self.groth16
        proving = random.Random(rng.getrandbits(64))
        pk = setup(self.r1cs, proving)
        public = list(self.witness[1:self.r1cs.num_public + 1])
        self.vk = pk.vk
        self.pool = [(prove(pk, self.r1cs, self.witness, proving), public)
                     for _ in range(g["pool"])]
        ctx = Groth16FoldContext(pk.vk, g["batch"])
        shapes = [ctx.num_g1, ctx.num_g2, ctx.gt_degree, ctx.num_gt_cross_terms]
        if shapes != [g["num_g1"], g["num_g2"], g["gt_degree"], g["gt_cross_terms"]]:
            raise ValueError(f"the program's Groth16 instances carry {shapes}; the "
                             f"configuration states {g}")
        self.ctx = self.pp.primary.S.groth16_ctx = ctx
        self.rng = random.Random(rng.getrandbits(64))
        sc = self.circuits[0]
        for _ in range(self.cfg["primary"]["seeded_leaves"]):
            self._update(sc, [self._draw_update(sc)])
            sc.pop_front_proof_batch()
        self.start = len(self.updates)
        z0 = [sc.tree.root()]
        self._feed()
        return {"primary": z0, "secondary": [rng.randrange(self.moduli()[1])]}

    # -- what each step is fed --------------------------------------------------
    def _draw_update(self, sc):
        from mira_tpu_torch.gadgets.merkle import INDEX_LIMIT

        return self.rng.randrange(INDEX_LIMIT), self.rng.randrange(sc.modulus)

    def _update(self, sc, batch):
        sc.update_leaves(batch)
        self.updates += [list(u) for u in batch]

    def _feed(self):
        """The next step's leaf updates and proofs."""
        sc = self.circuits[0]
        self._update(sc, [self._draw_update(sc) for _ in range(sc.batch_size)])
        batch = [self.pool[(self.fed + i) % len(self.pool)] for i in range(self.ctx.batch)]
        self.ctx.push_proofs(batch)
        self.fed += len(batch)

    # -- the timed path ---------------------------------------------------------
    def new_ivc(self, z0: dict):
        self.ivc = super().new_ivc(z0)
        return self.ivc

    def fold(self, ivc):
        self.circuits[0].pop_front_proof_batch()
        self._feed()
        ivc.fold_step()

    # -- what the reference reads -------------------------------------------------
    def step_inputs(self, ivc) -> dict:
        """Every leaf update applied to the tree, in order; the first `start`
        ones precede z0."""
        if ivc is not self.ivc:
            raise ValueError("inputs are kept for the system's own IVC only")
        return {"updates": self.updates, "start": self.start}

    def folded_proofs(self):
        """(verifying key, the distinct (proof, public inputs) fed)."""
        return self.vk, self.pool[:min(self.fed, len(self.pool))]
