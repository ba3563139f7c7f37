"""The system under test for configurations of `"system": "ivc"`: the
program's two-curve IVC, built from the configuration's sizes.

`System(cfg, device, root)` holds the keys and public parameters; `setup()`
makes them: Pedersen keys through the program's key cache, from the files
that the benchmark wrote into the checkout's .cache/ck (reference/keys.py).
`new_ivc(z0)` runs a zero step, `fold(ivc)` one fold step, `verify(ivc)` the
program's strict decider.  The program is imported inside the functions,
never at import.
"""

from __future__ import annotations

import os

from harness.cell import ck_k


class System:
    def __init__(self, cfg: dict, device, root: str):
        self.cfg = cfg
        self.device = device
        self.root = root
        self.pp = None
        self.circuits = None

    # -- set-up -------------------------------------------------------------
    def _circuit(self, side: dict, curve):
        if side["circuit"] == "poseidon":
            from mira_tpu_torch.workloads.poseidon import (SC_R_F, SC_R_P, SC_RATE, SC_T,
                                                           PoseidonStepCircuit)

            if [SC_T, SC_RATE, SC_R_F, SC_R_P] != side["poseidon"]:
                raise ValueError(f"the program's Poseidon step circuit is "
                                 f"{[SC_T, SC_RATE, SC_R_F, SC_R_P]}, the configuration "
                                 f"states {side['poseidon']}")
            return PoseidonStepCircuit(curve.scalar_modulus, side["repeat_count"])
        if side["circuit"] == "trivial":
            from mira_tpu_torch.ivc.step_circuit import TrivialCircuit

            return TrivialCircuit(arity=side["arity"])
        raise ValueError(f"unknown step circuit {side['circuit']!r}")

    def _key(self, name: str, curve):
        side, k = self.cfg[name], ck_k(self.cfg, name)
        if side["key"] == "mock":
            from mira_tpu_torch.ops.mock_commitment import MockCommitmentKey

            return MockCommitmentKey(curve, k, side["key_label"].encode(), self.device)
        from mira_tpu_torch.ops.commitment import CommitmentKey

        return CommitmentKey.load_or_setup_cache(
            curve, k, side["key_label"], cache_dir=os.path.join(self.root, ".cache", "ck"),
            device=self.device)

    def _side(self, name: str, circuit, key):
        """The program's construction input of one side."""
        from mira_tpu_torch.ivc.public_params import CircuitSide

        return CircuitSide(circuit, key, self.cfg["k"])

    def setup(self):
        from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN
        from mira_tpu_torch.ivc.public_params import PublicParams

        curves = {"bn254": BN254_G1, "grumpkin": GRUMPKIN}
        names = ("primary", "secondary")
        cs = [curves[self.cfg[n]["curve"]] for n in names]
        self.circuits = [self._circuit(self.cfg[n], c) for n, c in zip(names, cs)]
        keys = [self._key(n, c) for n, c in zip(names, cs)]
        self.pp = PublicParams(*(self._side(n, sc, key)
                                 for n, sc, key in zip(names, self.circuits, keys)),
                               cs[0], cs[1])
        ro = self.pp.primary.params.ro_spec
        stated = self.cfg["ro"]
        if [ro.t, ro.rate, ro.r_f, ro.r_p] != stated:
            raise ValueError(f"the program's random oracle is {[ro.t, ro.rate, ro.r_f, ro.r_p]}, "
                             f"the configuration states {stated}")

    def key_file(self, side: str) -> str:
        """The key file the program read for a side (Pedersen keys)."""
        s = self.cfg[side]
        return os.path.join(self.root, ".cache", "ck", s["curve"], s["key_label"],
                            f"{ck_k(self.cfg, side)}-svdw.npy")

    def moduli(self):
        """The scalar moduli of the two sides' step functions."""
        return (self.pp.primary_curve.scalar_modulus, self.pp.secondary_curve.scalar_modulus)

    def problems(self, folds: int, delta_widths) -> dict:
        """The least time of the profiled units' problems (harness/counts.py):
        `delta_msm_s`, the delta commitments made (an MSM over each one's
        write positions), and `cross_terms_s`, the cross terms of both
        sides in each fold step."""
        from harness import counts

        ct = 0.0
        for side in (self.pp.primary, self.pp.secondary):
            S = side.S
            ct += counts.cross_terms_bound_s(
                S.compressed_gates.homogeneous, 1 << S.k, S.get_degree_for_folding() - 1,
                len(S.selectors) + len(S.fixed_columns))
        return {"delta_msm_s": sum(counts.msm_bound_s(n) for n in delta_widths),
                "cross_terms_s": folds * ct}

    # -- the timed path ---------------------------------------------------------
    def new_ivc(self, z0: dict):
        from mira_tpu_torch.ivc.ivc import IVC

        return IVC(self.pp, self.circuits[0], list(z0["primary"]), self.circuits[1],
                   list(z0["secondary"]))

    @staticmethod
    def fold(ivc):
        ivc.fold_step()

    @staticmethod
    def verify(ivc) -> str:
        """The program's strict decider: "" where it accepts the IVC, its
        reason where it refuses."""
        from mira_tpu_torch.ivc.ivc import VerificationError

        try:
            ivc.verify(strict=True)
        except VerificationError as e:
            return str(e)
        return ""
