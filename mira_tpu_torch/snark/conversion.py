"""External Groth16 proof/vk ingestion (snarkjs JSON interchange format);
port of mira_tpu/snark/conversion.py, bound to the port's snark/groth16.py.

Role parity with the reference's conversion layers
(reference examples/groth16/conversion.rs, examples/zkml/conversion.rs),
which convert arkworks-generated proofs into the folding stack's own curve
types.  The TPU-native build speaks the *snarkjs* JSON dialect instead —
the de-facto interchange format of the circom/snarkjs ecosystem over BN254
("bn128"), so externally generated proofs can be folded without this repo's
prover:

  proof.json:  {"pi_a": [x, y, "1"], "pi_b": [[xc0, xc1], [yc0, yc1],
                ["1","0"]], "pi_c": [...], "protocol": "groth16",
                "curve": "bn128"}
  verification_key.json: {"vk_alpha_1", "vk_beta_2", "vk_gamma_2",
                "vk_delta_2", "IC": [...], "nPublic", ...}
  public.json: ["7", "12", ...]

All coordinates are decimal strings; G2 elements are [c0, c1] pairs
(ffjavascript convention).  Ingestion validates every point: on-curve for
G1 (cofactor 1 => subgroup-free), on-twist + r-torsion for G2.
"""

from __future__ import annotations

import json
from typing import List, Tuple

from ..curves.host import BN254_G1, AffinePoint, Fq2, G2Point
from ..fields.host import field
from ..fields.params import BN254_FQ, BN254_FR

from .groth16 import Proof, VerifyingKey

FQ = field(BN254_FQ)

# twist: y^2 = x^3 + 3/(9+u) over Fq2
_B2_RE = 19485874751759354771024239261021720505790618469301721065564631296452457478373
_B2_IM = 266929791119991161246907387137283842545076965332900288569378510910307636690


def _g1_to_json(p: AffinePoint) -> List[str]:
    if p.is_inf:
        return ["0", "1", "0"]
    return [str(p.x.v), str(p.y.v), "1"]


def _g1_from_json(v: List) -> AffinePoint:
    x, y = int(v[0]), int(v[1])
    z = int(v[2]) if len(v) > 2 else 1
    if z == 0:
        return AffinePoint.identity(BN254_G1)
    if z != 1:  # projective normalize
        zi = pow(z, -1, BN254_FQ)
        x, y = x * zi % BN254_FQ, y * zi % BN254_FQ
    pt = AffinePoint(BN254_G1, FQ(x), FQ(y))
    if not pt.is_on_curve():
        raise ValueError("G1 point not on curve")
    return pt


def _g2_to_json(p: G2Point) -> List[List[str]]:
    if p.is_inf:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    return [
        [str(p.x.c0.v), str(p.x.c1.v)],
        [str(p.y.c0.v), str(p.y.c1.v)],
        ["1", "0"],
    ]


def _g2_on_twist(x: Fq2, y: Fq2) -> bool:
    b2 = Fq2(FQ(_B2_RE), FQ(_B2_IM))
    return y.square() == x.square().mul(x).add(b2)


def _g2_from_json(v: List, check_subgroup: bool = True) -> G2Point:
    (xc0, xc1), (yc0, yc1) = v[0], v[1]
    if len(v) > 2 and int(v[2][0]) == 0 and int(v[2][1]) == 0:
        return G2Point.identity(FQ)
    x = Fq2(FQ(int(xc0)), FQ(int(xc1)))
    y = Fq2(FQ(int(yc0)), FQ(int(yc1)))
    if not _g2_on_twist(x, y):
        raise ValueError("G2 point not on twist curve")
    pt = G2Point(x, y)
    if check_subgroup and not pt.scalar_mul(BN254_FR).is_inf:
        raise ValueError("G2 point not in the r-torsion subgroup")
    return pt


# -- proof ------------------------------------------------------------------


def proof_to_json(proof: Proof) -> dict:
    return {
        "pi_a": _g1_to_json(proof.a),
        "pi_b": _g2_to_json(proof.b),
        "pi_c": _g1_to_json(proof.c),
        "protocol": "groth16",
        "curve": "bn128",
    }


def proof_from_json(obj: dict) -> Proof:
    if obj.get("protocol", "groth16") != "groth16":
        raise ValueError(f"unsupported protocol {obj.get('protocol')!r}")
    if obj.get("curve", "bn128") not in ("bn128", "bn254"):
        raise ValueError(f"unsupported curve {obj.get('curve')!r}")
    return Proof(
        a=_g1_from_json(obj["pi_a"]),
        b=_g2_from_json(obj["pi_b"]),
        c=_g1_from_json(obj["pi_c"]),
    )


# -- verifying key ----------------------------------------------------------


def vk_to_json(vk: VerifyingKey) -> dict:
    return {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": len(vk.gamma_abc_g1) - 1,
        "vk_alpha_1": _g1_to_json(vk.alpha_g1),
        "vk_beta_2": _g2_to_json(vk.beta_g2),
        "vk_gamma_2": _g2_to_json(vk.gamma_g2),
        "vk_delta_2": _g2_to_json(vk.delta_g2),
        "IC": [_g1_to_json(p) for p in vk.gamma_abc_g1],
    }


def vk_from_json(obj: dict) -> VerifyingKey:
    vk = VerifyingKey(
        alpha_g1=_g1_from_json(obj["vk_alpha_1"]),
        beta_g2=_g2_from_json(obj["vk_beta_2"]),
        gamma_g2=_g2_from_json(obj["vk_gamma_2"]),
        delta_g2=_g2_from_json(obj["vk_delta_2"]),
        gamma_abc_g1=[_g1_from_json(p) for p in obj["IC"]],
    )
    n_public = obj.get("nPublic")
    if n_public is not None and len(vk.gamma_abc_g1) != n_public + 1:
        raise ValueError("IC length inconsistent with nPublic")
    return vk


def public_inputs_from_json(obj: List) -> List[int]:
    return [int(v) % BN254_FR for v in obj]


def public_inputs_to_json(vals: List[int]) -> List[str]:
    return [str(v % BN254_FR) for v in vals]


# -- bundle files -----------------------------------------------------------


def save_proof_bundle(path: str, vk: VerifyingKey,
                      items: List[Tuple[Proof, List[int]]]) -> None:
    """One JSON file: verification key + N (proof, public inputs) pairs."""
    obj = {
        "verification_key": vk_to_json(vk),
        "proofs": [
            {
                "proof": proof_to_json(pf),
                "public": public_inputs_to_json(pub),
            }
            for pf, pub in items
        ],
    }
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def load_proof_bundle(path: str):
    """-> (VerifyingKey, [(Proof, public_inputs)]); every point validated."""
    with open(path) as f:
        obj = json.load(f)
    vk = vk_from_json(obj["verification_key"])
    items = [
        (proof_from_json(e["proof"]), public_inputs_from_json(e["public"]))
        for e in obj["proofs"]
    ]
    return vk, items
