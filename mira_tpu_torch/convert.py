"""Carry values between mira_tpu and the port.

The two packages share no class: the port keeps its own copies of the host
field, curve and gadget modules, and an element or point of one package is a
stranger to the other (`isinstance`, `==`).  So values cross on python ints,
numpy arrays and tagged tuples only.  `to_plain` duck-types what it is handed
(either package's objects) into such plain data; `from_plain` rebuilds the
port's objects from it.  This module imports nothing of mira_tpu; the way
back (plain data -> mira_tpu's objects) lives with the tests.

mira_tpu keeps a field element as sixteen 16-bit limbs in a (..., 16) uint32
array; the port keeps eight 32-bit words in a (..., 8) int32 tensor.  Both
hold the same Montgomery integer (R = 2^256), so conversion is a byte-level
repacking.  The accumulator converters take mira_tpu's relaxed instance,
witness and trace objects (whose witness arrays are numpy-convertible) and
build the port's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fields.limbs import NUM_LIMBS, NUM_WORDS


def limbs16_to_words(arr, device="cpu") -> torch.Tensor:
    """mira_tpu (..., 16) uint32 limb array -> (..., 8) int32 word tensor."""
    a = np.ascontiguousarray(np.asarray(arr), dtype=np.uint32).astype("<u2")
    w = np.ascontiguousarray(a).view("<i4").reshape(*a.shape[:-1], NUM_WORDS)
    return torch.from_numpy(w.copy()).to(device)


def words_to_limbs16(t: torch.Tensor) -> np.ndarray:
    """(..., 8) int32 word tensor -> mira_tpu (..., 16) uint32 limb array."""
    w = np.ascontiguousarray(t.detach().cpu().numpy(), dtype="<i4")
    return w.view("<u2").astype(np.uint32).reshape(*w.shape[:-1], NUM_LIMBS)


# -- host values: either package's objects <-> plain data ------------------------
def to_plain(v):
    """A host value of either package as plain data: ints, strings and bytes
    stay; a field element becomes ("F", p, v), a G1 point ("G1", curve name,
    x, y, infinity), an Fq2 ("Fq2", p, c0, c1), a G2 point ("G2", p, (x0, x1),
    (y0, y1), infinity), a Gt tuple ("Gt", p, [12 ints]), curve parameters
    ("curve", name), a univariate polynomial ("poly", p, coefficients); lists
    and tuples become lists, dicts keep their keys, and a dataclass becomes
    the dict of its fields.  Equal values of the two
    packages give equal plain data."""
    if v is None or isinstance(v, (bool, int, str, bytes)):
        return v
    if isinstance(v, (list, tuple)):
        return [to_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: to_plain(x) for k, x in v.items()}
    if hasattr(v, "P") and hasattr(v, "v"):
        return ("F", int(v.P), int(v.v))
    if hasattr(v, "base_modulus") and hasattr(v, "name"):
        return ("curve", v.name)
    if hasattr(v, "curve") and hasattr(v, "is_identity"):
        if v.is_identity():
            return ("G1", v.curve.name, 0, 0, True)
        return ("G1", v.curve.name, int(v.x.v), int(v.y.v), False)
    if hasattr(v, "c0") and hasattr(v, "c1"):
        return ("Fq2", int(v.c0.P), int(v.c0.v), int(v.c1.v))
    if hasattr(v, "elements") and hasattr(v, "F"):
        return ("Gt", int(v.F.P), [int(e.v) for e in v.elements])
    if hasattr(v, "is_inf") and hasattr(v.x, "c0"):
        p = int(v.x.c0.P)
        if v.is_inf:
            return ("G2", p, (0, 0), (0, 0), True)
        return ("G2", p, (int(v.x.c0.v), int(v.x.c1.v)),
                (int(v.y.c0.v), int(v.y.c1.v)), False)
    if hasattr(v, "coeffs") and hasattr(v, "modulus"):
        return ("poly", int(v.modulus), [int(c) for c in v.coeffs])
    if dataclasses.is_dataclass(v):
        return {f.name: to_plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    raise TypeError(f"no plain form for {type(v).__name__}")


def relaxed_trace_plain(t) -> dict:
    """A relaxed trace of either package as plain data: its instance by
    `to_plain`, its witness rounds and error vector as lists of ints."""
    lf = t.W.lf
    return {"U": to_plain(t.U), "W": [lf.decode(w) for w in t.W.W],
            "E": lf.decode(t.W.E)}


def from_plain(d):
    """The port's object for plain data made by `to_plain` (a dataclass's
    dict stays a dict: its caller knows the class)."""
    from .curves.host import BN254_G1, GRUMPKIN, AffinePoint, Fq2, G2Point, Tuple12
    from .fields.host import field

    if isinstance(d, list):
        return [from_plain(x) for x in d]
    if isinstance(d, dict):
        return {k: from_plain(x) for k, x in d.items()}
    if not isinstance(d, tuple):
        return d
    tag = d[0]
    if tag == "F":
        return field(d[1])(d[2])
    if tag == "curve":
        return {"bn254": BN254_G1, "grumpkin": GRUMPKIN}[d[1]]
    if tag == "G1":
        curve = from_plain(("curve", d[1]))
        return AffinePoint(curve, d[2], d[3], d[4])
    if tag == "Fq2":
        F = field(d[1])
        return Fq2(F(d[2]), F(d[3]))
    if tag == "Gt":
        F = field(d[1])
        return Tuple12([F(e) for e in d[2]], F)
    if tag == "G2":
        F = field(d[1])
        return G2Point(Fq2(F(d[2][0]), F(d[2][1])), Fq2(F(d[3][0]), F(d[3][1])),
                       d[4])
    if tag == "poly":
        from .polynomial.univariate import UnivariatePoly

        return UnivariatePoly(d[2], d[1])
    raise ValueError(f"unknown plain tag {tag!r}")


def to_port(v):
    """The port's own object for a host value of either package."""
    return from_plain(to_plain(v))


# -- instances (host values: carried field by field) ----------------------------
def _copy_fields(src, cls):
    return cls(**{f.name: to_port(getattr(src, f.name))
                  for f in dataclasses.fields(cls)})


def relaxed_instance_from_mira(U):
    from .plonk.structure import RelaxedPlonkInstance

    return _copy_fields(U, RelaxedPlonkInstance)


def relaxed_witness_from_mira(W, device="cpu"):
    from .fields.limbs import limb_field
    from .plonk.structure import RelaxedPlonkWitness

    lf = limb_field(W.lf.modulus)
    return RelaxedPlonkWitness(lf, [limbs16_to_words(x, device) for x in W.W],
                               limbs16_to_words(W.E, device))


def relaxed_trace_from_mira(t, device="cpu"):
    from .plonk.structure import RelaxedPlonkTrace

    return RelaxedPlonkTrace(relaxed_instance_from_mira(t.U),
                             relaxed_witness_from_mira(t.W, device))


def accumulator_from_mira(acc, device="cpu"):
    """mira_tpu's ProtoGalaxy accumulator (betas, e, relaxed trace) -> the
    port's, its witness on `device`."""
    from .nifs.protogalaxy import Accumulator

    return Accumulator([int(b) for b in acc.betas],
                       relaxed_trace_from_mira(acc.trace, device), int(acc.e))


def proof_from_mira(proof):
    """mira_tpu's ProtoGalaxyProof (two coefficient lists) -> the port's."""
    from .nifs.protogalaxy import ProtoGalaxyProof

    return ProtoGalaxyProof(to_port(proof.poly_F), to_port(proof.poly_K))


# -- host reference ---------------------------------------------------------
def msm_reference(scalars: torch.Tensor, points, curve):
    """sum_i s_i * P_i by the host C++ Pippenger (native/msm.cpp), from
    port tensors: plain scalar words and (X, Y, Z) Montgomery words.
    Returns an AffinePoint."""
    from .curves.host import AffinePoint
    from .fields.host import field
    from .ops.native_msm import msm_native_raw

    from .fields.limbs import limb_field

    lf = limb_field(curve.base_modulus)
    X, Y, Z = points
    inf = lf.is_zero(Z).cpu().numpy()

    def u64(t):
        a = np.ascontiguousarray(t.detach().cpu().numpy(), dtype="<i4")
        return a.view("<u8").reshape(-1, 4).copy()

    xs = u64(lf.to_plain(X))
    ys = u64(lf.to_plain(Y))
    xs[inf] = 0
    ys[inf] = 0
    out = msm_native_raw(u64(scalars), xs, ys, curve.base_modulus)
    Xo, Yo, Zo = (sum(int(out[r, k]) << (64 * k) for k in range(4))
                  for r in range(3))
    if Zo == 0:
        return AffinePoint.identity(curve)
    p = curve.base_modulus
    zinv = pow(Zo, -1, p)
    F = field(p)
    return AffinePoint(curve, F(Xo * zinv * zinv % p), F(Yo * zinv ** 3 % p))
