"""Carry values between mira_tpu and the port.

mira_tpu keeps a field element as sixteen 16-bit limbs in a (..., 16) uint32
array; the port keeps eight 32-bit words in a (..., 8) int32 tensor.  Both
hold the same Montgomery integer (R = 2^256), so conversion is a byte-level
repacking.  The accumulator converters take mira_tpu's relaxed instance,
witness and trace objects (whose witness arrays are numpy-convertible) and
build the port's.
"""

from __future__ import annotations

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


# -- instances (host values: copied field by field) ----------------------------
def _copy_fields(src, cls):
    import dataclasses

    return cls(**{f.name: getattr(src, f.name) for f in dataclasses.fields(cls)})


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


# -- host reference ---------------------------------------------------------
def msm_reference(scalars: torch.Tensor, points, curve):
    """sum_i s_i * P_i by mira_tpu's C++ Pippenger (native/msm.cpp), from
    port tensors: plain scalar words and (X, Y, Z) Montgomery words.
    Returns an AffinePoint."""
    from mira_tpu.curves.host import AffinePoint
    from mira_tpu.fields.host import field
    from mira_tpu.ops.native_msm import msm_native_raw

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
