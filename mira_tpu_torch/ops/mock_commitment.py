"""Homomorphic mock commitment key for CPU runs (port of
mira_tpu/ops/mock_commitment.py).

commit(v) = G * (<weights, v> mod r): linear in v, so every folding identity
(W' = W1 + r*W2, E' = E + sum r^k T_k) holds exactly as with a Pedersen key,
at the cost of one inner product and one scalar multiplication instead of
an MSM.  NOT binding; for tests and CPU runs where MSM time would dominate.
The weights are mira_tpu's (the same label gives the same commitments).
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np
import torch

from ..curves.host import AffinePoint, CurveParams

from ..fields.limbs import limb_field


class MockCommitmentKey:
    def __init__(self, curve: CurveParams, k: int, label: bytes = b"mock",
                 device="cuda"):
        self.curve = curve
        self.device = torch.device(device)
        self.size = 1 << k
        r = curve.scalar_modulus
        seed = hashlib.shake_256(b"mira-mock-ck" + label).digest(16 * self.size)
        self.weights = [
            int.from_bytes(seed[16 * i : 16 * (i + 1)], "little") % r
            for i in range(self.size)
        ]
        self._w64 = None
        self._gen = AffinePoint.generator(curve)

    def __len__(self):
        return self.size

    def commit_ints(self, values: List[int]) -> AffinePoint:
        if len(values) > self.size:
            raise ValueError("input too long")
        r = self.curve.scalar_modulus
        acc = sum(w * v for w, v in zip(self.weights, values))
        return self._gen.scalar_mul(acc % r)

    def commit_device(self, witness_mont: torch.Tensor, mesh=None) -> AffinePoint:
        """<weights, witness> on the native 4x64 Montgomery inner product
        (mont_mul(w_plain, v_mont) = w*v, so no decode pass); the port's
        (n, 8) int32 words are the byte image of its (n, 4) uint64 limbs.
        The mock key has no MSM to shard: with a mesh every rank computes
        the same inner product."""
        from ..fields.native64 import available, inner_product_mont, ints_to_64

        n = witness_mont.shape[0]
        if n > self.size:
            raise ValueError("input too long")
        r = self.curve.scalar_modulus
        if not available():
            return self.commit_ints(limb_field(r).decode(witness_mont))
        if self._w64 is None:
            self._w64 = ints_to_64(self.weights)
        words = np.ascontiguousarray(witness_mont.detach().cpu().numpy(), dtype="<i4")
        acc = inner_product_mont(r, self._w64, words.view("<u8").reshape(n, 4))
        return self._gen.scalar_mul(acc)

    def commit_device_many(self, vectors, mesh=None, defer=False):
        pts = [self.commit_device(v) for v in vectors]
        return (lambda: pts) if defer else pts

    def commit_delta(self, dw) -> AffinePoint:
        """The mock key has no points to gather: commit the scattered full
        witness."""
        return self.commit_device(dw.encode_mont(dw.lf))
