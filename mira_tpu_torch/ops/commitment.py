"""Pedersen vector commitment key (port of mira_tpu/ops/commitment.py).

The key is array-backed: (n, 2, 16) uint32 raw (non-Montgomery) 16-bit limb
affine coordinates, the format of mira_tpu's `.cache/ck/<curve>/<label>/
{k}-svdw.npy` files, so both packages commit with one key.  Keys are made by
the native hash-to-curve generator (mira_tpu/ops/native_keygen.py) and
checked on load.  Every commitment is one bucket MSM (ops/cuda_msm.py) on
the key's device; there are no fixed-base multiples tables, which matches
mira_tpu at MIRA_MSM_FB=0.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np
import torch

from mira_tpu.curves.host import AffinePoint, CurveParams, LazyAffinePoint
from mira_tpu.fields.host import field

from ..curves.torch_curve import jacobian_ops
from ..fields.limbs import limb_field
from ..utils.tracing import span
from .cuda_msm import msm
from .msm import encode_scalars

HTC = "svdw"  # hash-to-curve of the key files (mira_tpu's default)


class LazyPoint(LazyAffinePoint):
    """A LazyAffinePoint whose decode runs once.  mira_tpu's `_force` clears
    the thunk before the coordinates are set, so a decode that fails leaves
    a point whose attribute lookup recurses without end; here the failure
    propagates once and later reads raise instead."""

    __slots__ = ()

    def _force(self):
        thunk = self._thunk
        if thunk is None:
            return
        self._thunk = None
        pt = thunk()
        AffinePoint.x.__set__(self, pt.x)
        AffinePoint.y.__set__(self, pt.y)
        AffinePoint.is_inf.__set__(self, pt.is_inf)

    def __getattr__(self, name):
        if name in ("x", "y", "is_inf"):
            if self._thunk is None:
                raise RuntimeError("lazy commitment has no value: its decode "
                                   "failed")
            self._force()
            return object.__getattribute__(self, name)
        raise AttributeError(name)


def _validate_limbs_on_curve(curve: CurveParams, limbs: np.ndarray):
    """Raise if any (x, y) pair is off-curve (native batch check when the
    library loads, host ints otherwise)."""
    from mira_tpu.ops.native_keygen import limbs16_to_u64x4, on_curve_check_native

    bad = on_curve_check_native(limbs16_to_u64x4(limbs), curve)
    if bad is not None:
        if bad:
            raise ValueError(f"corrupted commitment key cache: {bad} points off-curve")
        return
    F = field(curve.base_modulus)
    for x, y in zip(_limbs_to_ints(limbs[:, 0]), _limbs_to_ints(limbs[:, 1])):
        if not AffinePoint(curve, F(x), F(y)).is_on_curve():
            raise ValueError("corrupted commitment key cache")


def _limbs_to_ints(arr) -> list:
    """(n, 16) uint32 16-bit limbs -> ints."""
    buf = np.ascontiguousarray(arr, dtype=np.uint32).astype("<u2").tobytes()
    return [int.from_bytes(buf[32 * i : 32 * (i + 1)], "little")
            for i in range(len(buf) // 32)]


def _ints_to_limbs(vals) -> np.ndarray:
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), 16).astype(np.uint32)


class CommitmentKey:
    def __init__(self, curve: CurveParams, limbs: np.ndarray, device="cpu"):
        """limbs: (n, 2, 16) uint32 raw (non-Montgomery) affine coordinates."""
        self.curve = curve
        self.device = torch.device(device)
        self._limbs = np.ascontiguousarray(limbs, dtype=np.uint32)
        self._enc_cache = None
        self._delta_cache = {}  # tape uid -> (C_template, gathered points)
        self._aux_dir: Optional[str] = None  # ctmpl-*.npy disk home

    def __len__(self):
        return self._limbs.shape[0]

    def _encode_rows(self, sub: np.ndarray):
        """(m, 2, 16) raw limbs -> (X, Y, Z) Montgomery words on the device."""
        lfq = limb_field(self.curve.base_modulus)
        X = lfq.encode_raw16(sub[:, 0], self.device)
        Y = lfq.encode_raw16(sub[:, 1], self.device)
        Z = lfq.one((sub.shape[0],), self.device).contiguous()
        return (X, Y, Z)

    def _enc_slice(self, n: int):
        """Montgomery encoding of the FIRST n key points, growing a cached
        prefix on demand (points past the widest MSM are never encoded)."""
        cached_n = self._enc_cache[0].shape[0] if self._enc_cache else 0
        if n > cached_n:
            self._enc_cache = self._encode_rows(self._limbs[:n])
        if n == self._enc_cache[0].shape[0]:
            return self._enc_cache
        return tuple(c[:n] for c in self._enc_cache)

    @classmethod
    def from_points(cls, curve: CurveParams, points: List[AffinePoint],
                    device="cpu"):
        limbs = np.stack([_ints_to_limbs([p.x.v for p in points]),
                          _ints_to_limbs([p.y.v for p in points])], axis=1)
        return cls(curve, limbs, device)

    @classmethod
    def setup(cls, curve: CurveParams, k: int, label: bytes = b"",
              device="cpu") -> "CommitmentKey":
        from mira_tpu.ops.native_keygen import keygen_native, u64x4_to_limbs16

        n = 1 << k
        xy = keygen_native(curve, n, label)
        if xy is not None:
            return cls(curve, u64x4_to_limbs16(xy), device)
        from mira_tpu.curves.svdw import hash_to_curve

        htc = hash_to_curve(curve, "from_uniform_bytes")
        stream = hashlib.shake_256(label).digest(32 * n)
        points = [htc(stream[32 * i : 32 * (i + 1)]) for i in range(n)]
        return cls.from_points(curve, points, device)

    @classmethod
    def load_or_setup_cache(cls, curve: CurveParams, k: int, label: str,
                            cache_dir: str = ".cache/ck",
                            device="cpu") -> "CommitmentKey":
        aux_dir = os.path.join(os.path.dirname(os.path.normpath(cache_dir)),
                               "fbtab", curve.name, label)

        def _path(kk):
            return os.path.join(cache_dir, curve.name, label, f"{kk}-{HTC}.npy")

        path = _path(k)
        arr = None
        if os.path.exists(path):
            arr = np.load(path)
        else:
            # the generator stream is prefix-stable: a key of any k' > k with
            # the same label holds this key as its first 2^k rows
            for k2 in range(k + 1, 33):
                if os.path.exists(_path(k2)):
                    arr = np.array(np.load(_path(k2), mmap_mode="r")[: 1 << k])
                    break
        if arr is not None:
            _validate_limbs_on_curve(curve, arr)
            key = cls(curve, arr, device)
        else:
            key = cls.setup(curve, k, label.encode(), device)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, key._limbs)
        key._aux_dir = aux_dir
        return key

    # -- commitment ----------------------------------------------------------
    def _decode(self, out) -> AffinePoint:
        ops = jacobian_ops(self.curve.name)
        return ops.decode_points(tuple(c[None] for c in out))[0]

    def commit_ints(self, values: List[int]) -> AffinePoint:
        """Commit to raw scalar ints (host API)."""
        if len(values) > len(self):
            raise ValueError(f"input too long: {len(values)} > key size {len(self)}")
        sc = encode_scalars(values, self.curve.scalar_modulus, self.device)
        return self._commit_plain_limbs(sc)

    def commit_device(self, witness_mont) -> AffinePoint:
        """Commit to a Montgomery word vector on the key's device."""
        n = witness_mont.shape[0]
        if n > len(self):
            raise ValueError(f"input too long: {n} > key size {len(self)}")
        lf = limb_field(self.curve.scalar_modulus)
        return self._commit_plain_limbs(lf.to_plain(witness_mont))

    def commit_device_many(self, vectors, defer=False):
        """Commit several Montgomery vectors, decoding all results after the
        last MSM is queued.  With defer=True, returns a zero-arg callable
        that decodes, so the caller can do host work meanwhile."""
        lf = limb_field(self.curve.scalar_modulus)
        outs = []
        with span("ct_msm_dispatch"):
            for v in vectors:
                if v.shape[0] > len(self):
                    raise ValueError(
                        f"input too long: {v.shape[0]} > key size {len(self)}")
                outs.append(self._msm_device(lf.to_plain(v)))

        def _decode():
            with span("ct_decode"):
                return [self._decode(out) for out in outs]

        return _decode if defer else _decode()

    def _msm_device(self, scalars):
        """One MSM over plain-word scalars; returns the Jacobian word triple
        without decoding (asynchronous on the card)."""
        return msm(scalars, self._enc_slice(scalars.shape[0]), self.curve)

    def _commit_plain_limbs(self, scalars) -> AffinePoint:
        return self._decode(self._msm_device(scalars))

    def commit_delta(self, dw) -> AffinePoint:
        """Incremental commitment of a tape-replayed DeviceWitness
        (table/packed.py): the witness differs from its captured template
        only at the tape's write positions, so

            C(W) = C(template) + MSM(value - template_value @ positions),

        an MSM over the write positions instead of num_cols * 2^k points.
        The template commitment persists as ctmpl-<template hash>.npy beside
        the key cache; the sum is returned as a LazyPoint whose decode waits
        for the first coordinate read."""
        lf = limb_field(self.curve.scalar_modulus)
        token = dw.cache_token.uid
        entry = self._delta_cache.get(token)
        if entry is None:
            tag = hashlib.sha1(dw.cache_token.packed_template.tobytes()).hexdigest()[:16]
            C_t = self._load_template_commit(f"ctmpl-{tag}.npy")
            if C_t is None:
                C_t = self.commit_device(dw.template_mont)
                self._save_template_commit(f"ctmpl-{tag}.npy", C_t)
            entry = (C_t, self._encode_rows(self._limbs[dw.positions_np]))
            self._delta_cache[token] = entry
        C_t, gpts = entry
        with span("delta_scalars"):
            delta = lf.to_plain(dw.delta_mont())
        with span("delta_msm"):
            out = msm(delta, gpts, self.curve)

        def _materialize():
            with span("delta_decode"):
                return C_t.add(self._decode(out))

        return LazyPoint(self.curve, _materialize)

    # -- template commitment persistence -------------------------------------
    def _load_template_commit(self, name: str) -> Optional[AffinePoint]:
        if self._aux_dir is None:
            return None
        path = os.path.join(self._aux_dir, name)
        if not os.path.exists(path):
            return None
        xv, yv, inf = _limbs_to_ints(np.load(path))
        if inf:
            return AffinePoint.identity(self.curve)
        F = field(self.curve.base_modulus)
        pt = AffinePoint(self.curve, F(xv), F(yv))
        if not pt.is_on_curve():
            raise ValueError(f"corrupted template commitment {path}")
        return pt

    def _save_template_commit(self, name: str, pt: AffinePoint):
        if self._aux_dir is None:
            return
        os.makedirs(self._aux_dir, exist_ok=True)
        path = os.path.join(self._aux_dir, name)
        vals = [0, 0, 1] if pt.is_inf else [pt.x.v, pt.y.v, 0]
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.save(f, _ints_to_limbs(vals))
        os.replace(tmp, path)
