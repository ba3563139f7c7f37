"""Pedersen vector commitment key (port of mira_tpu/ops/commitment.py).

The key is array-backed: (n, 2, 16) uint32 raw (non-Montgomery) 16-bit limb
affine coordinates, the format of mira_tpu's `.cache/ck/<curve>/<label>/
{k}-svdw.npy` files, so both packages commit with one key.  Keys are made by
the native hash-to-curve generator (ops/native_keygen.py) and
checked on load.

Which commitment takes which MSM is mira_tpu's default configuration
(MIRA_MSM_FB=1): the per-step delta commitments (`commit_delta`) and the
recurring widths of `commit_device_many` (the cross terms) run the
fixed-base MSM over a multiples table, built for a width on its second
sighting; one-shot full-width commits (`commit_device`, `commit_ints`: the
zero step, templates, the decider) always run a generic-base MSM.  A table
is built only while it takes at most half of the memory free on its device;
a width that does not fit runs the generic-base MSM and counts in
`fb_skipped`.  The generic-base engine is the key's `generic_method`
(ops/msm.py `msm`'s method names; mira_tpu reads it from MIRA_MSM_GENERIC),
by default the bucket MSM, mira_tpu's default on an accelerator.

With a mesh (parallel/mesh.py), `commit_device` and `commit_device_many`
build no table: every commit is a sharded MSM (parallel/msm.py), each rank
summing its block of the points, as mira_tpu's mesh commits do.

Template commitments persist in a directory of the port's own, keyed by
curve, label, hash-to-curve and a digest of the key, never in mira_tpu's
`.cache/fbtab`, and a loaded one off the curve raises.  Multiples tables are
not persisted: the card builds one in milliseconds, while writing one to
disk cost 0.2-1.0 s and reading it back would cost a file read and a
host-to-device copy.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np
import torch

from ..curves.host import AffinePoint, CurveParams, LazyAffinePoint
from ..fields.host import field

from ..curves.torch_curve import jacobian_ops
from ..fields.limbs import ints_to_limbs, limb_field, limbs_to_ints
from ..utils.tracing import fence, span
from .cuda_msm import fixed_table, msm_fixed
from .field_lincomb import to_plain
from .msm import METHODS, encode_scalars, fixed_base_window, msm

HTC = "svdw"  # hash-to-curve of the key files (mira_tpu's default)
DELTA_WINDOW = 5  # table window of the delta commitments (mira_tpu's)
FB_MIN_WIDTH = 256  # narrower MSMs never build a table (as in mira_tpu)


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
    from ..ops.native_keygen import limbs16_to_u64x4, on_curve_check_native

    bad = on_curve_check_native(limbs16_to_u64x4(limbs), curve)
    if bad is not None:
        if bad:
            raise ValueError(f"corrupted commitment key cache: {bad} points off-curve")
        return
    F = field(curve.base_modulus)
    for x, y in zip(limbs_to_ints(limbs[:, 0]), limbs_to_ints(limbs[:, 1])):
        if not AffinePoint(curve, F(x), F(y)).is_on_curve():
            raise ValueError("corrupted commitment key cache")


def _key_rows(curve: CurveParams, label: bytes, start: int, stop: int) -> np.ndarray:
    """Rows [start, stop) of the key of `label` as (n, 2, 16) raw limbs: the
    hash-to-curve images of 32-byte blocks start..stop-1 of the label's
    SHAKE-256 stream, as mira_tpu's keygen makes them (its native library
    where it loads, its Python hash-to-curve otherwise)."""
    import ctypes

    from ..curves.svdw import CURVE_IDS, hash_to_curve, svdw_constants
    from ..ops.native_keygen import (
        _field_pack,
        _int_to_u64x4,
        load,
        u8p,
        u64p,
        u64x4_to_limbs16,
    )

    n = stop - start
    stream = hashlib.shake_256(label).digest(32 * stop)[32 * start :]
    lib = load()
    if lib is None:
        htc = hash_to_curve(curve, "from_uniform_bytes")
        pts = [htc(stream[32 * i : 32 * (i + 1)]) for i in range(n)]
        return np.stack([ints_to_limbs([p.x.v for p in pts]),
                         ints_to_limbs([p.y.v for p in pts])], axis=1)
    p = curve.base_modulus
    fparams, q_bytes, q12_bytes, s = _field_pack(p)
    svdw = np.concatenate([_int_to_u64x4(v)
                           for v in (*svdw_constants(p, 0, curve.b), curve.b)])
    dst = np.frombuffer(f"from_uniform_bytes-{CURVE_IDS[curve.name]}"
                        "_XMD:SHA-256_SVDW_RO_".encode(), dtype=np.uint8).copy()
    buf = np.frombuffer(stream, dtype=np.uint8)
    out = np.empty((n, 2, 4), dtype="<u8")
    fn = lib.mira_keygen_mapped
    fn.argtypes = [u8p, ctypes.c_size_t, u64p, u8p, u8p, ctypes.c_int,
                   u64p, u8p, ctypes.c_size_t, u64p, ctypes.c_int]
    fn.restype = None
    fn(buf.ctypes.data_as(u8p), n, fparams.ctypes.data_as(u64p),
       q_bytes.ctypes.data_as(u8p), q12_bytes.ctypes.data_as(u8p), s,
       svdw.ctypes.data_as(u64p), dst.ctypes.data_as(u8p), len(dst),
       out.ctypes.data_as(u64p), os.cpu_count() or 4)
    return u64x4_to_limbs16(out)


def key_digest(limbs: np.ndarray) -> str:
    """Digest of a key: its length and its first and last 256 rows (the
    rows a regenerated or truncated key would change)."""
    h = hashlib.sha256(len(limbs).to_bytes(8, "little"))
    h.update(np.ascontiguousarray(limbs[:256]).tobytes())
    h.update(np.ascontiguousarray(limbs[-256:]).tobytes())
    return h.hexdigest()[:16]


def _free_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class CommitmentKey:
    def __init__(self, curve: CurveParams, limbs: np.ndarray, device="cuda",
                 generic_method: str = "bucket"):
        """limbs: (n, 2, 16) uint32 raw (non-Montgomery) affine coordinates;
        generic_method: the engine of every generic-base commit (ops/msm.py
        `msm`)."""
        self.curve = curve
        self.device = torch.device(device)
        self.generic_method = generic_method
        self._limbs = np.ascontiguousarray(limbs, dtype=np.uint32)
        self._points: Optional[List[AffinePoint]] = None
        self._enc_cache = None
        self._fb_tables = {}  # padded MSM width -> (window, table)
        self._fb_seen = {}  # padded MSM width -> sightings without a table
        self._delta_cache = {}  # tape uid -> (C_template, table, points)
        self._aux_dir: Optional[str] = None  # derived-artifact disk home
        self.fb_skipped = 0  # tables not built because they did not fit

    @property
    def generic_method(self) -> str:
        return self._generic_method

    @generic_method.setter
    def generic_method(self, method: str):
        if method not in METHODS:
            raise ValueError(f"generic_method {method!r} not in {METHODS}")
        self._generic_method = method

    def __len__(self):
        return self._limbs.shape[0]

    @property
    def points(self) -> List[AffinePoint]:
        """The key's points on the host, made from its limbs on first use
        (the host MSMs of pcs/ipa.py read them)."""
        if self._points is None:
            F = field(self.curve.base_modulus)
            xs = limbs_to_ints(self._limbs[:, 0])
            ys = limbs_to_ints(self._limbs[:, 1])
            self._points = [AffinePoint(self.curve, F(x), F(y))
                            for x, y in zip(xs, ys)]
        return self._points

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
    def setup(cls, curve: CurveParams, k: int, label: bytes = b"",
              device="cuda") -> "CommitmentKey":
        return cls(curve, _key_rows(curve, label, 0, 1 << k), device)

    @classmethod
    def load_or_setup_cache(cls, curve: CurveParams, k: int, label: str,
                            cache_dir: str = ".cache/ck",
                            device="cuda") -> "CommitmentKey":
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
            # ... and a key of any k' < k is this key's prefix: only the
            # rows past it are generated
            k0 = next((kk for kk in range(k - 1, -1, -1)
                       if os.path.exists(_path(kk))), None)
            if k0 is None:
                key = cls.setup(curve, k, label.encode(), device)
            else:
                head = np.load(_path(k0))
                _validate_limbs_on_curve(curve, head)
                tail = _key_rows(curve, label.encode(), 1 << k0, 1 << k)
                key = cls(curve, np.concatenate([head, tail]), device)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, key._limbs)
        key._aux_dir = os.path.join(
            os.path.dirname(os.path.normpath(cache_dir)), "torch_derived",
            curve.name, label, f"{HTC}-{key_digest(key._limbs)}")
        return key

    # -- commitment ----------------------------------------------------------
    def _decode(self, out) -> AffinePoint:
        ops = jacobian_ops(self.curve.name)
        return ops.decode_points(tuple(c[None] for c in out))[0]

    def _msm_generic(self, scalars, points):
        return msm(scalars, points, self.curve, self.generic_method)

    def commit_ints(self, values: List[int]) -> AffinePoint:
        """Commit to raw scalar ints (host API; the generic-base MSM)."""
        if len(values) > len(self):
            raise ValueError(f"input too long: {len(values)} > key size {len(self)}")
        sc = encode_scalars(values, self.curve.scalar_modulus, self.device)
        return self._decode(self._msm_generic(sc, self._enc_slice(sc.shape[0])))

    def commit_device(self, witness_mont, mesh=None) -> AffinePoint:
        """Commit to a Montgomery word vector on the key's device: a one-shot
        full-width commit, so the generic-base MSM, never a table.  With a
        mesh, a sharded MSM over the vector zero-padded to a power of two
        (at least the mesh size, at most the key size), as in mira_tpu."""
        n = witness_mont.shape[0]
        if n > len(self):
            raise ValueError(f"input too long: {n} > key size {len(self)}")
        lf = limb_field(self.curve.scalar_modulus)
        scalars = lf.to_plain(witness_mont)
        if mesh is None:
            return self._decode(self._msm_generic(scalars, self._enc_slice(n)))
        from ..parallel.msm import sharded_msm

        n_pad = min(max(1 << max((n - 1).bit_length(), 0), mesh.size), len(self))
        if n_pad < n:
            n_pad = len(self)
        if n_pad > n:
            scalars = torch.cat((scalars, scalars.new_zeros(n_pad - n, scalars.shape[1])))
        return self._decode(sharded_msm(scalars, self._enc_slice(n_pad), self.curve,
                                        mesh))

    def commit_device_many(self, vectors, mesh=None, defer=False):
        """Commit several Montgomery vectors (the recurring cross-term
        widths), decoding all results after the last MSM is queued; each
        vector's plain form is one `field_lincomb` call (no host sync on
        the card).  With defer=True, returns a zero-arg callable that
        decodes, so the caller can do host work meanwhile.  With a mesh,
        each is a sharded `commit_device` (no tables)."""
        if mesh is not None:
            pts = [self.commit_device(v, mesh=mesh) for v in vectors]
            return (lambda: pts) if defer else pts
        p = self.curve.scalar_modulus
        outs = []
        with span("ct_msm_dispatch"):
            for v in vectors:
                if v.shape[0] > len(self):
                    raise ValueError(
                        f"input too long: {v.shape[0]} > key size {len(self)}")
                outs.append(self._msm_device(to_plain(p, v)))

        def _decode():
            with span("ct_decode"):
                return [self._decode(out) for out in outs]

        return _decode if defer else _decode()

    def _msm_device(self, scalars):
        """One MSM over plain-word scalars at a recurring width; returns the
        Jacobian word triple without decoding (asynchronous on the card).
        The width pads to a power of two (at most the key size), as in
        mira_tpu, so that widths that pad alike share one table."""
        n = scalars.shape[0]
        n_pad = min(1 << max((n - 1).bit_length(), 0), len(self))
        if n_pad < n:
            n_pad = len(self)
        tab = self._fixed_table(n_pad)
        if tab is None:
            return self._msm_generic(scalars, self._enc_slice(n))
        window, table = tab
        if n_pad > n:
            scalars = torch.cat((scalars, scalars.new_zeros(n_pad - n, scalars.shape[1])))
        return msm_fixed(scalars, table, self.curve, window)

    def _fixed_table(self, n: int):
        """The multiples table of the first n key points, or None: tables
        are for widths of at least FB_MIN_WIDTH seen twice (the first
        sighting runs the bucket MSM), and only while they fit in memory."""
        if n < FB_MIN_WIDTH:
            return None
        hit = self._fb_tables.get(n)
        if hit is not None:
            return hit
        window = fixed_base_window(n)
        self._fb_seen[n] = self._fb_seen.get(n, 0) + 1
        if self._fb_seen[n] < 2 or not self._fits(_table_bytes(n, window)):
            return None
        self._fb_tables[n] = (window, fixed_table(self._enc_slice(n), self.curve,
                                                  window))
        return self._fb_tables[n]

    def _fits(self, nbytes: int) -> bool:
        """A table may take at most half of the memory free on the key's
        device (the fold step's own transients need the rest); else it is
        not built and `fb_skipped` counts it."""
        if 2 * nbytes <= _free_bytes(self.device):
            return True
        self.fb_skipped += 1
        return False

    def commit_delta(self, dw) -> AffinePoint:
        """Incremental commitment of a tape-replayed DeviceWitness
        (table/packed.py): the witness differs from its captured template
        only at the tape's write positions, so

            C(W) = C(template) + MSM(value - template_value @ positions),

        an MSM over the write positions instead of num_cols * 2^k points.
        The positions are fixed per tape, so their key points get a
        multiples table (window DELTA_WINDOW), built on first use, and the
        per-step MSM is the fixed-base one.  The template commitment
        persists as ctmpl-<template hash>.npy; the sum is returned as a
        LazyPoint whose decode waits for the first coordinate read."""
        lf = limb_field(self.curve.scalar_modulus)
        token = dw.cache_token.uid
        entry = self._delta_cache.get(token)
        if entry is None:
            tag = hashlib.sha1(dw.cache_token.packed_template.tobytes()).hexdigest()[:16]
            C_t = self._load_template_commit(f"ctmpl-{tag}.npy")
            if C_t is None:
                C_t = self.commit_device(dw.template_mont)
                self._save_template_commit(f"ctmpl-{tag}.npy", C_t)
            pos = dw.positions_np
            table = gpts = None
            if self._fits(_table_bytes(len(pos), DELTA_WINDOW)):
                table = fixed_table(self._encode_rows(self._limbs[pos]),
                                    self.curve, DELTA_WINDOW)
            else:
                gpts = self._encode_rows(self._limbs[pos])
            entry = (C_t, table, gpts)
            self._delta_cache[token] = entry
        C_t, table, gpts = entry
        with span("delta_scalars"):
            delta = fence(lf.to_plain(dw.delta_mont()))
        with span("delta_msm"):
            if table is not None:
                out = msm_fixed(delta, table, self.curve, DELTA_WINDOW)
            else:
                out = self._msm_generic(delta, gpts)
            fence(out)

        def _materialize():
            with span("delta_decode"):
                pt = C_t.add(self._decode(out))
                fence(out)
                return pt

        return LazyPoint(self.curve, _materialize)

    def table_shapes(self):
        """(lanes, window) of each multiples table held on the device: the
        delta tables, then the recurring widths'."""
        return ([(e[1].shape[0], DELTA_WINDOW) for e in self._delta_cache.values()
                 if e[1] is not None]
                + [(n, w) for n, (w, _) in sorted(self._fb_tables.items())])

    def release_device_cache(self):
        """Free every derived structure on the device (key encoding,
        multiples tables, delta tables), e.g. between the folding phase and
        the decider; each rebuilds on its next use."""
        self._enc_cache = None
        self._fb_tables = {}
        self._delta_cache = {}

    # -- template-commitment persistence ---------------------------------------
    def _aux_path(self, name: str) -> Optional[str]:
        return None if self._aux_dir is None else os.path.join(self._aux_dir, name)

    def _write(self, name: str, arr: np.ndarray):
        path = self._aux_path(name)
        if path is None:
            return
        os.makedirs(self._aux_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, path)

    def _load_template_commit(self, name: str) -> Optional[AffinePoint]:
        path = self._aux_path(name)
        if path is None or not os.path.exists(path):
            return None
        xv, yv, inf = limbs_to_ints(np.load(path))
        if inf:
            return AffinePoint.identity(self.curve)
        F = field(self.curve.base_modulus)
        pt = AffinePoint(self.curve, F(xv), F(yv))
        if not pt.is_on_curve():
            raise ValueError(f"corrupted template commitment {path}")
        return pt

    def _save_template_commit(self, name: str, pt: AffinePoint):
        vals = [0, 0, 1] if pt.is_inf else [pt.x.v, pt.y.v, 0]
        self._write(name, ints_to_limbs(vals))


def _table_bytes(n: int, window: int) -> int:
    """Bytes of a multiples table: n lanes of 2^(w-1) (x, y) pairs of 32
    bytes each."""
    return n * (1 << (window - 1)) * 64
