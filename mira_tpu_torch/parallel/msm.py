"""Multi-device MSM (port of mira_tpu/parallel/msm.py): the points and
scalars split across the mesh's ranks, a partial MSM per rank, and the
partials combined by an all_gather and a local tree of additions (point
addition is no reduction a collective can do).

`sharded_msm` is SPMD: every rank holds the whole (replicated) scalars and
points, takes its contiguous block of N / world of them, runs the per-shard
engine, gathers the three coordinate tensors of every rank's partial and
sums them, so every rank returns the same point.  The engine is one of
ops/msm.py `msm`'s methods (its kernel on a CUDA tensor, its plain version
on a CPU one) or "native", the C++ host Pippenger with one thread per shard
(ops/native_msm.py).  "auto" is kernel 4, "pippenger", on the card and
"native" on the CPU.

`sharded_msm_host` is mira_tpu's host scaling engine: the same shards, each
on the native Pippenger in a thread pool, summed on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..curves.host import AffinePoint, CurveParams
from ..curves.torch_curve import jacobian_ops
from ..fields.limbs import NUM_WORDS, limb_field
from ..ops.msm import METHODS, msm, tree_sum


def _u64(t: torch.Tensor) -> np.ndarray:
    """(n, 8) int32 words -> (n, 4) uint64 limbs of the same integers."""
    a = np.ascontiguousarray(t.detach().cpu().numpy(), dtype="<i4")
    return a.view("<u8").reshape(-1, 4).copy()


def native_shard(scalars: torch.Tensor, points, curve: CurveParams):
    """The native C++ Pippenger over one shard, one thread (the shards are
    the parallelism): plain scalar words and (X, Y, Z) Montgomery words of
    affine or identity bases in, a canonical Jacobian triple of Montgomery
    (8,) words out, on the input's device (the CPU)."""
    from ..ops.native_msm import msm_native_raw

    if scalars.device.type != "cpu":
        raise ValueError("native_shard: the native engine takes CPU tensors")
    lf = limb_field(curve.base_modulus)
    X, Y, Z = points
    zp = lf.to_plain(Z)
    is_inf = lf.is_zero(zp)
    one = torch.zeros_like(zp[:1])
    one[0, 0] = 1
    if not bool(((zp == one).all(-1) | is_inf).all()):
        raise ValueError("native shard MSM requires affine points")
    keep = (~is_inf)[:, None]
    sc = torch.where(keep, scalars, torch.zeros_like(scalars))
    xs = torch.where(keep, lf.to_plain(X), torch.zeros_like(zp))
    ys = torch.where(keep, lf.to_plain(Y), torch.zeros_like(zp))
    jac = msm_native_raw(_u64(sc), _u64(xs), _u64(ys), curve.base_modulus,
                         nthreads=1)  # (3, 4) uint64, plain
    words = torch.from_numpy(np.ascontiguousarray(jac, dtype="<u8")
                             .view("<i4").reshape(3, NUM_WORDS).copy())
    out = lf.from_plain(words)
    return (out[0], out[1], out[2])


def _engine(method: str, device: torch.device) -> str:
    if method == "auto":
        return "pippenger" if device.type == "cuda" else "native"
    if method != "native" and method not in METHODS:
        raise ValueError(f"sharded_msm: method {method!r} not in "
                         f"{('auto', 'native') + METHODS}")
    return method


def sharded_msm(scalars: torch.Tensor, points, curve: CurveParams, mesh,
                method: str = "auto"):
    """sum_i s_i * P_i across the mesh.  scalars: (N, 8) plain words;
    points: (X, Y, Z) (N, 8) Montgomery words, affine or identity; N a
    multiple of the mesh size.  Returns a canonical Jacobian triple of (8,)
    tensors, the same on every rank."""
    n = scalars.shape[0]
    if n % mesh.size:
        raise ValueError(f"sharded_msm: {n} points do not split over "
                         f"{mesh.size} ranks")
    engine = _engine(method, scalars.device)
    m = n // mesh.size
    lo = mesh.rank * m
    sc = scalars[lo : lo + m]
    pts = tuple(c[lo : lo + m] for c in points)
    if engine == "native":
        part = native_shard(sc, pts, curve)
    else:
        part = msm(sc, pts, curve, engine)
    if mesh.size == 1:
        return part
    gathered = []
    for c in part:
        parts = [torch.empty_like(c) for _ in range(mesh.size)]
        dist.all_gather(parts, c.contiguous(), group=mesh.group)
        gathered.append(torch.stack(parts)[None])  # (1, world, 8)
    ops = jacobian_ops(curve.name)
    return ops.canon(tuple(c[0] for c in tree_sum(ops, ops.lz(gathered))))


def sharded_msm_host(scalars: torch.Tensor, points, curve: CurveParams,
                     nshards: int) -> AffinePoint:
    """The shards of `sharded_msm` on the native Pippenger (one thread each)
    in a thread pool of `nshards`, the partials summed on the host; CPU
    tensors in, a host AffinePoint out."""
    from concurrent.futures import ThreadPoolExecutor

    n = scalars.shape[0]
    if n % nshards:
        raise ValueError(f"sharded_msm_host: {n} points do not split into "
                         f"{nshards} shards")
    m = n // nshards

    def shard(i):
        sl = slice(i * m, (i + 1) * m)
        return native_shard(scalars[sl], tuple(c[sl] for c in points), curve)

    with ThreadPoolExecutor(max_workers=nshards) as ex:
        parts = list(ex.map(shard, range(nshards)))
    ops = jacobian_ops(curve.name)
    acc = AffinePoint.identity(curve)
    for part in parts:
        acc = acc.add(ops.decode_points(tuple(c[None] for c in part))[0])
    return acc
