"""Multi-device dryrun of the port: the four checks of mira_tpu's
`__graft_entry__.dryrun_multichip`, on a mesh of torch.distributed ranks.

    python -m mira_tpu_torch.parallel.dryrun --devices N --device cpu|cuda

1. row-sharded fold and evaluation: each rank folds and squares its block of
   a random vector, gathered == the host's values;
2. the distributed NTT == `ntt`, forward and inverse (and, given
   `ntt_log_n`, once more at that size);
3. the sharded MSM of 512 random BN254 points == the native host MSM;
4. a real VanillaFS fold of the k=9 demo structure (workloads/demo.py) with
   a real commitment key: the SPS trace and the fold with the mesh == without
   it, instance for instance and witness for witness, then `is_sat_relaxed`.

One device runs in this process (a group of one); several start that many
ranks (parallel/mesh.py `run_spmd`: gloo on the CPU, NCCL on CUDA), and the
single-device references of part 4 run here after they finish.
"""

from __future__ import annotations

import argparse
import hashlib
import random
import time

import torch

K = 9  # table size of part 4, as in mira_tpu's dryrun
LABEL = b"dryrun"


def _ro():
    from ..fields.params import BN254_FQ
    from ..ops.poseidon import create_ro

    return create_ro(BN254_FQ)


def zero_accumulator(S, device):
    from ..plonk.structure import (
        RelaxedPlonkInstance,
        RelaxedPlonkTrace,
        RelaxedPlonkWitness,
    )

    return RelaxedPlonkTrace(
        RelaxedPlonkInstance.new(S.curve, S.num_io, S.num_challenges,
                                 len(S.round_sizes), S.num_g1_elems,
                                 S.num_g2_elems),
        RelaxedPlonkWitness.zeros(S.lf, S.k, S.round_sizes, device))


def demo_fold(mesh, device, k: int = K):
    """The SPS trace of the demo structure at k and one VanillaFS fold of it
    into the zero accumulator, with `mesh` (or without, mesh None), on
    `device`.  Returns (structure, key, trace, folded trace)."""
    from ..curves.host import BN254_G1, AffinePoint
    from ..nifs.vanilla import VanillaFS
    from ..ops.commitment import CommitmentKey
    from ..workloads.demo import demo_structure

    S, advice = demo_structure(k)
    ck = CommitmentKey.setup(BN254_G1, k + 2, LABEL, device=device)
    pp, _ = VanillaFS.setup_params(AffinePoint.generator(BN254_G1), S)
    trace = VanillaFS.generate_plonk_trace(ck, [], advice, pp, _ro(), mesh=mesh)
    folded = VanillaFS.prove(ck, pp, _ro(), zero_accumulator(S, device), trace,
                             rng=random.Random(1), mesh=mesh)[0]
    return S, ck, trace, folded


def _digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()


def mesh_fold_plain(mesh, k: int = K) -> dict:
    """Part 4 on one rank: the mesh's trace instance and folded trace as
    plain data, and the kinds of evaluator the structure built ("fold": the
    fold evaluator on the rank's row range), after checking that every rank
    holds the same."""
    from ..convert import relaxed_trace_plain, to_plain

    S, _, trace, folded = demo_fold(mesh, mesh.device, k)
    out = {"trace_u": to_plain(trace.u), "folded": relaxed_trace_plain(folded),
           "evaluators": sorted({key[0] for key in S._cache()})}
    if len(set(mesh.all_gather_object(_digest(out)))) != 1:
        raise AssertionError("the ranks' folded traces differ")
    return out


def _random_field(rng, n, p):
    return [rng.randrange(p) for _ in range(n)]


def dryrun_inputs(world: int) -> dict:
    """The inputs of parts 2 and 3 as plain data: a vector over BN254 Fr of
    max(64, 4 world^2) values, and 512 random BN254 points with scalars."""
    from ..curves.host import BN254_G1, AffinePoint
    from ..fields.params import BN254_FR

    rng = random.Random(0)
    m = max(64, 4 * world * world)
    npts = 1 << K
    pts = [AffinePoint.random(BN254_G1, rng) for _ in range(npts)]
    return {
        "ntt": [(BN254_FR, _random_field(rng, 1 << (m.bit_length() - 1), BN254_FR))],
        "msm": [("bn254", [rng.randrange(BN254_G1.scalar_modulus) for _ in range(npts)],
                 [None if q.is_inf else (q.x.v, q.y.v) for q in pts], ("auto",))],
        "fold_k": K,
    }


def mesh_results(mesh, inputs: dict) -> dict:
    """The mesh's results on plain inputs (`dryrun_inputs`' form), as plain
    data: per NTT input its distributed transform and inverse transform; per
    MSM input (curve name, scalars, points as (x, y) or None for the
    identity, methods) its sharded MSM by each method; and, with "fold_k",
    part 4's mesh fold (`mesh_fold_plain`)."""
    from ..convert import to_plain
    from ..curves.host import BN254_G1, GRUMPKIN, AffinePoint
    from ..curves.torch_curve import jacobian_ops
    from ..fields.host import field
    from ..fields.limbs import limb_field
    from ..ops.msm import encode_scalars
    from .msm import sharded_msm
    from .ntt import distributed_ntt

    dev = mesh.device
    out = {"ntt": [], "msm": []}
    for p, vals in inputs.get("ntt", []):
        lf = limb_field(p)
        a = lf.encode(vals, dev)
        out["ntt"].append([lf.decode(distributed_ntt(a, p, mesh, inverse))
                           for inverse in (False, True)])
    for name, scalars, points, methods in inputs.get("msm", []):
        curve = {"bn254": BN254_G1, "grumpkin": GRUMPKIN}[name]
        F = field(curve.base_modulus)
        pts = [AffinePoint.identity(curve) if q is None else
               AffinePoint(curve, F(q[0]), F(q[1])) for q in points]
        ops = jacobian_ops(name)
        s = encode_scalars(scalars, curve.scalar_modulus, dev)
        P = ops.encode_points(pts, dev)
        out["msm"].append([
            to_plain(ops.decode_points(tuple(
                c[None] for c in sharded_msm(s, P, curve, mesh, method)))[0])
            for method in methods])
    if inputs.get("fold_k"):
        out["fold"] = mesh_fold_plain(mesh, inputs["fold_k"])
    return out


def dryrun_rank(mesh, ntt_log_n=None) -> dict:
    """Part 1, parts 2 and 3 against their single-device results, and part
    4's mesh fold, on one rank; returns the part 4 data and the seconds of
    each part."""
    from ..convert import from_plain, msm_reference
    from ..curves.host import BN254_G1
    from ..curves.torch_curve import jacobian_ops
    from ..fields.limbs import limb_field
    from ..fields.params import BN254_FR
    from ..ops.msm import encode_scalars
    from ..ops.ntt import ntt
    from .ntt import distributed_ntt

    dev = mesh.device
    p = BN254_FR
    lf = limb_field(p)
    secs = {}

    t0 = time.perf_counter()
    vals = _random_field(random.Random(1), 16 * mesh.size, p)
    r = lf.const(7, (1,), dev)

    def fold_eval_rows(w):
        f = lf.add(w, lf.mul(r, w))
        return lf.mul(f, f)  # a quadratic gate term per row

    got = lf.decode(mesh.rowwise(fold_eval_rows, lf.encode(vals, dev)))
    if got != [(8 * v) ** 2 % p for v in vals]:
        raise AssertionError("part 1: row-sharded fold and evaluation differ")
    secs["part1"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    inputs = dryrun_inputs(mesh.size)
    res = mesh_results(mesh, inputs)
    secs["parts2_3_4_mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (_, vals), = inputs["ntt"]
    a = lf.encode(vals, dev)
    if res["ntt"][0] != [lf.decode(ntt(a, p, inverse)) for inverse in (False, True)]:
        raise AssertionError("part 2: distributed NTT != ntt")
    if ntt_log_n:  # a device-sized input: random words below 2^253 < p
        g = torch.Generator().manual_seed(ntt_log_n)
        w = torch.randint(0, 1 << 31, (1 << ntt_log_n, 8), generator=g,
                          dtype=torch.int64)
        w[:, 7] &= 0x0FFFFFFF
        a = lf.from_plain(w.to(torch.int32).to(dev))
        for inverse in (False, True):
            if not torch.equal(distributed_ntt(a, p, mesh, inverse),
                               ntt(a, p, inverse)):
                raise AssertionError(f"part 2: distributed NTT 2^{ntt_log_n} "
                                     f"(inverse={inverse}) != ntt")
        del a, w
    secs["part2_single"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (name, scalars, points, _), = inputs["msm"]
    pts = [from_plain(("G1", name, q[0], q[1], False)) for q in points]
    want = msm_reference(encode_scalars(scalars, BN254_G1.scalar_modulus, dev),
                         jacobian_ops(name).encode_points(pts, dev), BN254_G1)
    if from_plain(res["msm"][0][0]) != want:
        raise AssertionError("part 3: sharded MSM != native host MSM")
    secs["part3_single"] = time.perf_counter() - t0
    return {"secs": secs, "fold": res["fold"]}


def dryrun_multichip(n_devices: int, device="cuda", ntt_log_n=None) -> dict:
    """Run the four parts on a mesh of n_devices ranks on `device` ("cpu" or
    "cuda"); raises AssertionError on any mismatch.  Returns the seconds of
    each part."""
    from ..convert import relaxed_trace_plain, to_plain
    from .mesh import make_mesh, run_spmd

    t_start = time.perf_counter()
    if n_devices == 1:
        with make_mesh(1, device) as mesh:
            out = dryrun_rank(mesh, ntt_log_n)
    else:
        out = run_spmd(dryrun_rank, n_devices, device, ntt_log_n)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    S, ck, trace, single = demo_fold(None, dev)
    if to_plain(trace.u) != out["fold"]["trace_u"]:
        raise AssertionError("part 4: the mesh's SPS trace != the single device's")
    if relaxed_trace_plain(single) != out["fold"]["folded"]:
        raise AssertionError("part 4: mesh fold != single-device fold")
    S.is_sat_relaxed(ck, single.U, single.W)
    secs = dict(out["secs"])
    secs["part4_single_and_sat"] = time.perf_counter() - t0
    secs["total"] = time.perf_counter() - t_start
    return secs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    secs = dryrun_multichip(args.devices, args.device)
    print(f"dryrun_multichip({args.devices}, {args.device}): row-sharded fold "
          f"and evaluation, distributed NTT, sharded MSM and a k={K} VanillaFS "
          f"fold (mesh == single device, is_sat_relaxed) all verified; seconds "
          f"{secs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
