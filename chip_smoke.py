#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mira_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Builds the CUDA kernels from mira_tpu_torch/csrc, holds each kernel against
its plain PyTorch version on the card (exact equality: these are field and
curve values), checks the bucket MSM at 2^20 against the C++ host
Pippenger, then drives two paths through the port, both in mira_tpu's
default commitment configuration (fixed-base multiples tables for the
per-step delta commits and the recurring cross-term widths).  It holds
the table build and the fixed-base MSM against their plain versions at
every table shape each path builds, and the fold evaluator at each path's
row count:

- the bench's main path: real commitment keys of 2^21 points per curve,
  public parameters of the k=17 Poseidon/trivial two-curve IVC, the zero
  step, three fold steps and IVC.verify(strict=True);
- SnarkStar batch 1 (workloads/snarkstar.run): k=19, real keys of 2^23
  (BN254) and 2^24 (Grumpkin) points, real Groth16 proofs of a
  1000-constraint circuit folded with real pairing Gt cross terms, two fold
  steps and verify(strict=True), which includes the real-pairing Gt decider.

Kernel launches are counted over each path.  The keys of both paths come
from one background thread started first (the native keygen releases the
GIL): the k=17 path's 2^21 keys while the kernels build, then SnarkStar's,
which grow from them by their new rows alone, while the k=17 path runs.
With --profile DIR it runs one more k=17 fold step under torch.profiler
and prints the device's busy share of that step and the ops by device
time.

Prints the device lines, per-phase seconds, one JSON line of kernels, the
card's name and power limit, and last a JSON line {"ok": true, "device":
...}.  Any failed phase raises and the script exits non-zero.  It exits
non-zero without a result when no CUDA device is visible or when run
outside a checkout of the repository.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

K = 17
FOLD_STEPS = 3
SEED = 20261016
SNARK_STEPS = 2  # the reference's slow test runs 2, its bench 4
SNARK_CONSTRAINTS = 1000


def log(msg: str):
    print(msg, flush=True)


def phase(name: str, t0: float):
    log(f"[phase] {name}: {time.perf_counter() - t0:.3f} s")


def timed_cuda(fn, reps: int):
    """Mean milliseconds per call over `reps` calls, after one warm call,
    by CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(result, milliseconds) of one call, by CUDA events: the plain
    versions, whose one timed call also gives the result compared."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(ints_a, ints_b) -> int:
    """Largest |a - b| over two equal-length lists of field or coordinate
    integers (0 when the kernel and its plain version agree exactly)."""
    if len(ints_a) != len(ints_b):
        raise AssertionError("outputs differ in length")
    return max((abs(a - b) for a, b in zip(ints_a, ints_b)), default=0)


def point_ints(pt):
    return [1, 0, 0] if pt.is_inf else [0, pt.x.v, pt.y.v]


def device_lines(torch):
    log(f"device: {torch.cuda.get_device_name(0)} (count "
        f"{torch.cuda.device_count()})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(f"nvidia-smi: {smi[0]}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    from mira_tpu_torch import _build

    nv = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()
    log(f"nvcc: {nv[-1]}")
    try:
        import triton  # noqa: F401

        log(f"triton: {triton.__version__}")
    except ImportError:
        log("triton: not importable")
    return smi[0]


def check_field_kernels(torch, dev, rng):
    """csrc/field.cuh through its test entry point against fields/limbs.py
    and curves/torch_curve.py."""
    from mira_tpu_torch import _build
    from mira_tpu_torch.curves.torch_curve import AffinePoint, jacobian_ops
    from mira_tpu_torch.fields.limbs import limb_field
    from mira_tpu_torch.workloads.poseidon import BN254_G1, GRUMPKIN

    lib = _build.lib()
    for curve in (BN254_G1, GRUMPKIN):
        fid = _build.field_id(curve.base_modulus)
        lf = limb_field(curve.base_modulus)
        p = lf.modulus
        n = 1024
        edge = [0, 1, 2, p - 1, p - 2, lf.r_mod_p, (1 << 253) % p]
        xs = edge + [int.from_bytes(rng.bytes(32), "little") % p
                     for _ in range(n - len(edge))]
        ys = list(reversed(edge)) + [int.from_bytes(rng.bytes(32), "little") % p
                                     for _ in range(n - len(edge))]
        a = lf.encode(xs, dev)
        b = lf.encode(ys, dev)
        plain = {0: lf.mul(a, b), 1: lf.add(a, b), 2: lf.sub(a, b),
                 3: lf.inv(a[:64])}
        for op, want in plain.items():
            m = want.shape[0]
            out = torch.empty_like(want)
            _build.check(lib.mira_field_test(
                fid, op, m, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                _build.stream_ptr(dev)), "field_test")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"field op {op} on {curve.name}: kernel "
                                     f"!= plain on {(out != want).any(-1).sum()} rows")
        # points: random multiples of the generator, the identity, P == Q
        # and P == -Q lanes
        ops = jacobian_ops(curve.name)
        g = AffinePoint.generator(curve)
        pts = [g.scalar_mul(int(s)) for s in rng.integers(1, 1 << 62, size=60)]
        P = pts + [pts[0], pts[1], pts[2], AffinePoint.identity(curve)]
        Q = pts[::-1] + [pts[0], pts[1].neg(), AffinePoint.identity(curve), pts[3]]
        pe = torch.stack(ops.encode_points(P, dev), dim=1).contiguous()
        qe = torch.stack(ops.encode_points(Q, dev), dim=1).contiguous()
        ptP = tuple(pe[:, i] for i in range(3))
        ptQ = tuple(qe[:, i] for i in range(3))
        for op, want in ((4, ops.add(ptP, ptQ)), (5, ops.double(ptP))):
            out = torch.empty_like(pe)
            _build.check(lib.mira_field_test(
                fid, op, pe.shape[0], pe.data_ptr(), qe.data_ptr(),
                out.data_ptr(), _build.stream_ptr(dev)), "field_test")
            torch.cuda.synchronize()
            got = ops.decode_points(tuple(out[:, i] for i in range(3)))
            if got != ops.decode_points(want):
                raise AssertionError(f"point op {op} on {curve.name}: kernel "
                                     "!= plain")
        # XYZZ madd/add/double path: 3 * (P + Q) on affine inputs
        out = torch.empty_like(pe)
        _build.check(lib.mira_field_test(
            fid, 6, pe.shape[0], pe.data_ptr(), qe.data_ptr(), out.data_ptr(),
            _build.stream_ptr(dev)), "field_test")
        torch.cuda.synchronize()
        got = ops.decode_points(tuple(out[:, i] for i in range(3)))
        want = [a.add(b).scalar_mul(3) for a, b in zip(P, Q)]
        if got != want:
            raise AssertionError(f"xyzz ops on {curve.name}: kernel != host")
    log("field.cuh: mul/add/sub/inv, jac_add/jac_double, xyzz madd/add/double "
        "== plain on both fields (exact)")


def adversarial_input(curve, n, rng):
    """bench.py's bucket smoke input at width n: 8 random bases repeated,
    an exact (scalar, point) duplicate pair, a zero scalar, an identity
    lane."""
    import random

    from mira_tpu_torch.curves.torch_curve import AffinePoint

    r = random.Random(int(rng.integers(1 << 30)))
    base = [AffinePoint.random(curve, r) for _ in range(8)]
    pts = [base[i % 7] for i in range(n - 1)] + [AffinePoint.identity(curve)]
    sc = [r.randrange(curve.scalar_modulus) for _ in range(n)]
    sc[3] = sc[10]
    sc[5] = 0
    return sc, pts


def check_msm_small(torch, dev, rng):
    from mira_tpu_torch.convert import msm_reference
    from mira_tpu_torch.curves.torch_curve import jacobian_ops
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.ops.msm import encode_scalars, msm_plain
    from mira_tpu_torch.workloads.poseidon import BN254_G1, GRUMPKIN

    for curve in (BN254_G1, GRUMPKIN):
        ops = jacobian_ops(curve.name)
        sc, pts = adversarial_input(curve, 1 << 12, rng)
        s = encode_scalars(sc, curve.scalar_modulus, dev)
        P = ops.encode_points(pts, dev)
        got = ops.decode_points(tuple(c[None] for c in cuda_msm.msm_cuda(s, P, curve)))[0]
        plain = ops.decode_points(tuple(c[None] for c in msm_plain(s, P, curve)))[0]
        ref = msm_reference(s, P, curve)
        if not (got == plain == ref):
            raise AssertionError(f"bucket MSM 2^12 on {curve.name}: kernel "
                                 f"{got} plain {plain} host {ref}")
    log("msm_bucket 2^12 adversarial (duplicates, zero scalar, identity lane): "
        "kernel == plain == host on both curves (exact)")


def decode_one(curve, out):
    from mira_tpu_torch.curves.torch_curve import jacobian_ops

    return jacobian_ops(curve.name).decode_points(tuple(c[None] for c in out))[0]


def check_fixed_small(torch, dev, rng):
    """fixed_table and msm_fixed against their plain versions and the host
    MSM at widths 256 (w=6), 1000 (w=5; not a multiple of the TPU kernel's
    256-lane block) and 2^12 (w=6): duplicate bases, a zero scalar, an
    identity lane, scalars 1, r - 1 and 2^250 - 1 (every raw 5-bit digit
    maximal); then 2^256 - 1 in every lane at both windows, whose carry
    reaches the extra window at w = 5, against the plain version and the
    host MSM of the reduced scalar."""
    from mira_tpu_torch.convert import msm_reference
    from mira_tpu_torch.curves.torch_curve import jacobian_ops
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.ops.msm import (
        encode_scalars,
        msm_fixed_plain,
        precompute_fixed_table_plain,
    )
    from mira_tpu_torch.workloads.poseidon import BN254_G1, GRUMPKIN

    for curve in (BN254_G1, GRUMPKIN):
        ops = jacobian_ops(curve.name)
        r = curve.scalar_modulus
        for n, window in ((256, 6), (1000, 5), (1 << 12, 6)):
            sc, pts = adversarial_input(curve, n, rng)
            sc[:4] = [0, 1, r - 1, (1 << 250) - 1]
            sc[10] = sc[3]  # bases 3 and 10 are equal
            P = ops.encode_points(pts, dev)
            s = encode_scalars(sc, r, dev)
            ref = msm_reference(s, P, curve)
            tab = cuda_msm.fixed_table_cuda(P, curve, window)
            plain_tab = precompute_fixed_table_plain(P, curve, window)
            torch.cuda.synchronize()
            if not torch.equal(tab, plain_tab):
                raise AssertionError(f"fixed_table n={n} w={window} on "
                                     f"{curve.name}: kernel != plain")
            got = decode_one(curve, cuda_msm.msm_fixed_cuda(s, tab, curve, window))
            plain = decode_one(curve, msm_fixed_plain(s, tab, curve, window))
            if not (got == plain == ref):
                raise AssertionError(
                    f"msm_fixed n={n} w={window} on {curve.name}: kernel "
                    f"{got} plain {plain} host {ref}")
        ones = torch.full((256, 8), -1, dtype=torch.int32, device=dev)
        P = tuple(c[:256] for c in P)
        ref = msm_reference(encode_scalars([((1 << 256) - 1) % r] * 256, r, dev),
                            P, curve)
        for window in cuda_msm.FIXED_WINDOWS:
            tab = cuda_msm.fixed_table_cuda(P, curve, window)
            got = decode_one(curve, cuda_msm.msm_fixed_cuda(ones, tab, curve, window))
            plain = decode_one(curve, msm_fixed_plain(ones, tab, curve, window))
            if not (got == plain == ref):
                raise AssertionError(f"msm_fixed 2^256-1 w={window} on "
                                     f"{curve.name}: kernel != plain != host")
    log("fixed_table, msm_fixed at n = 256, 1000, 4096 (duplicates, "
        "zero scalar, identity lane, r - 1, 2^250 - 1, 2^256 - 1): kernel == "
        "plain == host on both curves (exact)")


def start_keygen(specs):
    """Make (or load) the commitment keys of `specs` [(curve, k, label)],
    one after another in order, into .cache/ck on a background thread; the
    native keygen runs in C++ threads without the GIL, and a key grows from
    a smaller one of its label made before it.  Returns one future per key,
    of its seconds."""
    from mira_tpu_torch.ops.commitment import CommitmentKey

    def make(curve, k, label):
        t0 = time.perf_counter()
        CommitmentKey.load_or_setup_cache(curve, k, label)
        return time.perf_counter() - t0

    pool = ThreadPoolExecutor(1)
    futs = [pool.submit(make, *spec) for spec in specs]
    pool.shutdown(wait=False)
    return futs


def launch_counts():
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.polynomial import fold_evaluator as fe

    return {"msm_bucket": cuda_msm.launches, "msm_fixed": cuda_msm.fixed_launches,
            "fixed_table": cuda_msm.table_launches, "fold_eval": fe.launches}


def reset_launch_counts():
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.polynomial import fold_evaluator as fe

    cuda_msm.launches = cuda_msm.fixed_launches = cuda_msm.table_launches = 0
    fe.launches = 0


def fixed_checks(torch, dev, rng, ck, shapes, path):
    """`fixed_timings` at every (lanes, window) in `shapes`, the tables
    that `ck` built on `path`, over its first key points; returns the two
    lists of results (msm_fixed, fixed_table)."""
    msms, tables = [], []
    for n, window in shapes:
        m, t = fixed_timings(torch, dev, rng, ck.curve,
                             ck._encode_rows(ck._limbs[:n]), window)
        msms.append({"path": path, "curve": ck.curve.name, **m})
        tables.append({"path": path, "curve": ck.curve.name, **t})
    return msms, tables


def fixed_timings(torch, dev, rng, curve, points, window, reps=5):
    """Kernel and plain times of the table build and of the fixed-base MSM
    over `points` at `window`, random canonical scalars; both kernels must
    equal their plain versions."""
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.ops.msm import msm_fixed_plain, precompute_fixed_table_plain

    n = points[0].shape[0]
    tab_ms = timed_cuda(lambda: cuda_msm.fixed_table_cuda(points, curve, window), reps)
    plain_tab, tab_plain_ms = timed_once(
        lambda: precompute_fixed_table_plain(points, curve, window))
    tab = cuda_msm.fixed_table_cuda(points, curve, window)
    # both tables hold canonical words, so equal words are equal values
    tab_err = int((tab.long() - plain_tab.long()).abs().max())
    if tab_err:
        raise AssertionError(f"fixed_table n={n} w={window}: kernel != plain")
    del plain_tab
    s = _random_plain(rng, n, dev)
    ms = timed_cuda(lambda: cuda_msm.msm_fixed_cuda(s, tab, curve, window), reps)
    want, plain_ms = timed_once(lambda: msm_fixed_plain(s, tab, curve, window))
    got = decode_one(curve, cuda_msm.msm_fixed_cuda(s, tab, curve, window))
    err = max_abs_err(point_ints(got), point_ints(decode_one(curve, want)))
    if err:
        raise AssertionError(f"msm_fixed n={n} w={window}: kernel != plain")
    log(f"n={n} w={window} {curve.name}: fixed_table {tab_ms:.3f} ms (plain "
        f"{tab_plain_ms:.3f} ms), msm_fixed {ms:.3f} ms (plain {plain_ms:.3f} ms)")
    return ({"n": n, "window": window, "ms": ms, "plain_ms": plain_ms,
             "max_abs_err": err},
            {"n": n, "window": window, "ms": tab_ms, "plain_ms": tab_plain_ms,
             "max_abs_err": tab_err})


def run_snarkstar(torch, dev):
    """SnarkStar batch 1 through workloads/snarkstar.run on the card, with
    the kernels' launches counted over the whole run; returns the counts
    and run()'s report."""
    import gc

    from mira_tpu_torch.utils import tracing
    from mira_tpu_torch.workloads import snarkstar

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tracing.reset()
    secs = snarkstar.run(steps=SNARK_STEPS, batch_size=1, use_mock_ck=False,
                         real_proofs=True, num_constraints=SNARK_CONSTRAINTS,
                         device=dev)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"snarkstar phases (s): "
        f"{json.dumps({k: v for k, v in secs.items() if k != 'ivc'})}")
    log(f"snarkstar fold steps (s): {secs['fold_steps']}; first "
        f"{secs['fold_steps'][0]:.3f} s")
    log(f"snarkstar launches over the run: {counts}")
    log("snarkstar host span tree (zero step, fold steps, decider):")
    log(tracing.report(min_runtime=0.05))
    log(f"snarkstar peak device memory: {peak / 2**30:.3f} GiB")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the SnarkStar path was not launched: {counts}")
    return counts, secs


def check_msm_large(torch, dev, rng, ck):
    from mira_tpu_torch.convert import msm_reference
    from mira_tpu_torch.ops import cuda_msm

    n = 1 << 20
    curve = ck.curve
    s = _random_plain(rng, n, dev)
    P = ck._enc_slice(n)
    t0 = time.perf_counter()
    out = cuda_msm.msm_cuda(s, P, curve)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    from mira_tpu_torch.curves.torch_curve import jacobian_ops

    got = jacobian_ops(curve.name).decode_points(tuple(c[None] for c in out))[0]
    t0 = time.perf_counter()
    ref = msm_reference(s, P, curve)
    t_h = time.perf_counter() - t0
    if got != ref:
        raise AssertionError(f"bucket MSM 2^20 on {curve.name}: kernel {got} "
                             f"!= host {ref}")
    log(f"msm_bucket 2^20 ({curve.name}, key points): kernel == host C++ "
        f"Pippenger (kernel {t_k:.3f} s incl. first launch, host {t_h:.3f} s)")


def check_fold_eval(torch, dev, rng, S):
    """Kernel vs plain on the k=17 step-folding circuit's homogeneous
    expression, seeded random witness, all fold points."""
    from mira_tpu_torch.polynomial import fold_evaluator as fe

    lf = S.lf
    p = S.modulus
    ev = S.fold_evaluator(dev)
    Ws1, Ws2 = ([lf.from_plain(_random_plain(rng, sz, dev)) for sz in S.round_sizes]
                for _ in range(2))
    nch = S.num_challenges + 1
    ch1 = [int(v) % p for v in rng.integers(0, 1 << 62, size=nch)]
    ch2 = [int(v) % p for v in rng.integers(0, 1 << 62, size=nch)]
    d = S.get_degree_for_folding() - 1
    js = list(range(d + 1))
    scalars, ops, ops_t, n_regs, consts = ev._program(len(ch1))
    w1 = ev._stack_advice(Ws1)
    w2 = ev._stack_advice(Ws2)
    jm = lf.encode(js, dev)
    _, ch = _challenge_rows(lf, js, ch1, ch2, scalars, dev)
    got = fe.fold_eval_cuda(lf, ops_t, n_regs, ev.static_stack, w1, w2, ch, jm, consts)
    torch.cuda.synchronize()
    want = fe.fold_eval_plain(lf, ops, ev.static_stack, w1, w2, ch, jm, consts)
    if not torch.equal(got, want):
        raise AssertionError("fold_eval on the k=17 SFC: kernel != plain on "
                             f"{(got != want).any(-1).sum()} entries")
    log(f"fold_eval k={S.k} SFC ({len(ops)} ops, {n_regs} registers, "
        f"{len(js)} fold points): kernel == plain (exact)")
    return (ev, ops, ops_t, n_regs, consts, w1, w2, ch, jm, js)


def _challenge_rows(lf, js, ch1, ch2, scalars, dev):
    from mira_tpu_torch.polynomial.fold_evaluator import _eval_scalar

    p = lf.modulus
    rows = []
    for j in js:
        chj = [(a + j * b) % p for a, b in zip(ch1, ch2)]
        rows.append(chj + [_eval_scalar(s, p, chj) for s in scalars])
    n_ch = len(rows[0])
    return rows, lf.encode([v for r in rows for v in r], dev).reshape(len(js), n_ch, 8)


def _random_plain(rng, n, dev):
    """(n, 8) int32 words of n uniform integers below 2^253, which is less
    than both BN254 primes: canonical plain scalars or field values."""
    import numpy as np
    import torch

    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    w[:, 7] &= 0x1FFFFFFF
    return torch.from_numpy(w.view(np.int32)).to(dev)


def profile_fold_step(torch, ivc, out_dir: str):
    """One more fold step under torch.profiler.  Prints the step's wall time,
    the device's busy time (the union of device-event intervals) and its
    share of the wall, and the ops by device time; writes that table to
    out_dir/fold_step_profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ivc.fold_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ivs = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if "CUDA" in str(getattr(e, "device_type", "")))
    busy_us, end = 0, None
    for s, e in ivs:
        if end is None or s > end:
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
    ka = prof.key_averages()
    key = ("device_time_total" if hasattr(ka[0], "device_time_total")
           else "cuda_time_total")
    table = ka.table(sort_by=key, row_limit=40, max_name_column_width=60)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "fold_step_profile.txt"), "w") as f:
        f.write(table)
    log(f"[profile] fold step {ivc.step}: wall {wall_us / 1e6:.4f} s "
        f"(profiled), {len(ivs)} device events, device busy "
        f"{busy_us / 1e6:.4f} s = {busy_us / wall_us:.4f} of the wall")
    log("\n".join(table.splitlines()[:30]))


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="after the checks, profile one more fold step and "
                         "write its table of device time to DIR")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import mira_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository "
              "(mira_tpu_torch not found)", file=sys.stderr)
        return 2
    import numpy as np

    from mira_tpu_torch import _build
    from mira_tpu_torch.ivc.ivc import IVC
    from mira_tpu_torch.ivc.public_params import CircuitSide, PublicParams
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.ops.commitment import CommitmentKey
    from mira_tpu_torch.ops.msm import fixed_base_window, msm_plain
    from mira_tpu_torch.polynomial import fold_evaluator as fe
    from mira_tpu_torch.utils import tracing
    from mira_tpu_torch.workloads import snarkstar
    from mira_tpu_torch.workloads.poseidon import (
        BN254_G1,
        GRUMPKIN,
        PoseidonStepCircuit,
        TrivialCircuit,
    )

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    card = device_lines(torch)
    # the k=17 path's keys first; SnarkStar's grow from them
    key_specs = [(BN254_G1, K + 4, "bn256"), (GRUMPKIN, K + 4, "grumpkin"),
                 (BN254_G1, 23, "bn256"), (GRUMPKIN, 24, "grumpkin")]
    keygen = start_keygen(key_specs)
    phase("device", t0)

    t0 = time.perf_counter()
    _build.lib()
    built = _build.build_seconds
    log(f"kernel build: {'%.1f s' % built if built is not None else 'cached'}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    phase("build", t0)

    t0 = time.perf_counter()
    check_field_kernels(torch, dev, rng)
    check_msm_small(torch, dev, rng)
    check_fixed_small(torch, dev, rng)
    phase("kernel_checks_small", t0)

    t0 = time.perf_counter()
    for (_, k, label), fut in zip(key_specs[:2], keygen):
        log(f"keygen {label} 2^{k} (native, background thread): {fut.result():.3f} s")
    ck1 = CommitmentKey.load_or_setup_cache(BN254_G1, K + 4, "bn256", device=dev)
    ck2 = CommitmentKey.load_or_setup_cache(GRUMPKIN, K + 4, "grumpkin", device=dev)
    phase("keys", t0)

    t0 = time.perf_counter()
    check_msm_large(torch, dev, rng, ck1)
    phase("msm_2^20_vs_host", t0)

    t0 = time.perf_counter()
    sc1 = PoseidonStepCircuit(BN254_G1.scalar_modulus, 1)
    sc2 = TrivialCircuit(arity=1)
    pp = PublicParams(CircuitSide(sc1, ck1, K), CircuitSide(sc2, ck2, K),
                      BN254_G1, GRUMPKIN)
    phase("public_params", t0)

    t0 = time.perf_counter()
    fe_state = check_fold_eval(torch, dev, rng, pp.primary.S)
    phase("fold_eval_check", t0)

    t0 = time.perf_counter()
    ivc = IVC(pp, sc1, [0], sc2, [0])
    torch.cuda.synchronize()
    phase("ivc_init", t0)

    # -- main path: launch counts over the fold steps ----------------------
    torch.cuda.reset_peak_memory_stats()
    tracing.reset()
    reset_launch_counts()
    step_secs = []
    for _ in range(FOLD_STEPS):
        t0 = time.perf_counter()
        ivc.fold_step()
        torch.cuda.synchronize()
        step_secs.append(time.perf_counter() - t0)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"fold steps (s): {step_secs}")
    log(f"launches over the fold steps: {counts}")
    log("host span tree of the fold steps (work queued on the card is "
        "charged to the span that waits for it):")
    log(tracing.report(min_runtime=0.01))
    log(f"peak device memory over the fold steps: {peak / 2**30:.3f} GiB")
    log(f"tables (lanes, window): {ck1.table_shapes()} / {ck2.table_shapes()}, "
        f"not fitting {ck1.fb_skipped + ck2.fb_skipped}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the main path was not launched: {counts}")

    t0 = time.perf_counter()
    ivc.verify(strict=True)
    torch.cuda.synchronize()
    phase("verify_strict", t0)
    log(f"IVC verify(strict=True) passed after {ivc.step} steps; "
        f"z_i = {ivc.primary.z_i}")

    # -- kernel vs plain times at the main path's shapes --------------------
    t0 = time.perf_counter()
    kernels = []
    n = 1 << K  # cross-term MSM width
    s = _random_plain(rng, n, dev)
    P = ck1._enc_slice(n)
    ms_k = timed_cuda(lambda: cuda_msm.msm_cuda(s, P, BN254_G1), 5)
    want, ms_p = timed_once(lambda: msm_plain(s, P, BN254_G1))
    got = decode_one(BN254_G1, cuda_msm.msm_cuda(s, P, BN254_G1))
    err = max_abs_err(point_ints(got), point_ints(decode_one(BN254_G1, want)))
    if err:
        raise AssertionError(f"bucket MSM 2^{K}: kernel != plain")
    kernels.append({
        "name": "msm_bucket", "route": "cuda",
        "source": "mira_tpu_torch/csrc/msm_bucket.cu",
        "replaces": "mira_tpu/ops/pallas_msm.py:781",
        "launches": counts["msm_bucket"], "max_abs_err": err,
        "ms": ms_k, "plain_ms": ms_p,
        "shape": f"N=2^{K} bn254, full-width scalars",
    })
    ev, fops, ops_t, n_regs, consts, w1, w2, ch, jm, js = fe_state
    jsel = slice(1, len(js) - 1)  # the interior points a fold step evaluates

    def run_kernel():
        return fe.fold_eval_cuda(ev.lf, ops_t, n_regs, ev.static_stack, w1, w2,
                                 ch[jsel], jm[jsel], consts)

    def run_plain():
        return fe.fold_eval_plain(ev.lf, fops, ev.static_stack, w1, w2,
                                  ch[jsel], jm[jsel], consts)

    ms_k = timed_cuda(run_kernel, 5)
    want, ms_p = timed_once(run_plain)
    err = max_abs_err(ev.lf.decode(run_kernel()), ev.lf.decode(want))
    if err:
        raise AssertionError("fold_eval: kernel != plain at the interior points")
    kernels.append({
        "name": "fold_eval", "route": "cuda",
        "source": "mira_tpu_torch/csrc/fold_eval.cu",
        "replaces": "mira_tpu/polynomial/pallas_evaluator.py:323",
        "launches": counts["fold_eval"], "max_abs_err": err,
        "ms": ms_k, "plain_ms": ms_p,
        "shape": f"nrow=2^{K}, {len(js) - 2} fold points, {len(fops)} ops",
    })
    # the fixed-base kernels at every table shape of the k=17 steps: the
    # delta widths (the write positions' count, w=5) and the cross-term
    # width 2^17, on both curves; and at SnarkStar's cross-term width 2^19,
    # known before its keys are (whose first points these keys are), so
    # that its checks run while those keys are made
    n_s = 1 << snarkstar.table_sizes(1)[0]
    early = [(n_s, fixed_base_window(n_s))]
    msm_at, tab_at = [], []
    for ck in (ck1, ck2):
        for shapes, path in ((ck.table_shapes(), f"k={K}"), (early, "snarkstar")):
            m, t = fixed_checks(torch, dev, rng, ck, shapes, path)
            msm_at += m
            tab_at += t
    head = msm_at[0]  # the BN254 delta commit's
    kernels.append({
        "name": "msm_fixed", "route": "cuda",
        "source": "mira_tpu_torch/csrc/msm_fixed.cu",
        "replaces": "mira_tpu/ops/pallas_msm.py:1109",
        "launches": counts["msm_fixed"],
        "max_abs_err": max(m["max_abs_err"] for m in msm_at),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "shape": f"N={head['n']} (the k={K} delta width) {head['curve']}, "
                 f"w={head['window']}", "at": msm_at,
    })
    kernels.append({
        "name": "fixed_table", "route": "cuda",
        "source": "mira_tpu_torch/csrc/fixed_table.cu",
        "replaces": "mira_tpu/ops/pallas_msm.py:895",
        "launches": counts["fixed_table"],
        "max_abs_err": max(t["max_abs_err"] for t in tab_at),
        "ms": tab_at[0]["ms"], "plain_ms": tab_at[0]["plain_ms"],
        "shape": f"N={head['n']} {head['curve']}, w={head['window']}", "at": tab_at,
    })
    phase("kernel_timing", t0)

    if args.profile:
        t0 = time.perf_counter()
        profile_fold_step(torch, ivc, args.profile)
        phase("profile", t0)
    del ivc, pp, ck, ck1, ck2, P, s, fe_state, ev, w1, w2

    # -- SnarkStar batch 1 at k=19 with real Groth16 proofs -------------------
    t0 = time.perf_counter()
    for (_, k, label), fut in zip(key_specs[2:], keygen[2:]):
        log(f"keygen {label} 2^{k} (native, background thread, from the 2^{K + 4} "
            f"key): {fut.result():.3f} s")
    phase("snarkstar_keys_wait", t0)
    t0 = time.perf_counter()
    snark_counts, report = run_snarkstar(torch, dev)
    phase("snarkstar", t0)
    for k in kernels:
        k["launches_snarkstar"] = snark_counts[k["name"]]

    # the kernels at SnarkStar's shapes: its tables (the k=19 delta widths
    # and cross-term widths, both curves) and its fold evaluators over 2^19
    # rows, on the structures and keys the run used
    t0 = time.perf_counter()
    pp_s = report.pop("ivc").pp
    for side in (pp_s.primary, pp_s.secondary):
        shapes = [sh for sh in report["tables"][side.ck.curve.name]
                  if sh not in early]
        m, t = fixed_checks(torch, dev, rng, side.ck, shapes, "snarkstar")
        kernels[2]["at"] += m
        kernels[3]["at"] += t
        check_fold_eval(torch, dev, rng, side.S)
        kernels[1].setdefault("at", []).append(
            {"path": "snarkstar", "curve": side.ck.curve.name, "nrow": 1 << side.S.k,
             "max_abs_err": 0})
    for k in kernels[2:]:
        k["max_abs_err"] = max(a["max_abs_err"] for a in k["at"])
    del pp_s, report, side
    phase("snarkstar_kernel_checks", t0)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
