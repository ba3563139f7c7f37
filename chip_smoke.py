#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mira_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Builds the CUDA kernels from mira_tpu_torch/csrc, holds each kernel against
its plain PyTorch version on the card (exact equality: these are field and
curve values), checks the bucket MSM at 2^20 against the C++ host
Pippenger, then drives the bench's main path through the port: real
commitment keys of 2^21 points per curve, public parameters of the k=17
Poseidon/trivial two-curve IVC, the zero step, three fold steps and
IVC.verify(strict=True).  Kernel launches are counted over the fold steps.
With --profile DIR it then runs one more fold step under torch.profiler and
prints the device's busy share of that step and the ops by device time.

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

K = 17
FOLD_STEPS = 3
SEED = 20261016


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
    from mira_tpu_torch.ops.msm import encode_scalars, msm_plain
    from mira_tpu_torch.polynomial import fold_evaluator as fe
    from mira_tpu_torch.utils import tracing
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
    phase("kernel_checks_small", t0)

    t0 = time.perf_counter()
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
    cuda_msm.launches = 0
    fe.launches = 0
    step_secs = []
    for _ in range(FOLD_STEPS):
        t0 = time.perf_counter()
        ivc.fold_step()
        torch.cuda.synchronize()
        step_secs.append(time.perf_counter() - t0)
    counts = {"msm_bucket": cuda_msm.launches, "fold_eval": fe.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"fold steps (s): {step_secs}")
    log(f"launches over the fold steps: {counts}")
    log("host span tree of the fold steps (work queued on the card is "
        "charged to the span that waits for it):")
    log(tracing.report(min_runtime=0.01))
    log(f"peak device memory over the fold steps: {peak / 2**30:.3f} GiB")
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
    from mira_tpu_torch.curves.torch_curve import jacobian_ops

    kernels = []
    n = 1 << K  # cross-term MSM width
    s = _random_plain(rng, n, dev)
    P = ck1._enc_slice(n)
    ms_k = timed_cuda(lambda: cuda_msm.msm_cuda(s, P, BN254_G1), 5)
    ms_p = timed_cuda(lambda: msm_plain(s, P, BN254_G1), 1)
    ops = jacobian_ops("bn254")
    got = ops.decode_points(tuple(c[None] for c in cuda_msm.msm_cuda(s, P, BN254_G1)))
    want = ops.decode_points(tuple(c[None] for c in msm_plain(s, P, BN254_G1)))
    err = max_abs_err(point_ints(got[0]), point_ints(want[0]))
    if err:
        raise AssertionError(f"bucket MSM 2^{K}: kernel != plain")
    kernels.append({
        "name": "msm_bucket", "route": "cuda",
        "source": "mira_tpu_torch/csrc/msm_bucket.cu",
        "replaces": "mira_tpu/ops/pallas_msm.py:527",
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
    ms_p = timed_cuda(run_plain, 1)
    err = max_abs_err(ev.lf.decode(run_kernel()), ev.lf.decode(run_plain()))
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
    phase("kernel_timing", t0)

    if args.profile:
        t0 = time.perf_counter()
        profile_fold_step(torch, ivc, args.profile)
        phase("profile", t0)

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
