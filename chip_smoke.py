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
  public parameters of the k=17 Poseidon/trivial two-curve IVC (each side's
  step-folding circuit synthesized once, in capture mode), the zero step
  (a replay of those tapes), three fold steps and IVC.verify(strict=True);
- SnarkStar batch 1 (workloads/snarkstar.run): k=19, real keys of 2^23
  (BN254) and 2^24 (Grumpkin) points, real Groth16 proofs of a
  1000-constraint circuit folded with real pairing Gt cross terms, two fold
  steps and verify(strict=True), which includes the real-pairing Gt decider;
- SnarkStar batch 2: k=20, real keys of 2^24 points on both curves (batch
  1's 2^23 BN254 key is the first rows of the 2^24 one), two real proofs a
  batch, one fold step and verify(strict=True), its tables and fixed-base
  MSMs held to their plain versions at its shapes and the fold evaluator on
  row ranges of its 2^20 rows;
- TensorStar (workloads/tensorstar.run): k=22, the zkml shape on the
  secondary side (23 G1, 2 G2, Gt degree 3, 12 Gt cross terms), mock keys
  of 2^26 points as the reference's default, one fold step and
  verify(strict=True), then the fold evaluator held to its plain version on
  row ranges of both step-folding circuits' 2^22 rows (the last rows among
  them).  It runs in a worker process from the start (its host work, a
  k=22 step-folding circuit synthesized in Python, runs beside the build
  and the small checks; its lines start with "[tensorstar] "), and the main
  process waits for it before it times any kernel; SnarkStar batch 2 runs
  in that process once its keys are made and the main process's kernel
  timings are done (its lines start with "[snarkstar b2] "), and the kernel
  times at both SnarkStar batches' shapes are taken at the end, each
  process's while the other waits, so that no kernel time is taken while
  the other process uses the card;
- the IVC checkpoint: the k=17 IVC saved before its last fold step,
  IVC.resume from the file into a new IVC that folds that step to the
  uninterrupted IVC's accumulators and passes verify(strict=True);
- the Merkle CLI (workloads/merkle.run): k=17, mock keys, one fold step,
  verify(strict=True).

Then three paths of the polynomial and hashing side, each at full size:

- the NTT (ops/ntt.py): random vectors over BN254 Fr at n = 2^16, 2^20 and
  2^24 through the four-step kernel and, up to 2^20, the per-stage kernel,
  against the plain version (2^24: round trips, coset round trips and spot
  values of a sparse input against a host evaluation); each size also by
  device time (`device_ms`) and, below 2^21, on the four-step kernel's
  other cut, and both engines by device time around the size where "auto"
  switches;
- the batched Poseidon sponge (ops/poseidon_device.py): 2-to-1 hashes of
  2^16 and 2^20 random pairs against the plain version and the host sponge,
  and a Merkle tree of 2^20 leaves reduced level by level on the card, each
  level also alone (hashes, the route the rule took, event and device
  time);
- ProtoGalaxy (nifs/protogalaxy.py) at k=17: satisfying traces of the
  k=17 path's primary step-folding circuit, made with its 2^21 key (three
  per fold: ProtoGalaxy needs L + 1 a power of two), folded into a new
  accumulator and then again onto the result, its gates evaluated by the
  fold evaluator kernel; each fold counts
  only if the verifier's (betas', e, U) equal the prover's and the folded
  trace satisfies F(betas', 0)(0) == e'.

Then the multi-device side (mira_tpu_torch/parallel/) and the other
generic-base MSM engines (kernels 4-7):

- the generic-base engines against their plain versions and the host MSM
  at a few hundred points on both curves, and timed at the mesh path's
  widths on BN254: 2^17 (the cross-term width; against one result of the
  bucket MSM's plain version) and 2^21 (the SPS commit width; against the
  bucket kernel and the host MSM); each also per phase (its C calls:
  kernels 4-6 table, recode, accumulate, finish; kernel 7 kernel 1's sort,
  accumulate, reduce, finish), with the peak scratch of a call, kernel 7
  also on kernel 4's route beside its own; kernels 4 and 5 at 2^21 in
  chunks of 2^18, 2^19 and 2^20 bases, and against the host MSM at one
  base either side of their chunk and at three chunks;
- the k=17 path's decider, verify(strict=True), once per engine of
  kernels 5-7 (CommitmentKey.generic_method), so that each engine's kernel,
  and no other MSM kernel, makes the decider's commitments;
- the mesh path: a second IVC of the k=17 path's public parameters runs two
  fold_step(mesh=...) on a mesh of one (NCCL, world 1), every commit a
  sharded MSM through kernel 4 and the cross terms of the rank's row range
  through the fold evaluator kernel;
  after each step both sides' accumulators must equal the single-device
  IVC's after the same step, and then verify(strict=True);
- dryrun_multichip(1, "cuda") (parallel/dryrun.py): row-sharded fold and
  evaluation, the distributed NTT (also at 2^20) == ntt, the sharded MSM ==
  the host MSM, and a k=9 VanillaFS fold with the mesh == without.

The two MSMs of the main path, kernels 1 and 3, are also held to their
plain versions and the host MSM on the edge cases of kernel 1's sorted
layout (all-equal, zero and small scalars, r - 1, duplicate and opposite
bases, identity lanes) at N = 1, 2, 255, and so are kernels 4 and 5, also
in chunks of 128 bases at 127, 128, 129 and 384 bases with digit 16 and its
carry (those plain versions run on the CPU in worker processes beside the
other checks).  Kernels 1 and 3 are timed per phase (their C calls: sort or
recode, accumulate, reduce, finish); kernel 1 also at 2^21.  The table
build (kernel 3b) is held to its plain version at N = 1, 2, 255 and at a
width of three blocks and five lanes whose blocks hold no, one and only
identity lanes; the fold evaluator (kernel 2) on every row and on row
ranges (ends off the block, one row, the last rows); kernel 8 on both of
its cuts and on a batch, and kernel 10 on both of its routes forced and on
either side of the rule's crossover.  Where a copy of the previous sources
(commit 8680e54) lies at PREV_CSRC (git-ignored), their design of kernels 8
and 10 is built beside this tree's and timed in turns with it at every
shape of the NTT and Poseidon paths, each level of the tree included.

Kernel launches are counted over each path, in the process that runs it.
The keys of the IVC paths come from one background thread started before
the build (the native keygen releases the GIL): the k=17 path's 2^21 keys
while the build, the small checks and the NTT and Poseidon paths run, then
SnarkStar's 2^24 keys, which grow from them by their new rows alone, while
the k=17 path runs.
With --profile DIR it runs one more k=17 fold step and one more mesh fold
step under torch.profiler and prints the device's busy share of each step
and its ops by device time and by host time.

Prints the device lines, per-phase seconds, the milliseconds each kernel
loses to its bound over all paths and over the main path alone, one JSON
line of kernels, the card's name and power limit, and last a JSON line
{"ok": true, "device": ...}.  Any failed phase raises and the script exits non-zero.  It exits
non-zero without a result when no CUDA device is visible or when run
outside a checkout of the repository.
"""

import contextlib
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

K = 17
FOLD_STEPS = 3
SEED = 20261016
NTT_SIZES = (16, 20, 24)  # log n of the NTT path
NTT_SWITCH_SIZES = (2, 3, 4, 5, 6, 7, 8, 10, 12, 14)  # log n where both engines are timed
NTT_PLAIN_MAX = 20  # the largest of them that the plain version also runs
POSEIDON_SIZES = (16, 20)  # log N of the Poseidon path; the last also the tree
PG_NTT_SIZE = 16  # ProtoGalaxy's coset transforms at the k=17 path's fold
POSEIDON_ROUTE_TIMED = 16  # tree levels of up to 2^16 hashes timed on both routes
# Incoming traces of each ProtoGalaxy fold.  L + 1 must be a power of two:
# with L = 2 the fold domain has a fourth point where every Lagrange weight
# of the folded witness vanishes, and a gate with a constant term (the main
# gate's) does not vanish there, so Z would not divide G - F(alpha) L_0.
PG_TRACES = 3
# the kernels the two IVC paths run
MSM_PATH_KERNELS = ("msm_bucket", "msm_fixed", "fixed_table", "fold_eval")
MESH_STEPS = 2  # fold_step(mesh=...) of the mesh path
# the generic-base engines of ops/msm.py `msm` besides the bucket MSM: the
# kernel's name in the counts, its source and the TPU kernel it replaces
ENGINES = {
    "pippenger": ("msm_pippenger", "msm_pippenger.cu", "mira_tpu/ops/pallas_msm.py:486"),
    "pippenger-u4": ("msm_pippenger_u4", "msm_pippenger.cu",
                     "mira_tpu/ops/pallas_msm.py:282"),
    "window": ("msm_window", "msm_pippenger.cu", "mira_tpu/ops/pallas_msm.py:108"),
    "lane": ("msm_lane", "msm_bucket.cu", "mira_tpu/ops/pallas_msm.py:862"),
}
PIPPENGER_METHODS = ("pippenger", "pippenger-u4")
ENGINE_REPS = {"pippenger": 5, "pippenger-u4": 5, "window": 5, "lane": 5}
# kernels 4-6 run the code of kernels 3b and 3 over chunks of bases (kernel
# 6 as kernel 5 does), kernel 7 kernel 1's over parts of them
PIPPENGER_SOURCES = ["mira_tpu_torch/csrc/msm_pippenger.cu",
                     "mira_tpu_torch/csrc/fixed_table.cu",
                     "mira_tpu_torch/csrc/msm_fixed.cu",
                     "mira_tpu_torch/csrc/msm_common.cuh"]
ENGINE_SOURCES = {"pippenger": PIPPENGER_SOURCES, "pippenger-u4": PIPPENGER_SOURCES,
                  "window": PIPPENGER_SOURCES,
                  "lane": ["mira_tpu_torch/csrc/msm_bucket.cu",
                           "mira_tpu_torch/csrc/msm_common.cuh"]}
PIPPENGER_CHUNKS = (1 << 18, 1 << 19, 1 << 20)  # chunk sizes timed at 2^21
# kernels 4 and 5's edge cases in chunks of this many bases (their plain
# versions run on the CPU): one base either side of a chunk, three chunks
PIPPENGER_EDGE_CHUNK = 128
PIPPENGER_EDGE_WIDTHS = (127, 128, 129, 384)
# the engines whose path is the k=17 decider (kernel 4's is the mesh path)
DECIDER_ENGINES = ("pippenger-u4", "window", "lane")

# The card's published peaks, against which each kernel's bound is stated
# (NVIDIA H100 SXM data sheet): device-memory bytes per second, and int32
# multiply-adds per second, taken as a quarter of the 67 TFLOP/s float32
# figure (64 INT32 lanes per SM against 128 FP32 lanes at 2 flops per FMA).
MEM_BYTES_PER_S = 3.35e12
SLEEP_CYCLES_PER_S = 2.0e9  # above the card's clock, so a sleep lasts at least its time
INT32_MAD_PER_S = 16.75e12
# One CIOS Montgomery product of csrc/field.cuh: 8 x (8 + 8 + 1) = 136
# 32x32->64-bit multiply-adds, two int32 mad (lo, hi) each.
MADS_PER_PRODUCT = 272
MADD_PRODUCTS = 10  # field products of one mixed XYZZ addition (xyzz_madd)
ADD_PRODUCTS = 14  # of one full XYZZ addition (xyzz_add)
JAC_ADD_PRODUCTS = 16  # of one Jacobian addition (jac_add)
SNARK_STEPS = 2  # the reference's slow test runs 2, its bench 4
SNARK_B2_STEPS = 1  # SnarkStar batch 2's fold steps
SNARK_CONSTRAINTS = 1000
TS_STEPS = 1  # TensorStar's fold steps (repeat_count)
TS_MATRIX_DIM = 32  # the zkml ladder's smallest matrix: k = 22


def log(msg: str):
    print(msg, flush=True)


class _Prefixed:
    """A text stream that starts every line written to `stream` with
    `prefix` (the TensorStar process's lines among the main process's)."""

    def __init__(self, stream, prefix: str):
        self.stream, self.prefix, self.at_start = stream, prefix, True

    def write(self, text: str) -> int:
        for piece in text.splitlines(keepends=True):
            if self.at_start:
                self.stream.write(self.prefix)
            self.stream.write(piece)
            self.at_start = piece.endswith("\n")
        return len(text)

    def flush(self):
        self.stream.flush()


_B2 = {}  # the worker's SnarkStar batch 2 kernel times, left for a later job


def _worker_init(built):
    """The worker process's set-up: its first kernel call waits until the
    main process has built the kernel library (`built` set), then loads the
    same file, so that TensorStar's host work runs beside the build."""
    from mira_tpu_torch import _build

    build = _build.lib

    def lib_after_build():
        built.wait()
        return build()

    _build.lib = lib_after_build


def snarkstar_b2_worker(seed: int, seen) -> dict:
    """SnarkStar batch 2 (`run_snarkstar`) in the worker process, once its
    keys are made: then its tables and fixed-base MSMs held to their plain
    versions at each (lanes, window) it built that is not in `seen` (shapes
    the main process checked before), and the fold evaluator on row ranges
    of its 2^20 rows.  The kernel times at those shapes are left to
    `snarkstar_b2_times`, which the main process asks for once the card is
    its alone.  Its lines start with "[snarkstar b2] ".  Returns its launch
    counts, phase seconds and the fold evaluator's check entries."""
    import numpy as np
    import torch

    sys.stdout = _Prefixed(sys.__stdout__, "[snarkstar b2] ")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    counts, report = run_snarkstar(torch, dev, 2, SNARK_B2_STEPS)
    t0 = time.perf_counter()
    pp = report.pop("ivc").pp
    msm_at, tab_at, fe_at, pending = [], [], [], []
    for side in (pp.primary, pp.secondary):
        name = side.ck.curve.name
        shapes = [sh for sh in report["tables"][name] if (name, *sh) not in seen]
        m, t = fixed_checks(torch, dev, rng, side.ck, shapes, "snarkstar_b2",
                            defer=pending)
        msm_at += m
        tab_at += t
        nrow = 1 << side.S.k
        check_fold_eval(torch, dev, rng, side.S, ranges=[
            (nrow // 8 + 3, nrow // 2 + 1), (nrow - nrow // 5 - 1, nrow)])
        fe_at.append({"path": "snarkstar_b2", "curve": name, "nrow": nrow,
                      "rows": "ranges", "max_abs_err": 0})
    _B2.update(msm_fixed=msm_at, fixed_table=tab_at, pending=pending)
    phase("snarkstar_b2_kernel_checks", t0)
    return {"counts": counts, "secs": report, "fold_eval": fe_at}


def snarkstar_b2_times() -> dict:
    """The kernel times that `snarkstar_b2_worker` left, taken while the
    main process waits; returns its msm_fixed and fixed_table entries."""
    t0 = time.perf_counter()
    for times in _B2.pop("pending"):
        times()
    phase("snarkstar_b2_kernel_times", t0)
    return {"msm_fixed": _B2.pop("msm_fixed"), "fixed_table": _B2.pop("fixed_table")}


def tensorstar_worker(seed: int) -> dict:
    """The TensorStar path (`run_tensorstar`) in the worker process, from
    the start of the script: its host work (a k=22 step-folding circuit
    synthesized in Python, its tape prepared and replayed) runs beside the
    main process's build and small checks, which time no kernel, and the
    main process waits for its result before its first timing.  Its lines
    start with "[tensorstar] ".  Returns its launch counts, phase seconds
    and the process's peak resident host memory."""
    import resource

    import numpy as np
    import torch

    sys.stdout = _Prefixed(sys.__stdout__, "[tensorstar] ")
    counts, secs = run_tensorstar(torch, torch.device("cuda", 0),
                                  np.random.default_rng(seed))
    secs["host_peak_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"tensorstar process peak resident host memory: "
        f"{secs['host_peak_bytes'] / 2**30:.3f} GiB")
    return {"counts": counts, "secs": secs}


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


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of `fn`: CUDA events around `reps` calls
    queued behind a sleep on the card that outlasts twice their queueing, so
    that the card runs them back to back and never waits for the host (the
    event time of `timed_cuda` on a busy host includes such waits).
    torch.profiler's kernel records, tried first on the card's machine,
    lost launches, once all of a window's."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queueing = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * queueing + 1e-3) * SLEEP_CYCLES_PER_S))
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


def bound(nbytes: float, products: float) -> dict:
    """The least time the card could take: the larger of `nbytes` (each input
    read once, each output written once) over the memory rate and `products`
    Montgomery products over the int32 multiply-add rate, in milliseconds,
    and which of the two it is."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = products * MADS_PER_PRODUCT / INT32_MAD_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": by}


def msm_generic_products(n: int, curve) -> int:
    """Montgomery products a generic-base MSM of n points needs, whatever its
    design: the fewest over window widths c = 2..20 of a signed c-bit
    Pippenger, num_windows(bits, c) x (a mixed addition per point into its
    bucket and two full additions per bucket in the running sum)."""
    from mira_tpu_torch.ops.msm import num_windows

    bits = curve.scalar_modulus.bit_length()
    return min(num_windows(bits, c) * (n * MADD_PRODUCTS
                                       + 2 * (1 << (c - 1)) * ADD_PRODUCTS)
               for c in range(2, 21))


def msm_bucket_bound(n: int, curve) -> dict:
    """The bound of kernels 1 and 4-7 (one function): `msm_generic_products`
    and the bases and scalars read once.  How a kernel sorts, splits and
    reduces is its own cost and is not counted."""
    return bound(n * 4 * 32 + 96, msm_generic_products(n, curve))


def msm_fixed_bound(n: int, window: int, curve) -> dict:
    """What a fixed-base signed-digit MSM needs: one table lookup (64 B of
    the 2^(w-1) entries per lane, each counted once) and one mixed addition
    per point and window.  The kernel's per-block partial sums are its own
    cost and are not counted."""
    from mira_tpu_torch.ops.msm import num_windows

    nwin = num_windows(curve.scalar_modulus.bit_length(), window)
    products = nwin * n * MADD_PRODUCTS
    return bound(n * 32 + n * (1 << (window - 1)) * 64 + 96, products)


def timed_phases(torch, phases, reps: int) -> dict:
    """Milliseconds of each phase of a kernel split into its C calls
    (ops/cuda_msm.py `bucket_phases`, `fixed_phases`, `pippenger_phases`):
    CUDA events between the calls, the mean over `reps` runs after one warm
    run; a phase named more than once (one per chunk of bases) is summed."""
    from mira_tpu_torch import _build

    def run_all(marks):
        for i, (name, call) in enumerate(phases):
            _build.check(call(), name)
            if marks:
                marks[i + 1].record()

    run_all(None)
    runs = []
    torch.cuda.synchronize()
    for _ in range(reps):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(phases) + 1)]
        marks[0].record()
        run_all(marks)
        runs.append(marks)
    torch.cuda.synchronize()
    out = {}
    for i, (name, _) in enumerate(phases):
        out[name] = out.get(name, 0.0) + sum(
            m[i].elapsed_time(m[i + 1]) for m in runs) / reps
    return out


def peak_bytes(torch, fn) -> int:
    """Device bytes that one call of `fn` allocates at its peak, beyond
    what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


# The previous designs of kernels 8 and 10 (commit 8680e54: csrc/ntt_fourstep.cu,
# one column a block through the bit reversal and a barrier per radix-2
# stage, the mid twiddle as two table products; csrc/poseidon.cu, a thread
# per hash alone), for a paired timing where a copy of their sources lies in
# the repository's ignored build directory: unpack
# `git archive 8680e54 mira_tpu_torch/csrc` into mira_tpu_torch/build/prev.
PREV_CSRC = os.path.join("mira_tpu_torch", "build", "prev", "mira_tpu_torch", "csrc")
PREV_COMMIT = "8680e54"
PREV_SOURCES = ("ntt_fourstep.cu", "poseidon.cu")


def prev_kernels(root: str):
    """{"ntt_fourstep": fn(a, modulus, inverse=False), "poseidon": fn(values,
    modulus)} of the previous sources under PREV_CSRC, built by nvcc into
    their own library, or None when that copy is absent.  Their C interfaces
    as they were: the four-step's two kernels over its own tables (twiddles
    of both sub-transforms, the mid twiddle's two power tables) with a
    scratch and an output buffer; the sponge with no route."""
    import ctypes

    import torch

    from mira_tpu_torch import _build
    from mira_tpu_torch.fields.limbs import NUM_WORDS
    from mira_tpu_torch.ops import cuda_ntt, cuda_poseidon, ntt

    src = os.path.join(root, PREV_CSRC)
    if not os.path.isdir(src):
        return None
    so = os.path.join(_build.BUILD, "libprev_ntt_poseidon.so")
    if not os.path.exists(so):
        os.makedirs(_build.BUILD, exist_ok=True)
        report = _build._build(so, [os.path.join(src, f) for f in PREV_SOURCES])
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  previous ptxas: {line.strip()}")
    lib = ctypes.CDLL(so)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.mira_ntt_fourstep.argtypes = [I_, P_, P_, P_, I_, P_, P_, P_, P_, P_, I_, P_]
    lib.mira_poseidon.argtypes = [I_, P_, P_, I_, I_, I_, I_, I_, P_, I_, P_]
    lib.mira_ntt_fourstep.restype = lib.mira_poseidon.restype = I_
    tables = {}

    def fourstep(a, modulus, inverse=False):
        n, dev = a.shape[-2], a.device
        log_n = n.bit_length() - 1
        key = (modulus, log_n, inverse, str(dev))
        if key not in tables:
            l1 = log_n // 2
            l2 = log_n - l1
            w = ntt.get_omega(modulus, log_n, inverse)
            tables[key] = tuple(t.contiguous() for t in (
                ntt._twiddle_table(modulus, l2, inverse, str(dev)),
                ntt._twiddle_table(modulus, l1, inverse, str(dev)),
                ntt.power_table(modulus, w, 1 << l2, dev),
                ntt.power_table(modulus, pow(w, 1 << l2, modulus), 1 << l1, dev)))
        tw1, tw2, mid_a, mid_b = tables[key]
        scale = cuda_ntt._scale(modulus, n, str(dev)) if inverse else None
        tmp, out = torch.empty_like(a), torch.empty_like(a)
        ptr = torch.Tensor.data_ptr
        _build.check(lib.mira_ntt_fourstep(
            _build.field_id(modulus), ptr(a), ptr(tmp), ptr(out), log_n, ptr(tw1),
            ptr(tw2), ptr(mid_a), ptr(mid_b), None if scale is None else ptr(scale),
            a.shape[0] if a.dim() == 3 else 1, _build.stream_ptr(dev)),
            "previous ntt_fourstep")
        return out

    def poseidon(values, modulus, t=3, rate=2, r_f=10, r_p=10):
        n, length, dev = values.shape[0], values.shape[1], values.device
        consts = cuda_poseidon._constants(modulus, t, rate, r_f, r_p, str(dev))
        out = torch.empty(n, NUM_WORDS, dtype=torch.int32, device=dev)
        _build.check(lib.mira_poseidon(
            _build.field_id(modulus), values.data_ptr(), out.data_ptr(), n,
            length, t, r_f, r_p, consts.data_ptr(), consts.shape[0],
            _build.stream_ptr(dev)), "previous poseidon")
        return out

    return {"ntt_fourstep": fourstep, "poseidon": poseidon}


def fixed_table_products(n: int, window: int, curve) -> dict:
    """Montgomery products the table of affine multiples needs, by the two
    routes to it: {"jacobian": the Jacobian chain (an affine doubling, 6;
    2^(w-1) - 2 mixed additions, 11; the walk back to affine, 5 an entry
    but 4 for 2P; 3 a lane for its share of one inversion batched across
    all lanes), "affine": the affine chain (an affine doubling, 4, and
    2^(w-1) - 2 affine additions, 3, each with 3 for its share of one
    batched inversion per multiple)}, each with its inversions (a square
    per bit of p - 2 and a product per set bit)."""
    ntab = 1 << (window - 1)
    e = curve.base_modulus - 2
    inv = e.bit_length() + bin(e).count("1")
    return {"jacobian": n * (6 + 11 * (ntab - 2) + 5 * (ntab - 1) - 1 + 3) + inv,
            "affine": n * (7 + 6 * (ntab - 2)) + (ntab - 1) * inv}


def fixed_table_route_bounds(n: int, window: int, curve) -> dict:
    """The bound of each of `fixed_table_products`' two routes, in ms: the
    table's inputs and output once, and that route's products."""
    nbytes = n * 3 * 32 + n * (1 << (window - 1)) * 64
    return {k: bound(nbytes, v) for k, v in
            fixed_table_products(n, window, curve).items()}


def fixed_table_bound(n: int, window: int, curve) -> dict:
    """The table's bound: the lesser of `fixed_table_route_bounds`' two (the
    affine chain, for w = 5 and 6), its route named in `bound_route`."""
    routes = fixed_table_route_bounds(n, window, curve)
    route = min(routes, key=lambda k: routes[k]["bound_ms"])
    return {**routes[route], "bound_route": route}


def fold_eval_bound(ops, n_static: int, n_advice: int, nrow: int, n_j: int) -> dict:
    """csrc/fold_eval.cu per row and fold point: one product per MUL op and
    one per folded advice load; the static and advice columns read once,
    one output row per fold point."""
    from mira_tpu_torch.polynomial import fold_evaluator as fe

    products = sum(1 for op in ops if op[0] in (fe.OP_MUL, fe.OP_LOAD_FOLD))
    nbytes = (n_static + 2 * n_advice + n_j) * nrow * 32
    return bound(nbytes, products * nrow * n_j)


def ntt_products(log_n: int) -> int:
    """Montgomery products a size-2^log_n radix-2 transform needs: one per
    butterfly.  The four-step kernel's mid twiddles are its own cost and are
    not counted, so both engines are held to the same bound."""
    return (1 << log_n) // 2 * log_n


def poseidon_products(t: int, r_f: int, r_p: int, length: int) -> int:
    """Montgomery products of one fixed-length sponge: per permutation r_f
    full rounds (3 t for the S-boxes, t^2 for the matrix) and r_p partial
    rounds (3 + t + (t - 1))."""
    rate = t - 1
    perms = -(-length // rate) + (1 if length % rate == 0 else 0)
    return perms * (r_f * (3 * t + t * t) + r_p * (3 + t + t - 1))


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
    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN

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
    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN

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


LAYOUT_CASES = ("all_equal", "all_zero", "below_2c", "r_minus_1",
                "dup_opposite", "identity_lanes")
LAYOUT_WORKERS = 3  # CPU processes computing the layout cases' plain versions


def layout_case(curve, n, case, rng):
    """tests/test_torch_msm_layout.py's edge cases of kernel 1's layout at
    width n: all-equal scalars (one bucket per window holds every point),
    all zero, scalars below 2^c, r - 1, duplicate and opposite bases with
    equal scalars, identity lanes."""
    import random

    from mira_tpu_torch.curves.torch_curve import AffinePoint
    from mira_tpu_torch.ops.msm import bucket_window

    r = curve.scalar_modulus
    pr = random.Random(int(rng.integers(1 << 30)))
    base = [AffinePoint.random(curve, pr) for _ in range(5)]
    pts = [base[i % 5] for i in range(n)]
    sc = [pr.randrange(r) for _ in range(n)]
    if case == "all_equal":
        sc = [sc[0]] * n
    elif case == "all_zero":
        sc = [0] * n
    elif case == "below_2c":
        sc = [v % (1 << bucket_window(n)) for v in sc]
    elif case == "r_minus_1":
        sc = [r - 1] * n
    elif case == "dup_opposite":
        pts = [base[(i // 2) % 5].neg() if i % 4 == 1 else base[(i // 2) % 5]
               for i in range(n)]
        sc = [sc[i - i % 2] for i in range(n)]
    elif case == "identity_lanes":
        pts = [AffinePoint.identity(curve) if i % 3 == 0 else p
               for i, p in enumerate(pts)]
    return sc, pts


def layout_plain(curve_name: str, n: int, seeds: dict) -> dict:
    """The plain side of `check_msm_layout_cases` for one curve and width,
    on the CPU, in a worker process: per case (its inputs from
    `layout_case` with the case's seed) the host MSM, the bucket MSM's plain
    version, and at each window the plain table (words) and the fixed-base
    MSM's plain version over it."""
    import numpy as np
    import torch

    from mira_tpu_torch.convert import msm_reference
    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN
    from mira_tpu_torch.curves.torch_curve import jacobian_ops
    from mira_tpu_torch.ops.cuda_msm import FIXED_WINDOWS
    from mira_tpu_torch.ops.msm import (
        encode_scalars,
        msm_fixed_plain,
        msm_plain,
        precompute_fixed_table_plain,
    )

    torch.set_num_threads(1)
    curve = {"bn254": BN254_G1, "grumpkin": GRUMPKIN}[curve_name]
    ops = jacobian_ops(curve_name)
    out = {}
    for case, seed in seeds.items():
        sc, pts = layout_case(curve, n, case, np.random.default_rng(seed))
        s = encode_scalars(sc, curve.scalar_modulus)
        P = ops.encode_points(pts)
        res = {"host": point_ints(msm_reference(s, P, curve)),
               "bucket": point_ints(decode_one(curve, msm_plain(s, P, curve)))}
        for window in FIXED_WINDOWS:
            tab = precompute_fixed_table_plain(P, curve, window)
            res[window] = (tab.numpy(), point_ints(decode_one(
                curve, msm_fixed_plain(s, tab, curve, window))))
        out[case] = res
    return out


def submit_layout_plain(pool, rng) -> dict:
    """`layout_plain` for each curve and width N = 1, 2, 255 on `pool`:
    {(curve name, n): (seeds by case, async result)}."""
    jobs = {}
    for curve_name in ("bn254", "grumpkin"):
        for n in (255, 2, 1):
            seeds = {case: int(rng.integers(1 << 30)) for case in LAYOUT_CASES}
            jobs[(curve_name, n)] = (seeds, pool.apply_async(
                layout_plain, (curve_name, n, seeds)))
    return jobs


def check_msm_layout_cases(torch, dev, jobs):
    """Kernels 1, 3 (both windows) and 3b against their plain versions and
    the host MSM at N = 1, 2 and 255 on both curves, on the layout's edge
    cases.  The plain versions, launch-bound at these widths, run on the
    CPU in worker processes (`submit_layout_plain`) while the other checks
    run here, on the same inputs.  Returns the largest |kernel - plain|
    over them (0)."""
    import numpy as np

    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN
    from mira_tpu_torch.curves.torch_curve import jacobian_ops
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.ops.msm import encode_scalars

    err = 0
    for (curve_name, n), (seeds, job) in jobs.items():
        curve = {"bn254": BN254_G1, "grumpkin": GRUMPKIN}[curve_name]
        ops = jacobian_ops(curve_name)
        plain = job.get()
        for case, seed in seeds.items():
            want = plain[case]
            sc, pts = layout_case(curve, n, case, np.random.default_rng(seed))
            s = encode_scalars(sc, curve.scalar_modulus, dev)
            P = ops.encode_points(pts, dev)
            got = point_ints(decode_one(curve, cuda_msm.msm_cuda(s, P, curve)))
            err = max(err, max_abs_err(got, want["bucket"]))
            if not got == want["bucket"] == want["host"]:
                raise AssertionError(f"msm_bucket {case} n={n} on {curve.name}")
            for window in cuda_msm.FIXED_WINDOWS:
                tab = cuda_msm.fixed_table_cuda(P, curve, window)
                plain_tab, plain_msm = want[window]
                got = point_ints(decode_one(
                    curve, cuda_msm.msm_fixed_cuda(s, tab, curve, window)))
                e = max(words_err(tab.cpu(), torch.from_numpy(plain_tab)),
                        max_abs_err(got, plain_msm))
                err = max(err, e)
                if e or not got == want["host"]:
                    raise AssertionError(f"fixed_table or msm_fixed {case} n={n} "
                                         f"w={window} on {curve.name}")
    log(f"msm_bucket, fixed_table, msm_fixed (w = 5, 6) at n = 1, 2, 255 on "
        f"{list(LAYOUT_CASES)}: kernel == plain (on the CPU) == host on both "
        "curves (exact)")
    return err


def pippenger_border_input(curve, n, rng):
    """Kernels 4 and 5's input at a chunk border: `adversarial_input` (bases
    repeated, an identity lane last) with scalars 0, 1, r - 1, 16 (signed
    digit -16 with a carry), 16 in every 5-bit window and 2^250 - 1, and an
    opposite pair split between the two halves."""
    sc, pts = adversarial_input(curve, n, rng)
    r = curve.scalar_modulus
    every = sum(16 << (5 * k) for k in range(50)) % r
    sc[:6] = [0, 1, r - 1, 16, every, (1 << 250) - 1]
    pts[n // 2] = pts[1].neg()
    return sc, pts


def pippenger_input(curve, n, case, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    if case == "border":
        return pippenger_border_input(curve, n, rng)
    return layout_case(curve, n, case, rng)


def pippenger_plain(curve_name: str, n: int, case: str, seed: int) -> dict:
    """The plain side of `check_pippenger_edges` for one input, on the CPU
    in a worker process: the host MSM and the plain versions of kernels 4
    (True) and 5 (False)."""
    import torch

    from mira_tpu_torch.convert import msm_reference
    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN
    from mira_tpu_torch.curves.torch_curve import jacobian_ops
    from mira_tpu_torch.ops.msm import encode_scalars, msm_pippenger_plain

    torch.set_num_threads(1)
    curve = {"bn254": BN254_G1, "grumpkin": GRUMPKIN}[curve_name]
    sc, pts = pippenger_input(curve, n, case, seed)
    s = encode_scalars(sc, curve.scalar_modulus)
    P = jacobian_ops(curve_name).encode_points(pts)
    out = {"host": point_ints(msm_reference(s, P, curve))}
    for signed in (True, False):
        out[signed] = point_ints(decode_one(curve, msm_pippenger_plain(s, P, curve,
                                                                      signed)))
    return out


def submit_pippenger_plain(pool, rng) -> dict:
    """`pippenger_plain` on `pool` for each curve: the layout's edge cases at
    N = 1, 2, 255, and `pippenger_border_input` at PIPPENGER_EDGE_WIDTHS.
    {(curve name, n, case): (seed, async result)}."""
    jobs = {}
    for curve_name in ("bn254", "grumpkin"):
        inputs = [(n, case) for n in (255, 2, 1) for case in LAYOUT_CASES]
        inputs += [(n, "border") for n in PIPPENGER_EDGE_WIDTHS]
        for n, case in inputs:
            seed = int(rng.integers(1 << 30))
            jobs[(curve_name, n, case)] = (seed, pool.apply_async(
                pippenger_plain, (curve_name, n, case, seed)))
    return jobs


def check_pippenger_edges(torch, dev, jobs):
    """Kernels 4 and 5 against their plain versions (computed on the CPU by
    `submit_pippenger_plain`, on the same inputs) and the host MSM: the
    layout's edge cases (identity lanes, duplicate and opposite bases, zero
    scalars, r - 1) at N = 1, 2, 255 in one chunk, and in chunks of
    PIPPENGER_EDGE_CHUNK bases one base either side of a chunk and three
    chunks, with digit 16 and its carry.  Returns the largest |kernel -
    plain| (0)."""
    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN
    from mira_tpu_torch.curves.torch_curve import jacobian_ops
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.ops.msm import encode_scalars

    err = 0
    for (curve_name, n, case), (seed, job) in jobs.items():
        curve = {"bn254": BN254_G1, "grumpkin": GRUMPKIN}[curve_name]
        want = job.get()
        sc, pts = pippenger_input(curve, n, case, seed)
        s = encode_scalars(sc, curve.scalar_modulus, dev)
        P = jacobian_ops(curve_name).encode_points(pts, dev)
        chunk = PIPPENGER_EDGE_CHUNK if case == "border" else cuda_msm.PIPPENGER_CHUNK
        for signed in (True, False):
            got = point_ints(decode_one(curve, cuda_msm.msm_pippenger_cuda(
                s, P, curve, signed, chunk)))
            e = max_abs_err(got, want[signed])
            err = max(err, e)
            if e or got != want["host"]:
                raise AssertionError(f"msm_pippenger signed={signed} {case} n={n} "
                                     f"chunk={chunk} on {curve.name}: kernel != "
                                     "plain or host")
    log(f"msm_pippenger, msm_pippenger_u4 on {list(LAYOUT_CASES)} at n = 1, 2, "
        f"255 and at n = {list(PIPPENGER_EDGE_WIDTHS)} in chunks of "
        f"{PIPPENGER_EDGE_CHUNK} (digit 16 with its carry, opposite bases across "
        "a border): kernel == plain (on the CPU) == host on both curves (exact)")
    return err


def check_pippenger_chunks(torch, dev, rng, ck, chunk):
    """Kernels 4 and 5 at `chunk` - 1, `chunk` and `chunk` + 1 bases and at
    three chunks against the host MSM, over the key's points (repeated past
    its width).  Returns the largest |kernel - host| (0)."""
    from mira_tpu_torch.convert import msm_reference
    from mira_tpu_torch.ops import cuda_msm

    curve = ck.curve
    err = 0
    for n in (chunk - 1, chunk, chunk + 1, 3 * chunk):
        keys = ck._enc_slice(min(n, len(ck)))
        idx = torch.arange(n, device=dev) % keys[0].shape[0]
        P = tuple(c[idx].contiguous() for c in keys)
        s = _random_plain(rng, n, dev)
        ref = point_ints(msm_reference(s, P, curve))
        for signed in (True, False):
            got = point_ints(decode_one(curve, cuda_msm.msm_pippenger_cuda(
                s, P, curve, signed, chunk)))
            err = max(err, max_abs_err(got, ref))
            if err:
                raise AssertionError(f"msm_pippenger signed={signed} n={n} "
                                     f"chunk={chunk}: kernel != host")
    log(f"msm_pippenger, msm_pippenger_u4 at n = {chunk - 1}, {chunk}, "
        f"{chunk + 1}, {3 * chunk} in chunks of {chunk} on {curve.name}: kernel "
        "== host (exact)")
    return err


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
    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN

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


def check_table_edges(torch, dev, rng):
    """Kernel 3b against its plain version, exactly, on both curves at w = 5
    and 6, at 3 blocks and 5 lanes of TABLE_BLOCK (a width that is not a
    multiple of the block) whose blocks hold no, one and only identity
    lanes; `check_msm_layout_cases` holds it at N = 1, 2 and 255.  Returns
    the largest |kernel - plain| (0)."""
    import random

    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN
    from mira_tpu_torch.curves.torch_curve import AffinePoint, jacobian_ops
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.ops.msm import TABLE_BLOCK, precompute_fixed_table_plain

    blk = TABLE_BLOCK
    err = 0
    for curve in (BN254_G1, GRUMPKIN):
        ops = jacobian_ops(curve.name)
        r = random.Random(int(rng.integers(1 << 30)))
        base = [AffinePoint.random(curve, r) for _ in range(9)]
        ident = AffinePoint.identity(curve)
        wide = [base[i % 9] for i in range(3 * blk + 5)]
        wide[blk + 17] = ident
        wide[2 * blk : 3 * blk] = [ident] * blk
        P = ops.encode_points(wide, dev)
        for window in cuda_msm.FIXED_WINDOWS:
            tab = cuda_msm.fixed_table_cuda(P, curve, window)
            e = words_err(tab, precompute_fixed_table_plain(P, curve, window))
            err = max(err, e)
            if e:
                raise AssertionError(f"fixed_table n={len(wide)} w={window} on "
                                     f"{curve.name}: kernel != plain")
    log(f"fixed_table at n = {3 * blk + 5} (blocks of {blk} with no, one and "
        "only identity lanes), w = 5, 6: kernel == plain on both curves (exact)")
    return err


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

    from mira_tpu_torch.ops import cuda_ntt, cuda_poseidon

    return {"msm_bucket": cuda_msm.launches, "msm_fixed": cuda_msm.fixed_launches,
            "fixed_table": cuda_msm.table_launches, "fold_eval": fe.launches,
            "ntt_fourstep": cuda_ntt.fourstep_launches,
            "ntt_stage": cuda_ntt.stage_launches,
            "poseidon": cuda_poseidon.launches,
            "msm_pippenger": cuda_msm.pippenger_launches,
            "msm_pippenger_u4": cuda_msm.pippenger_u4_launches,
            "msm_window": cuda_msm.window_launches,
            "msm_lane": cuda_msm.lane_launches}


@contextlib.contextmanager
def uncounted():
    """Launches inside are measurements added to the NTT and Poseidon paths
    (device times, the other cut, the previous design, each tree level
    alone), not the paths' own: their counts are put back as they were, so
    that the "ms lost" lines weigh the paths as before."""
    from mira_tpu_torch.ops import cuda_ntt, cuda_poseidon

    saved = (cuda_ntt.fourstep_launches, cuda_ntt.stage_launches,
             cuda_poseidon.launches)
    try:
        yield
    finally:
        (cuda_ntt.fourstep_launches, cuda_ntt.stage_launches,
         cuda_poseidon.launches) = saved


def require_launched(counts: dict, names, path: str):
    """Fail unless every kernel of `names` was launched on `path`."""
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels of {path} were not launched: {missing} "
                             f"(counts {counts})")


def reset_launch_counts():
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.polynomial import fold_evaluator as fe

    from mira_tpu_torch.ops import cuda_ntt, cuda_poseidon

    cuda_msm.launches = cuda_msm.fixed_launches = cuda_msm.table_launches = 0
    cuda_msm.pippenger_launches = cuda_msm.pippenger_u4_launches = 0
    cuda_msm.window_launches = cuda_msm.lane_launches = 0
    fe.launches = 0
    cuda_ntt.fourstep_launches = cuda_ntt.stage_launches = 0
    cuda_poseidon.launches = 0


def fixed_checks(torch, dev, rng, ck, shapes, path, defer=None):
    """`fixed_timings` at every (lanes, window) in `shapes`, the tables
    that `ck` built on `path`, over its first key points; returns the two
    lists of results (msm_fixed, fixed_table).  With `defer`, a list, the
    kernel times are appended to it as calls that fill them in later."""
    msms, tables = [], []
    for n, window in shapes:
        m, t = fixed_timings(torch, dev, rng, ck.curve,
                             ck._encode_rows(ck._limbs[:n]), window, defer=defer)
        m.update(path=path, curve=ck.curve.name)
        t.update(path=path, curve=ck.curve.name)
        msms.append(m)
        tables.append(t)
    return msms, tables


def paired(fn_new, fn_old, reps):
    """(new ms, previous ms) in turns, the previous design first and last:
    each the mean of its two timings of `reps` calls."""
    o1 = timed_cuda(fn_old, reps)
    n1 = timed_cuda(fn_new, reps)
    n2 = timed_cuda(fn_new, reps)
    o2 = timed_cuda(fn_old, reps)
    return (n1 + n2) / 2, (o1 + o2) / 2


def fixed_timings(torch, dev, rng, curve, points, window, reps=5, defer=None):
    """Kernel and plain times of the table build and of the fixed-base MSM
    over `points` at `window`, random canonical scalars, and the MSM's
    per-phase times; both kernels must equal their plain versions.  With
    `defer`, a list, the kernel times are not taken here: a call that takes
    them into the returned entries is appended to it."""
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.ops.msm import msm_fixed_plain, precompute_fixed_table_plain

    n = points[0].shape[0]
    plain_tab, tab_plain_ms = timed_once(
        lambda: precompute_fixed_table_plain(points, curve, window))
    tab = cuda_msm.fixed_table_cuda(points, curve, window)
    # both tables hold canonical words, so equal words are equal values
    tab_err = words_err(tab, plain_tab)
    if tab_err:
        raise AssertionError(f"fixed_table n={n} w={window}: kernel != plain")
    del plain_tab
    s = _random_plain(rng, n, dev)
    want, plain_ms = timed_once(lambda: msm_fixed_plain(s, tab, curve, window))
    got = point_ints(decode_one(curve, cuda_msm.msm_fixed_cuda(s, tab, curve, window)))
    err = max_abs_err(got, point_ints(decode_one(curve, want)))
    if err:
        raise AssertionError(f"msm_fixed n={n} w={window}: kernel != plain")
    del tab, want
    m = {"n": n, "window": window, "plain_ms": plain_ms, "max_abs_err": err,
         **msm_fixed_bound(n, window, curve)}
    t = {"n": n, "window": window, "plain_ms": tab_plain_ms, "max_abs_err": tab_err,
         **fixed_table_bound(n, window, curve)}

    def times():
        t["ms"] = timed_cuda(lambda: cuda_msm.fixed_table_cuda(points, curve, window),
                             reps)
        tab = cuda_msm.fixed_table_cuda(points, curve, window)
        m["ms"] = timed_cuda(lambda: cuda_msm.msm_fixed_cuda(s, tab, curve, window),
                             reps)
        m["phases_ms"] = timed_phases(
            torch, cuda_msm.fixed_phases(s, tab, curve, window)[0], reps)
        routes = {k: round(v["bound_ms"], 3)
                  for k, v in fixed_table_route_bounds(n, window, curve).items()}
        log(f"n={n} w={window} {curve.name}: fixed_table {t['ms']:.3f} ms (plain "
            f"{tab_plain_ms:.3f} ms; bound by route {json.dumps(routes)} ms), "
            f"msm_fixed {m['ms']:.3f} ms (plain {plain_ms:.3f} ms; phases "
            f"{json.dumps({k: round(v, 3) for k, v in m['phases_ms'].items()})}; a "
            f"generic-base MSM's bound {msm_bucket_bound(n, curve)['bound_ms']:.3f} ms)")

    if defer is None:
        times()
    else:
        defer.append(times)
    return m, t


def run_snarkstar(torch, dev, batch_size, steps):
    """SnarkStar at `batch_size` through workloads/snarkstar.run on the card
    (its ladder's k and keys, real Groth16 proofs), with the kernels'
    launches counted over the whole run; returns the counts and run()'s
    report."""
    import gc

    from mira_tpu_torch.utils import tracing
    from mira_tpu_torch.workloads import snarkstar

    tag = f"snarkstar batch {batch_size}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tracing.reset()
    secs = snarkstar.run(steps=steps, batch_size=batch_size, use_mock_ck=False,
                         real_proofs=True, num_constraints=SNARK_CONSTRAINTS,
                         device=dev)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag} (k={snarkstar.table_sizes(batch_size)[0]}, keys 2^"
        f"{snarkstar.ck_sizes(batch_size)}) phases (s): "
        f"{json.dumps({k: v for k, v in secs.items() if k != 'ivc'})}")
    log(f"{tag} fold steps (s): {secs['fold_steps']}; first "
        f"{secs['fold_steps'][0]:.3f} s")
    log(f"{tag} launches over the run: {counts}")
    log(f"{tag} host span tree (zero step, fold steps, decider):")
    log(tracing.report(min_runtime=0.05))
    log(f"{tag} peak device memory: {peak / 2**30:.3f} GiB")
    require_launched(counts, MSM_PATH_KERNELS, f"the {tag} path")
    return counts, secs


def run_tensorstar(torch, dev, rng):
    """TensorStar at k=22 through workloads/tensorstar.run on the card
    (matrix_dim 32, mock keys as the reference's default, TS_STEPS fold
    steps, verify(strict=True)), with the kernels' launches counted over the
    whole run; then kernel 2 held to its plain version on row ranges of both
    step-folding circuits' 2^22 rows, the last rows among them.  Returns the
    counts and run()'s report."""
    import gc

    from mira_tpu_torch.utils import tracing
    from mira_tpu_torch.workloads import tensorstar

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tracing.reset()
    secs = tensorstar.run(repeat_count=TS_STEPS, matrix_dim=TS_MATRIX_DIM,
                          device=dev)
    counts = launch_counts()
    ivc = secs.pop("ivc")
    log(f"tensorstar (k={ivc.pp.primary.k}, mock keys 2^{ivc.pp.primary.k + 4}) "
        f"phases (s): {json.dumps(secs)}")
    log(f"tensorstar launches over the run: {counts}")
    log("tensorstar host span tree (zero step, fold steps, decider):")
    log(tracing.report(min_runtime=0.5))
    log(f"tensorstar peak device memory: {secs['peak_bytes'] / 2**30:.3f} GiB")
    require_launched(counts, ("fold_eval",), "the TensorStar path")
    for S in (ivc.pp.primary.S, ivc.pp.secondary.S):
        nrow = 1 << S.k
        check_fold_eval(torch, dev, rng, S, ranges=[
            (0, 4099), (nrow // 2 - 2049, nrow // 2 + 2050), (nrow - 4099, nrow)])
    return counts, secs


def run_checkpoint(torch, dev, pp, sc1, sc2, path, want):
    """IVC.resume from the checkpoint the k=17 path saved before its last
    fold step, into a new IVC on the card, as in a new process that made
    the same public parameters: it keeps the first IVC's public parameters
    (their structures, keys and the tapes they captured, which such a
    process makes again) and nothing that a step built from them, neither
    the keys' multiples tables nor the tapes' replay caches (the packed and
    device templates, the write positions, the native VM's preparation).
    It folds that step, and its accumulators must equal the uninterrupted
    IVC's after it (`want`); then verify(strict=True).  Returns (seconds of
    each phase, launch counts)."""
    from mira_tpu_torch.ivc.ivc import IVC

    for ck in (pp.primary.ck, pp.secondary.ck):
        ck.release_device_cache()
    for captured in pp.tapes.values():
        captured.packed_template = None
        for field in ("dev_template_mont", "dev_template_vals", "dev_positions",
                      "dev_positions_np", "dev_keep", "dev_static_slots"):
            setattr(captured, field, None)
        captured.tape._native_prep = None
    reset_launch_counts()
    secs = {"file_bytes": os.path.getsize(path)}
    t0 = time.perf_counter()
    ivc = IVC.resume(pp, sc1, sc2, path)
    torch.cuda.synchronize()
    secs["load"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivc.fold_step()
    torch.cuda.synchronize()
    secs["fold_step"] = time.perf_counter() - t0
    if not same_accumulators(accumulators(ivc), want):
        raise AssertionError("the resumed IVC's accumulators differ from the "
                             "uninterrupted IVC's after the same step")
    t0 = time.perf_counter()
    ivc.verify(strict=True)
    torch.cuda.synchronize()
    secs["verify"] = time.perf_counter() - t0
    counts = launch_counts()
    log(f"checkpoint: resumed at step {ivc.step - 1} from {secs['file_bytes']} "
        f"bytes; its fold step's accumulators == the uninterrupted IVC's; "
        f"verify(strict=True) passed; seconds {json.dumps(secs)}; launches {counts}")
    require_launched(counts, MSM_PATH_KERNELS, "the checkpoint path")
    return secs, counts


def run_merkle_cli(torch, dev):
    """workloads/merkle.run on the card (k=17, one fold step, mock keys as
    the reference's default, verify(strict=True)); returns its seconds and
    the launch counts."""
    from mira_tpu_torch.workloads import merkle

    reset_launch_counts()
    t0 = time.perf_counter()
    ivc = merkle.run(steps=1, k=K, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    log(f"merkle CLI (k={K}, one fold step, mock keys): verified in {secs:.3f} s "
        f"end to end; root {ivc.primary.z_i[0]}; launches {counts}")
    require_launched(counts, ("fold_eval",), "the Merkle CLI path")
    return secs, counts


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


def check_fold_eval(torch, dev, rng, S, ranges=None):
    """Kernel vs plain on a structure's homogeneous expression, seeded
    random witness, all fold points: on every row, and on row ranges whose
    ends are not multiples of the block, of one row, and ending on the last
    row (where rotations wrap); or on `ranges` alone (None: every row).
    Returns the state the timings reuse."""
    from mira_tpu_torch import _build
    from mira_tpu_torch.polynomial import fold_evaluator as fe

    lf = S.lf
    p = S.modulus
    nrow = 1 << S.k
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
    if ranges is None:
        ranges = [None, (nrow // 8 + 3, nrow // 2 + 1), (nrow // 3, nrow // 3 + 1),
                  (nrow - nrow // 5 - 1, nrow)]
    for rows in ranges:
        got = fe.fold_eval_cuda(lf, ops_t, n_regs, ev.static_stack, w1, w2, ch, jm,
                                consts, rows)
        torch.cuda.synchronize()
        want = fe.fold_eval_plain(lf, ops, ev.static_stack, w1, w2, ch, jm, consts,
                                  rows)
        if not torch.equal(got, want):
            raise AssertionError(f"fold_eval on the k={S.k} SFC, rows {rows}: "
                                 f"kernel != plain on {(got != want).any(-1).sum()} "
                                 "entries")
    block = _build.lib().mira_fold_eval_block(n_regs, len(ops))
    log(f"fold_eval k={S.k} SFC over {S.curve.name} ({len(ops)} ops, {n_regs} "
        f"registers, {block} rows a block, "
        f"{len(js)} fold points): kernel == plain (exact) on rows "
        f"{['all' if r is None else r for r in ranges]}")
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


def _field_vals(rng, n, p):
    """n field values below p from the seeded generator, with 0, p - 1 and a
    repeated value among them."""
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    edge = [0, p - 1, 1, p - 1]
    vals[: min(n, 4)] = edge[: min(n, 4)]
    if n > 8:
        vals[7] = vals[5]
    return vals


def check_ntt_small(torch, dev, rng):
    """`ntt` on the card against `ntt_host` and `ntt_plain` for every log n
    in 1..14 over BN254 Fr (and log n = 1 over Fq, whose 2-adicity is 1), both
    engines where the size admits them, the four-step kernel also on both of
    its cuts (two and three passes) and on a batch of three, forward and
    inverse; the reference's known-answer vector (src/fft.rs:239-258); coset
    round trips."""
    from mira_tpu_torch.fields.limbs import limb_field
    from mira_tpu_torch.fields.params import BN254_FQ, BN254_FR
    from mira_tpu_torch.ops import cuda_ntt, ntt

    cases = [(BN254_FR, k) for k in range(1, 15)] + [(BN254_FQ, 1)]
    for p, log_n in cases:
        lf = limb_field(p)
        vals = _field_vals(rng, 1 << log_n, p)
        a = lf.encode(vals, dev)
        for inverse in (False, True):
            want = ntt.ntt_plain(a, p, inverse)
            if lf.decode(want) != ntt.ntt_host(vals, p, inverse):
                raise AssertionError(f"ntt_plain 2^{log_n} != ntt_host")
            engines = ["stage", "auto"]
            if log_n >= cuda_ntt.FOURSTEP_MIN_LOG:
                engines.append("fourstep")
            for engine in engines:
                got = ntt.ntt(a, p, inverse, engine=engine)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"ntt 2^{log_n} engine={engine} inverse={inverse}: "
                        f"kernel != plain on {(got != want).any(-1).sum()} rows")
            if log_n < max(cuda_ntt.FOURSTEP_MIN_LOG, 3) or p != BN254_FR:
                continue
            rows = torch.stack([a, a.flip(0), lf.sub(a, a.roll(1, 0))])
            want_rows = ntt.ntt_plain(rows, p, inverse)
            for passes in (2, 3):
                split = cuda_ntt.fourstep_split(log_n, passes)
                if not (torch.equal(cuda_ntt._fourstep(a, p, inverse, split), want)
                        and torch.equal(cuda_ntt._fourstep(rows, p, inverse, split),
                                        want_rows)):
                    raise AssertionError(f"ntt_fourstep 2^{log_n} split {split} "
                                         f"inverse={inverse}: kernel != plain")
        if log_n in (4, 9, 12, 13):
            for engine in ("stage", "fourstep"):
                back = ntt.coset_intt(ntt.coset_ntt(a, p, engine), p, engine)
                if not torch.equal(back, a):
                    raise AssertionError(f"coset round trip 2^{log_n} {engine}")
    lf = limb_field(BN254_FR)
    known = [
        28,
        68918385373930674424918168212551896122229959265833979749191472831399925654,
        17631683881184975370165255887551781615748388533673675138856,
        68918385373930639161550405842601155791718184162270748252414405484049647934,
        21888242871839275222246405745257275088548364400416034343698204186575808495613,
        21819324486465344583084855339414673932756646216253763595445789781091758847675,
        21888242871839275204614721864072299718383108512864252727949815652902133356753,
        21819324486465344547821487577044723192426134441150200363949012713744408569955,
    ]
    for engine in ("stage", "fourstep"):
        got = lf.decode(ntt.ntt(lf.encode(list(range(8)), dev), BN254_FR,
                                engine=engine))
        if got != known:
            raise AssertionError(f"ntt known-answer vector, engine={engine}")
    log("ntt_stage, ntt_fourstep at log n = 1..14 (0, p - 1, repeated values; "
        "forward, inverse, coset round trips; the known-answer vector; "
        "ntt_fourstep also on two and three passes from 2^3, one array and a "
        "batch of three): kernel == plain == host (exact)")


def host_sponge(vals, modulus, t, rate, r_f=10, r_p=10) -> int:
    """The host sponge's state[1] before bit truncation (ops/poseidon.py)."""
    from mira_tpu_torch.fields.host import field
    from mira_tpu_torch.ops.poseidon import PoseidonHash, get_spec

    F = field(modulus)
    h = PoseidonHash(get_spec(modulus, t, rate, r_f, r_p))
    h.update([F(v) for v in vals])
    buf, h.buf = h.buf, []
    for j in range(0, len(buf), rate):
        h.permutation(buf[j : j + rate])
    if len(buf) % rate == 0:
        h.permutation([])
    return h.state[1].v


def check_poseidon_small(torch, dev, rng):
    """`poseidon_hash_batch` on the card against the host sponge and the
    plain version for the (t, rate, L) cases of the reference's tests (and
    t = 2, t = 4 and an empty input), N not a multiple of the block, each
    case on both routes of kernel 10 forced; and both routes on either side
    of the rule's crossover at t = 3.  Returns the crossover's batch."""
    from mira_tpu_torch.fields.limbs import limb_field
    from mira_tpu_torch.fields.params import BN254_FQ, BN254_FR
    from mira_tpu_torch.ops import cuda_poseidon
    from mira_tpu_torch.ops.poseidon_device import (
        poseidon_hash_batch,
        poseidon_hash_batch_plain,
    )

    n = 131
    cases = [(BN254_FR, 3, 2, 2), (BN254_FR, 3, 2, 3), (BN254_FR, 5, 4, 4),
             (BN254_FR, 5, 4, 6), (BN254_FR, 2, 1, 1), (BN254_FR, 3, 2, 0),
             (BN254_FR, 4, 3, 7), (BN254_FQ, 5, 4, 6)]
    for p, t, rate, length in cases:
        lf = limb_field(p)
        vals = [_field_vals(rng, length, p) if i else [p - 1] * length
                for i in range(n)]
        flat = lf.encode([v for row in vals for v in row], dev).reshape(
            n, length, 8)
        got = poseidon_hash_batch(flat, p, t=t, rate=rate)
        torch.cuda.synchronize()
        want = poseidon_hash_batch_plain(flat, p, t=t, rate=rate)
        if not torch.equal(got, want):
            raise AssertionError(f"poseidon t={t} L={length}: kernel != plain")
        for route in cuda_poseidon.ROUTES:
            if not torch.equal(cuda_poseidon._launch(flat, p, t, rate, 10, 10, route),
                               want):
                raise AssertionError(f"poseidon t={t} L={length} route={route}: "
                                     "kernel != plain")
        host = [host_sponge(v, p, t, rate) for v in vals[:8]]
        if lf.decode(got[:8]) != host:
            raise AssertionError(f"poseidon t={t} L={length}: kernel != host")
    p = BN254_FR
    lf = limb_field(p)
    sms = cuda_poseidon.card_sms(str(dev))
    cross = cuda_poseidon.LANE_THREADS_PER_SM * sms // cuda_poseidon.lanes_per_hash(3)
    if [cuda_poseidon.poseidon_route(m, 3, sms) for m in (cross, cross + 1)] != [
            "lanes", "thread"]:
        raise AssertionError("poseidon: the rule's crossover is not where expected")
    for m in (cross, cross + 1):
        flat = lf.from_plain(_random_plain(rng, 2 * m, dev)).reshape(m, 2, 8)
        want = poseidon_hash_batch_plain(flat, p)
        for route in cuda_poseidon.ROUTES:
            if not torch.equal(cuda_poseidon._launch(flat, p, 3, 2, 10, 10, route),
                               want):
                raise AssertionError(f"poseidon N={m} route={route}: kernel != plain")
    log(f"poseidon at (t, rate, L) = {[c[1:] for c in cases]}, N = {n}, on the "
        f"rule's route and on both routes forced, and at t = 3 on both routes at "
        f"N = {cross} and {cross + 1} (the rule's crossover: "
        f"{cuda_poseidon.LANE_THREADS_PER_SM} lanes an SM x {sms} SMs / "
        f"{cuda_poseidon.lanes_per_hash(3)} lanes a hash): kernel == plain == "
        "host sponge (exact)")
    return cross


def words_err(got, want) -> int:
    """max |a - b| over two tensors of canonical words (0 iff equal)."""
    return int((got.long() - want.long()).abs().max())


def run_ntt_path(torch, dev, rng, prev):
    """The NTT at full size over BN254 Fr through its entry points, each
    size also by device time (`device_ms`), below 2^21 on the four-step
    kernel's other cut, and in turns with the previous design (`prev`, where its copy
    is built).  Returns the per-size results of both kernels."""
    from mira_tpu_torch.fields.limbs import limb_field
    from mira_tpu_torch.fields.params import BN254_FR, field_params
    from mira_tpu_torch.ops import cuda_ntt, ntt

    p = BN254_FR
    lf = limb_field(p)
    four, stage = [], []
    # both engines around the size where "auto" changes from the stage kernel
    # to the four-step kernel (ops/ntt.py FOURSTEP_MIN), by events and by
    # device time
    switch = []
    for log_n in NTT_SWITCH_SIZES:
        a = lf.from_plain(_random_plain(rng, 1 << log_n, dev))
        if not torch.equal(ntt.ntt(a, p, engine="fourstep"),
                           ntt.ntt(a, p, engine="stage")):
            raise AssertionError(f"ntt 2^{log_n}: the engines disagree")
        f4 = lambda: ntt.ntt(a, p, engine="fourstep")
        st = lambda: ntt.ntt(a, p, engine="stage")
        e = {"log_n": log_n, "fourstep_ms": timed_cuda(f4, 50),
             "stage_ms": timed_cuda(st, 50)}
        with uncounted():
            e["fourstep_device_ms"] = device_ms(f4, 20)
            e["stage_device_ms"] = device_ms(st, 20)
            if prev:
                e["prev_device_ms"] = device_ms(
                    lambda: prev["ntt_fourstep"](a, p), 20)
        switch.append(e)
    log(f"ntt engines around FOURSTEP_MIN = {ntt.FOURSTEP_MIN} (means of 50 "
        f"calls by events, of 20 by device time): {json.dumps(switch)}")
    for log_n in NTT_SIZES:
        n = 1 << log_n
        a = lf.from_plain(_random_plain(rng, n, dev))
        torch.cuda.reset_peak_memory_stats()
        # a transform of under a millisecond is timed over more calls, so that
        # one slow launch on a busy host does not decide the mean
        reps = 20 if log_n <= NTT_PLAIN_MAX else 5
        fn = lambda: ntt.ntt(a, p)  # "auto": four-step here
        ms = timed_cuda(fn, reps)
        split = cuda_ntt.fourstep_split(log_n)
        entry = {"log_n": log_n, "ms": ms, "plain_ms": None, "split": list(split),
                 **bound(2 * n * 32, ntt_products(log_n))}
        err = 0
        with uncounted():
            entry["device_ms"] = device_ms(fn, reps)
            if log_n < cuda_ntt.THREE_PASS_MIN_LOG:  # the other cut it takes
                other = cuda_ntt.fourstep_split(log_n, 5 - len(split))
                fo = lambda: cuda_ntt._fourstep(a, p, False, other)
                entry["other_split"] = {"split": list(other),
                                        "ms": timed_cuda(fo, reps),
                                        "device_ms": device_ms(fo, reps)}
                err = words_err(fo(), fn())
            if prev:
                fp = lambda: prev["ntt_fourstep"](a, p)
                err = max(err, words_err(fp(), fn()))
                entry["paired_ms"], entry["prev_ms"] = paired(fn, fp, reps)
                entry["prev_device_ms"] = device_ms(fp, reps)
        if log_n <= NTT_PLAIN_MAX:
            want, entry["plain_ms"] = timed_once(lambda: ntt.ntt_plain(a, p))
            entry["max_abs_err"] = max(err, words_err(ntt.ntt(a, p), want))
            ms_s = timed_cuda(lambda: ntt.ntt(a, p, engine="stage"), reps)
            err_s = words_err(ntt.ntt(a, p, engine="stage"), want)
            inv = ntt.ntt(want, p, inverse=True)
            err_i = max(words_err(inv, a),
                        words_err(ntt.ntt(want, p, True, engine="stage"), a))
            stage.append({"log_n": log_n, "what": "whole transform",
                          "launches_per_call": log_n, "ms": ms_s,
                          "plain_ms": entry["plain_ms"],
                          "max_abs_err": max(err_s, err_i),
                          **bound(2 * n * 32, ntt_products(log_n))})
            entry["max_abs_err"] = max(entry["max_abs_err"], err_i)
            del want, inv
        else:
            # the plain version's int64 limbs would take gigabytes per
            # temporary: round trips, and spot values of a sparse input
            # against a host evaluation
            b = ntt.ntt(a, p)
            err = max(err, words_err(ntt.ntt(b, p, inverse=True), a))
            del b
            err = max(err, words_err(ntt.coset_intt(ntt.coset_ntt(a, p), p), a))
            nz = sorted(int(i) for i in rng.choice(n, size=300, replace=False))
            coeffs = _field_vals(rng, len(nz), p)
            sparse = lf.zero((n,), dev).clone()
            sparse[torch.tensor(nz, device=dev)] = lf.encode(coeffs, dev)
            out_idx = [int(i) for i in rng.choice(n, size=64, replace=False)]
            w = ntt.get_omega(p, log_n)
            got = lf.decode(ntt.ntt(sparse, p)[torch.tensor(out_idx, device=dev)])
            want = [sum(c * pow(w, i * k % n, p) for i, c in zip(nz, coeffs)) % p
                    for k in out_idx]
            err = max(err, max_abs_err(got, want))
            zeta = field_params(p).zeta
            got = lf.decode(ntt.coset_ntt(sparse, p)[
                torch.tensor(out_idx, device=dev)])
            want = [sum(c * pow(zeta, i % 3, p) * pow(w, i * k % n, p)
                        for i, c in zip(nz, coeffs)) % p for k in out_idx]
            entry["max_abs_err"] = max(err, max_abs_err(got, want))
            del sparse
        entry["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if entry["max_abs_err"]:
            raise AssertionError(f"ntt 2^{log_n}: kernel != reference")
        four.append(entry)
        other = entry.get("other_split")
        log(f"ntt 2^{log_n}: four-step {ms:.3f} ms, device {entry['device_ms']:.4f} "
            f"ms on passes {split}"
            + (f" (passes {other['split']}: {other['ms']:.3f} ms, device "
               f"{other['device_ms']:.4f})" if other else "")
            + (f"; paired {entry['paired_ms']:.3f} against the previous design's "
               f"{entry['prev_ms']:.3f} ms (device {entry['prev_device_ms']:.4f})"
               if prev else "")
            + (f", stage engine {stage[-1]['ms']:.3f} ms, plain "
               f"{entry['plain_ms']:.1f} ms" if log_n <= NTT_PLAIN_MAX else
               " (round trips, coset round trips and 2 x 64 spot values of a "
               "300-term input exact)")
            + f"; bound {entry['bound_ms']:.4f} ms by {entry['bound_by']}; "
            f"peak {entry['peak_gib']:.3f} GiB")
        if log_n == NTT_PLAIN_MAX:  # one stage alone: a middle one, in place
            tw = ntt._twiddle_table(p, log_n, False, str(dev))
            scratch = a.clone()
            half = 1 << (log_n // 2)
            want1, plain1 = timed_once(lambda: ntt.stage_plain(a, tw, half, p))
            err1 = words_err(cuda_ntt.stage_cuda(a, tw, half, p), want1)
            ms1 = timed_cuda(
                lambda: cuda_ntt.stage_cuda(scratch, tw, half, p, out=scratch), 20)
            if err1:
                raise AssertionError(f"ntt_stage at 2^{log_n}: kernel != plain")
            with uncounted():
                dev1 = device_ms(lambda: cuda_ntt.stage_cuda(scratch, tw, half, p,
                                                             out=scratch), 20)
            stage.append({"log_n": log_n, "what": f"one stage (half = 2^{log_n // 2})",
                          "launches_per_call": 1, "ms": ms1, "device_ms": dev1,
                          "plain_ms": plain1, "max_abs_err": err1,
                          **bound(2 * n * 32, n // 2)})
            log(f"ntt_stage 2^{log_n}, one stage: {ms1:.4f} ms, device {dev1:.4f} ms "
                f"(plain {plain1:.1f} ms); bound {stage[-1]['bound_ms']:.4f} ms by "
                f"{stage[-1]['bound_by']}")
            del scratch, want1
        del a
    four[0]["engines_near_switch"] = switch
    return four, stage


def run_poseidon_path(torch, dev, rng, prev):
    """2-to-1 hashes (t = 3, rate = 2, r_f = r_p = 10) at full size through
    `poseidon_hash_batch`, and a Merkle tree of 2^20 leaves reduced level by
    level on the card; each shape and each level of the tree also by device
    time (`device_ms`) and in turns with the previous design (`prev`,
    where its copy is built), with the route the rule took."""
    from mira_tpu_torch.fields.limbs import limb_field
    from mira_tpu_torch.fields.params import BN254_FR
    from mira_tpu_torch.ops import cuda_poseidon
    from mira_tpu_torch.ops.poseidon_device import (
        poseidon_hash_batch,
        poseidon_hash_batch_plain,
    )

    p = BN254_FR
    lf = limb_field(p)
    sms = cuda_poseidon.card_sms(str(dev))

    def timings(x, reps):
        """{route, ms, device_ms[, paired_ms, prev_ms, prev_device_ms]} of one
        batch of 2-to-1 hashes; the previous design's result must agree."""
        fn = lambda: poseidon_hash_batch(x, p)
        out = {"route": cuda_poseidon.poseidon_route(x.shape[0], 3, sms),
               "ms": timed_cuda(fn, reps)}
        with uncounted():
            out["device_ms"] = device_ms(fn, reps)
            if prev:
                fp = lambda: prev["poseidon"](x, p)
                if not torch.equal(fp(), fn()):
                    raise AssertionError(
                        f"poseidon N={x.shape[0]}: != the previous kernel")
                out["paired_ms"], out["prev_ms"] = paired(fn, fp, reps)
                out["prev_device_ms"] = device_ms(fp, reps)
        return out

    results = []
    for log_n in POSEIDON_SIZES:
        n = 1 << log_n
        pairs = lf.from_plain(_random_plain(rng, 2 * n, dev)).reshape(n, 2, 8)
        entry = {"log_n": log_n, **timings(pairs, 5)}
        got = poseidon_hash_batch(pairs, p)
        want, entry["plain_ms"] = timed_once(lambda: poseidon_hash_batch_plain(pairs, p))
        err = words_err(got, want)
        lanes = [int(i) for i in rng.choice(n, size=min(256, n), replace=False)]
        sel = torch.tensor(lanes, device=dev)
        ins = lf.decode(pairs[sel].reshape(-1, 8))
        host = [host_sponge(ins[2 * i : 2 * i + 2], p, 3, 2)
                for i in range(len(lanes))]
        err = max(err, max_abs_err(lf.decode(got[sel]), host))
        if err:
            raise AssertionError(f"poseidon 2^{log_n}: kernel != plain or host")
        b = bound(n * 3 * 32, n * poseidon_products(3, 10, 10, 2))
        entry.update(max_abs_err=err, **b)
        results.append(entry)
        log(f"poseidon 2^{log_n} 2-to-1 hashes ({entry['route']} route): "
            f"{entry['ms']:.3f} ms, device {entry['device_ms']:.3f} ms"
            + (f"; paired {entry['paired_ms']:.3f} against the previous design's "
               f"{entry['prev_ms']:.3f} ms (device {entry['prev_device_ms']:.3f})"
               if prev else "")
            + f" (plain {entry['plain_ms']:.1f} ms; 256 lanes == host sponge); "
            f"bound {b['bound_ms']:.3f} ms by {b['bound_by']}")
        del want

    def root(leaves, hash_fn):
        level = leaves
        while level.shape[0] > 1:
            level = hash_fn(level.reshape(level.shape[0] // 2, 2, 8), p)
        return level

    log_leaves = POSEIDON_SIZES[-1]
    leaves = pairs.reshape(-1, 8)[: 1 << log_leaves]
    tree_ms = timed_cuda(lambda: root(leaves, poseidon_hash_batch), 3)
    got = root(leaves, poseidon_hash_batch)
    want, tree_plain_ms = timed_once(lambda: root(leaves, poseidon_hash_batch_plain))
    small = leaves[: 1 << 10]
    level = lf.decode(small)
    while len(level) > 1:
        level = [host_sponge(level[i : i + 2], p, 3, 2)
                 for i in range(0, len(level), 2)]
    err = max(words_err(got, want),
              max_abs_err(lf.decode(root(small, poseidon_hash_batch)), level))
    if err:
        raise AssertionError("poseidon Merkle root: kernel != plain or host")
    # each level alone, on the inputs the tree gives it
    levels, x = [], leaves
    with uncounted():
        while x.shape[0] > 1:
            x = x.reshape(x.shape[0] // 2, 2, 8)
            levels.append({"hashes": x.shape[0],
                           **timings(x, 20 if x.shape[0] < 1 << 17 else 5)})
            if x.shape[0] <= 1 << POSEIDON_ROUTE_TIMED:  # around the crossover
                levels[-1]["route_device_ms"] = {r: device_ms(
                    lambda: cuda_poseidon._launch(x, p, 3, 2, 10, 10, r), 20)
                    for r in cuda_poseidon.ROUTES}
            x = poseidon_hash_batch(x, p)
    hashes = (1 << log_leaves) - 1
    b = bound(hashes * 3 * 32, hashes * poseidon_products(3, 10, 10, 2))
    entry = {"what": f"Merkle root of 2^{log_leaves} leaves",
             "launches_per_call": log_leaves, "ms": tree_ms,
             "plain_ms": tree_plain_ms, "max_abs_err": err, **b,
             "levels": levels}
    if prev:
        with uncounted():
            entry["paired_ms"], entry["prev_ms"] = paired(
                lambda: root(leaves, poseidon_hash_batch),
                lambda: root(leaves, prev["poseidon"]), 3)
    results.append(entry)
    log(f"poseidon Merkle root of 2^{log_leaves} leaves ({log_leaves} launches): "
        f"{tree_ms:.3f} ms"
        + (f", paired {entry['paired_ms']:.3f} against the previous design's "
           f"{entry['prev_ms']:.3f} ms" if prev else "")
        + f" (plain {tree_plain_ms:.1f} ms); == plain, and the 2^10-leaf root == "
        f"host sponge; bound {b['bound_ms']:.3f} ms")
    log("poseidon tree levels (hashes, route, event ms, device ms"
        + (", paired ms, previous design's ms and device ms" if prev else "")
        + "; to 2^16 hashes, device ms on the thread and the lane route): "
        + json.dumps([[lv["hashes"], lv["route"]] + [
            round(lv[k], 4) for k in ("ms", "device_ms", "paired_ms", "prev_ms",
                                      "prev_device_ms") if k in lv]
            + [round(v, 4) for v in lv.get("route_device_ms", {}).values()]
            for lv in levels]))
    return results


def primary_step_trace(pp, step_circuit, z_0, ro_nark, pg_pp):
    """A satisfying trace of the primary step-folding circuit at k=17: the
    IVC's zero step (ivc/ivc.py) for the start value `z_0`, synthesised by
    CircuitRunner and committed with the path's 2^21 key."""
    from mira_tpu_torch.curves.host import Tuple12
    from mira_tpu_torch.fields.host import field
    from mira_tpu_torch.ivc.instance_computation import compute_instance_hash
    from mira_tpu_torch.ivc.step_folding_circuit import StepFoldingCircuit, StepInputs
    from mira_tpu_torch.nifs.protogalaxy import ProtoGalaxy
    from mira_tpu_torch.ops.poseidon import PoseidonHash
    from mira_tpu_torch.table.runner import CircuitRunner

    p_mod = pp.primary_curve.scalar_modulus
    sec = pp.secondary_initial_plonk_trace
    sec_relaxed = sec.to_relax(pp.secondary.k)
    z_out = step_circuit.process_step(z_0, pp.primary.k, p_mod)
    instance = [
        sec.u.instance[1] % p_mod,
        compute_instance_hash(
            PoseidonHash(pp.primary.params.ro_spec), pp.digest_2, 1, z_0, z_out,
            sec_relaxed.U, pp.limb_width, pp.limbs_count),
    ]
    one = Tuple12.one(field(pp.secondary_curve.base_modulus))
    sfc = StepFoldingCircuit(step_circuit, StepInputs(
        step=0, step_pp=pp.primary.params, public_params_hash=pp.digest_2,
        z_0=list(z_0), z_i=list(z_0), U=sec_relaxed.U, u=sec.u,
        cross_term_commits=[
            type(pp.digest_2).identity(pp.secondary_curve)
            for _ in range(pp.secondary.S.get_degree_for_folding() - 1)],
        cross_term_gt_commits=[
            one for _ in range(pp.secondary.S.target_group_cross_terms)]))
    witness = CircuitRunner(pp.primary.k, sfc, instance,
                            pp.primary_curve).collect_witness()
    return ProtoGalaxy.generate_plonk_trace(pp.primary.ck, instance, witness,
                                            pg_pp, ro_nark)


def run_protogalaxy_path(torch, dev, pp, step_circuit):
    """ProtoGalaxy at full width on the card: the k=17 path's primary
    structure and key, PG_TRACES traces per fold, two folds.  Each fold
    counts only if the verifier's (betas', e, U) equal the prover's and the
    folded trace satisfies the accumulator relation."""
    from mira_tpu_torch.nifs.protogalaxy import ProtoGalaxy
    from mira_tpu_torch.ops.poseidon import PoseidonHash

    S, ck = pp.primary.S, pp.primary.ck

    def ro():  # the transcript over the key curve's base field, as the IVC's
        return PoseidonHash(pp.secondary.params.ro_spec)

    pg_pp, vp = ProtoGalaxy.setup_params(pp.digest_1, S)
    t0 = time.perf_counter()
    ro_nark = ro()  # one running NARK transcript over the traces
    traces = [primary_step_trace(pp, step_circuit, [z], ro_nark, pg_pp)
              for z in range(PG_TRACES)]
    torch.cuda.synchronize()
    log(f"protogalaxy: {PG_TRACES} traces of the k={S.k} step-folding circuit "
        f"({len(S.gates)} gates, rounds {S.round_sizes}): "
        f"{time.perf_counter() - t0:.3f} s")
    acc = ProtoGalaxy.new_accumulator(S, pg_pp, ro(), dev)
    prove_secs, prove_counts = [], []
    for fold in range(2):
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        new_acc, proof = ProtoGalaxy.prove(ck, pg_pp, ro(), acc, traces)
        torch.cuda.synchronize()
        prove_secs.append(time.perf_counter() - t0)
        after = launch_counts()
        prove_counts.append({k: after[k] - before[k] for k in after})
        betas_v, e_v, U_v = ProtoGalaxy.verify(
            vp, ro(), ro(), acc, [t.u for t in traces], proof)
        if (betas_v, e_v) != (new_acc.betas, new_acc.e) or U_v != new_acc.trace.U:
            raise AssertionError(f"protogalaxy fold {fold + 1}: verifier != prover")
        t0 = time.perf_counter()
        if ProtoGalaxy.compute_F(new_acc.betas, 0, S, new_acc.trace).eval(0) != new_acc.e:
            raise AssertionError(f"protogalaxy fold {fold + 1}: the folded trace "
                                 "does not satisfy F(betas', 0)(0) == e'")
        log(f"protogalaxy fold {fold + 1}: prove {prove_secs[-1]:.3f} s, launches "
            f"during it {prove_counts[-1]}; verifier == prover; F(betas', 0)(0) "
            f"== e' (checked in {time.perf_counter() - t0:.3f} s); poly_F zero: "
            f"{all(c == 0 for c in proof.poly_F)}, e' zero: {new_acc.e == 0}")
        acc = new_acc
    return prove_secs, prove_counts


def profile_fold_step(torch, ivc, out_dir: str, mesh=None):
    """One more fold step (with `mesh`, where given) under torch.profiler.
    Prints the step's wall time, the device's busy time (the union of
    device-event intervals) and its share of the wall, and the ops by device
    time and by host time; writes those tables to
    out_dir/{mesh_,}fold_step_profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ivc.fold_step(mesh=mesh)
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
    host = ka.table(sort_by="self_cpu_time_total", row_limit=25,
                    max_name_column_width=60)
    os.makedirs(out_dir, exist_ok=True)
    what = "mesh fold step" if mesh is not None else "fold step"
    name = ("mesh_" if mesh is not None else "") + "fold_step_profile.txt"
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(table + "\n\n" + host)
    log(f"[profile] {what} {ivc.step}: wall {wall_us / 1e6:.4f} s "
        f"(profiled), {len(ivs)} device events, device busy "
        f"{busy_us / 1e6:.4f} s = {busy_us / wall_us:.4f} of the wall")
    log("\n".join(table.splitlines()[:30]))
    log(f"[profile] {what}: ops by host time")
    log("\n".join(host.splitlines()[:20]))


def check_msm_engines_small(torch, dev, rng):
    """Kernels 4-7 against their plain versions on the card and the host MSM
    at n = 300 on both curves: duplicate bases, a zero scalar, scalars 1,
    r - 1, 16 (signed digit -16 with a carry), 16 in every 5-bit window and
    2^250 - 1, and identity padding lanes at the end."""
    from mira_tpu_torch.convert import msm_reference
    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN, AffinePoint
    from mira_tpu_torch.curves.torch_curve import jacobian_ops
    from mira_tpu_torch.ops.msm import encode_scalars, msm, plain_engine

    n = 300
    for curve in (BN254_G1, GRUMPKIN):
        ops = jacobian_ops(curve.name)
        r = curve.scalar_modulus
        sc, pts = adversarial_input(curve, n, rng)
        every = sum(16 << (5 * k) for k in range(50)) % r
        sc[:6] = [0, 1, r - 1, 16, every, (1 << 250) - 1]
        pts[-4:] = [AffinePoint.identity(curve)] * 4
        s = encode_scalars(sc, r, dev)
        P = ops.encode_points(pts, dev)
        ref = msm_reference(s, P, curve)
        for method in ENGINES:
            got = decode_one(curve, msm(s, P, curve, method))
            plain = decode_one(curve, plain_engine(method)(s, P, curve))
            if not (got == plain == ref):
                raise AssertionError(f"{method} n={n} on {curve.name}: kernel "
                                     f"{got} plain {plain} host {ref}")
    log(f"msm engines {list(ENGINES)} at n = {n} (duplicates, zero scalar, 1, "
        "r - 1, 16, 16 in every window, 2^250 - 1, identity lanes): kernel == "
        "plain == host on both curves (exact)")


def engine_phases(method, s, P, curve):
    """The C calls of one call of engine `method` (ops/cuda_msm.py):
    kernels 4 and 5's `pippenger_phases`, kernels 6 and 7's `lane_phases`
    (one part of the bases at these widths)."""
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.ops.msm import LANE_WINDOWS

    if method in PIPPENGER_METHODS:
        return cuda_msm.pippenger_phases(s, P, curve, method == "pippenger")[0]
    return [ph for phases, _ in cuda_msm.lane_phases(s, P, curve, LANE_WINDOWS[method])
            for ph in phases]


def run_route(phases_out):
    """Make the C calls of ([(phase, call)], out) in order; returns out."""
    from mira_tpu_torch import _build

    phases, out = phases_out
    for name, call in phases:
        _build.check(call(), name)
    return out


def engine_extras(torch, method, s, P, curve, reps, chunks=()):
    """An engine beyond its time: its per-phase times (summed over the
    chunks), the peak scratch of one call; kernel 7 also its time and peak scratch on its own route
    (kernel 1's C calls) and on kernel 4's, in turns, whose results must
    agree; and with `chunks` (kernels 4 and 5) its time and scratch at each
    chunk size."""
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.ops.msm import msm

    def call():
        return msm(s, P, curve, method)

    out = {"phases_ms": timed_phases(torch, engine_phases(method, s, P, curve), reps),
           "scratch_bytes": peak_bytes(torch, call)}
    if method != "lane":
        out["chunk"] = cuda_msm.PIPPENGER_CHUNK
    if method == "lane":
        routes = {"bucket": lambda: run_route(cuda_msm.bucket_phases(s, P, curve)),
                  "pippenger": lambda: run_route(
                      cuda_msm.pippenger_phases(s, P, curve, True))}
        if len({tuple(point_ints(decode_one(curve, fn()))) for fn in routes.values()}) != 1:
            raise AssertionError(f"lane n={s.shape[0]}: the two routes disagree")
        bucket_ms, pippenger_ms = paired(routes["bucket"], routes["pippenger"], reps)
        out["route_ms"] = {"bucket": bucket_ms, "pippenger": pippenger_ms}
        out["route_scratch_bytes"] = {r: peak_bytes(torch, fn) for r, fn in routes.items()}
    if chunks:
        signed = method == "pippenger"
        out["chunk_ms"] = {str(c): timed_cuda(lambda: cuda_msm.msm_pippenger_cuda(
            s, P, curve, signed, c), 3) for c in chunks}
        out["chunk_scratch_bytes"] = {str(c): peak_bytes(
            torch, lambda: cuda_msm.msm_pippenger_cuda(s, P, curve, signed, c))
            for c in chunks}
    return out


def engine_timings(torch, ck, s17, P17, want17, plain17_ms, s21, P21, host21):
    """Kernels 4-7 at the mesh path's widths on BN254: at 2^17 (the
    cross-term width) held against `want17`, the bucket MSM's plain version
    on the same inputs (computed once), and each timed against its own plain
    version; at 2^21 (the SPS commit width, the key's points) against
    `host21`, the host MSM of (s21, P21), which the bucket kernel equals.
    Each also per phase, with its peak scratch, kernel 7 on both routes,
    and kernels 4 and 5 at 2^21 per chunk size (`engine_extras`).  Returns
    {method: [entry at 2^17, entry at 2^21]}."""
    from mira_tpu_torch.ops.msm import msm, plain_engine

    curve = ck.curve
    out = {m: [] for m in ENGINES}
    want = point_ints(decode_one(curve, want17))
    for method in ENGINES:
        ms = timed_cuda(lambda: msm(s17, P17, curve, method), ENGINE_REPS[method])
        err = max_abs_err(point_ints(decode_one(curve, msm(s17, P17, curve, method))),
                          want)
        plain, plain_ms = timed_once(lambda: plain_engine(method)(s17, P17, curve))
        err = max(err, max_abs_err(point_ints(decode_one(curve, plain)), want))
        if err:
            raise AssertionError(f"{method} 2^17: kernel or plain != msm_plain")
        extra = engine_extras(torch, method, s17, P17, curve, ENGINE_REPS[method])
        out[method].append({"n": 1 << 17, "ms": ms, "plain_ms": plain_ms,
                            "bucket_plain_ms": plain17_ms, "max_abs_err": err,
                            **msm_bucket_bound(1 << 17, curve), **extra})
        log(f"{method} 2^17: {ms:.3f} ms (plain {plain_ms:.1f} ms); == the "
            "bucket MSM's plain version; bound "
            f"{out[method][-1]['bound_ms']:.3f} ms{_engine_note(extra)}")
    n, s, P, host = 1 << 21, s21, P21, host21
    for method in ENGINES:
        ms = timed_cuda(lambda: msm(s, P, curve, method), ENGINE_REPS[method])
        err = max_abs_err(point_ints(decode_one(curve, msm(s, P, curve, method))),
                          host)
        if err:
            raise AssertionError(f"{method} 2^21: kernel != bucket kernel == host")
        extra = engine_extras(torch, method, s, P, curve, ENGINE_REPS[method],
                              PIPPENGER_CHUNKS if method in PIPPENGER_METHODS else ())
        out[method].append({"n": n, "ms": ms, "plain_ms": None, "max_abs_err": err,
                            **msm_bucket_bound(n, curve), **extra})
        log(f"{method} 2^21: {ms:.3f} ms; == bucket kernel == host MSM; bound "
            f"{out[method][-1]['bound_ms']:.3f} ms{_engine_note(extra)}")
    return out


def _engine_note(extra: dict) -> str:
    note = (f"; phases "
            f"{json.dumps({k: round(v, 3) for k, v in extra['phases_ms'].items()})}"
            f", peak scratch {extra['scratch_bytes'] / 2**20:.1f} MiB")
    if "chunk" in extra:
        note += f" in chunks of {extra['chunk']}"
    if "route_ms" in extra:
        mib = {k: round(v / 2**20, 1) for k, v in extra["route_scratch_bytes"].items()}
        note += (f"; by route, paired (ms) "
                 f"{json.dumps({k: round(v, 3) for k, v in extra['route_ms'].items()})}"
                 f", scratch (MiB) {json.dumps(mib)}")
    if "chunk_ms" in extra:
        mib = {k: round(v / 2**20, 1) for k, v in extra["chunk_scratch_bytes"].items()}
        note += (f"; by chunk size (ms) {json.dumps(extra['chunk_ms'])}, scratch "
                 f"(MiB) {json.dumps(mib)}")
    return note


def run_engine_deciders(torch, ivc):
    """The k=17 path's decider, verify(strict=True), once per engine of
    DECIDER_ENGINES: the keys' generic_method set to it, so that the decider's
    commitments (witness and error vectors, up to 2^21 points) go through
    its kernel, and no other MSM kernel is launched.  Returns {method:
    (seconds, counts)}."""
    keys = (ivc.pp.primary.ck, ivc.pp.secondary.ck)
    msm_kernels = ["msm_bucket", "msm_fixed", "fixed_table"] + [
        name for name, _, _ in ENGINES.values()]
    out = {}
    for method in DECIDER_ENGINES:
        name = ENGINES[method][0]
        for ck in keys:
            ck.generic_method = method
        reset_launch_counts()
        t0 = time.perf_counter()
        ivc.verify(strict=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        require_launched(counts, (name,), f"the decider with generic_method={method}")
        others = {k: counts[k] for k in msm_kernels if k != name and counts[k]}
        if others:
            raise AssertionError(f"the decider with generic_method={method} "
                                 f"launched other MSM kernels: {others}")
        out[method] = (secs, counts)
        log(f"decider with generic_method={method}: verify(strict=True) passed "
            f"in {secs:.3f} s; {name} launches {counts[name]}")
    for ck in keys:
        ck.generic_method = "bucket"
    return out


def accumulators(ivc):
    """Both sides' accumulators (instance, witness rounds, error vector)."""
    return [(t.U, list(t.W.W), t.W.E) for t in
            (ivc.primary.relaxed_trace, ivc.secondary.relaxed_trace)]


def same_accumulators(a, b) -> bool:
    import torch

    return all(Ua == Ub and len(Wa) == len(Wb)
               and all(torch.equal(x, y) for x, y in zip(Wa, Wb))
               and torch.equal(Ea, Eb)
               for (Ua, Wa, Ea), (Ub, Wb, Eb) in zip(a, b))


def run_mesh_path(torch, dev, pp, sc1, sc2, single, profile_dir=None):
    """A second IVC of the k=17 path's public parameters folded MESH_STEPS
    times with fold_step(mesh=...) on a mesh of one; after each step its
    accumulators must equal the single-device IVC's (`single`, recorded
    after each of its steps); with `profile_dir`, one more step under
    torch.profiler; then verify(strict=True).  Returns (step seconds, launch
    counts over the checked steps, peak bytes, verify seconds)."""
    from mira_tpu_torch.parallel.mesh import make_mesh

    with make_mesh(1, dev) as mesh:
        return _mesh_steps(torch, mesh, pp, sc1, sc2, single, profile_dir)


def _mesh_steps(torch, mesh, pp, sc1, sc2, single, profile_dir):
    from mira_tpu_torch.ivc.ivc import IVC
    from mira_tpu_torch.utils import tracing

    t0 = time.perf_counter()
    ivc = IVC(pp, sc1, [0], sc2, [0])
    torch.cuda.synchronize()
    log(f"mesh path: mesh of {mesh.size} on {mesh.device}; zero step "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    tracing.reset()
    reset_launch_counts()
    secs = []
    for i in range(MESH_STEPS):
        t0 = time.perf_counter()
        ivc.fold_step(mesh=mesh)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not same_accumulators(accumulators(ivc), single[i]):
            raise AssertionError(f"mesh fold step {i + 1}: accumulators differ "
                                 "from the single-device IVC's")
        log(f"mesh fold step {i + 1}: {secs[-1]:.3f} s; both sides' "
            "accumulators == the single-device IVC's after its step "
            f"{i + 1}")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log("host span tree of the mesh fold steps:")
    log(tracing.report(min_runtime=0.01))
    require_launched(counts, ("msm_pippenger", "fold_eval"), "the mesh path")
    if counts["msm_fixed"] or counts["fixed_table"]:
        raise AssertionError(f"the mesh steps built or used a multiples table: {counts}")
    if profile_dir:
        profile_fold_step(torch, ivc, profile_dir, mesh)
    t0 = time.perf_counter()
    ivc.verify(strict=True)
    torch.cuda.synchronize()
    ver = time.perf_counter() - t0
    log(f"mesh path: fold steps (s) {secs}; launches over them {counts}; peak "
        f"device memory {peak / 2**30:.3f} GiB; verify(strict=True) passed in "
        f"{ver:.3f} s")
    return secs, counts, peak, ver


def run_dryrun(torch, dev):
    """dryrun_multichip(1, cuda) with a 2^20 distributed NTT; returns its
    seconds and the launch counts over it."""
    from mira_tpu_torch.parallel.dryrun import dryrun_multichip

    reset_launch_counts()
    secs = dryrun_multichip(1, str(dev), ntt_log_n=20)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"dryrun_multichip(1, cuda): fold/eval rows, distributed NTT (2^6, "
        f"2^20) == ntt, sharded MSM == host, k=9 mesh fold == single-device "
        f"fold, is_sat_relaxed: all passed; seconds {json.dumps(secs)}; "
        f"launches {counts}")
    require_launched(counts, ("msm_pippenger", "ntt_fourstep", "ntt_stage"),
                     "the dryrun")
    return secs, counts


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="profile one more fold step and one more mesh fold "
                         "step and write their tables of device and host "
                         "time to DIR")
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

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    card = device_lines(torch)
    phase("device", t0)

    # the keys from the start, beside the build: the k=17 path's first, then
    # SnarkStar's 2^24 keys on both curves, which grow from them (batch 2
    # uses them whole, batch 1 the BN254 key's first 2^23 points, the key of
    # 2^23, and the Grumpkin key whole); SnarkStar batch 2 and its checks
    # wait for the last key, and so bound the script's time
    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN

    key_specs = [(BN254_G1, K + 4, "bn256"), (GRUMPKIN, K + 4, "grumpkin"),
                 (BN254_G1, 24, "bn256"), (GRUMPKIN, 24, "grumpkin")]
    keygen = start_keygen(key_specs)
    # TensorStar at k=22 (mock keys) in a worker process from the start,
    # beside the build and the small checks; SnarkStar batch 2 later in the
    # same process (see _paths)
    ctx = multiprocessing.get_context("spawn")
    built = ctx.Event()
    ts_pool = ctx.Pool(1, initializer=_worker_init, initargs=(built,))
    try:
        t_ts = time.perf_counter()
        ts_job = ts_pool.apply_async(tensorstar_worker, (int(rng.integers(1 << 30)),))
        t0 = time.perf_counter()
        # the previous kernels, where their copy is present, build beside these
        pool = ThreadPoolExecutor(1)
        prev_build = pool.submit(prev_kernels, root)
        pool.shutdown(wait=False)
        _build.lib()
        built.set()
        secs = _build.build_seconds
        log(f"kernel build: {'%.1f s' % secs if secs is not None else 'cached'}")
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
        prev = prev_build.result()
        log(f"previous kernels 8 and 10 (commit {PREV_COMMIT}) for the paired timing: "
            f"{'built from ' + PREV_CSRC if prev else 'no copy at ' + PREV_CSRC + ', not timed'}")
        phase("build", t0)
        return _paths(args, torch, dev, rng, card, prev, t_all, ts_pool, ts_job,
                      t_ts, key_specs, keygen)
    finally:
        ts_pool.terminate()
        ts_pool.join()


def _paths(args, torch, dev, rng, card, prev, t_all, ts_pool, ts_job, t_ts,
           key_specs, keygen) -> int:
    """Every path after the build (main() keeps the worker process's
    lifetime around it).  The worker uses the card only while the main
    process takes no kernel time: TensorStar up to the NTT path, which waits
    for its result; SnarkStar batch 2's run and checks from the end of the
    engine timings, while this process runs the paths that report seconds
    of their own and batch 1's checks, whose kernel times wait until the
    worker is done; then the worker takes batch 2's kernel times while this
    process waits."""
    import gc

    from mira_tpu_torch.ivc.ivc import IVC
    from mira_tpu_torch.ivc.public_params import CircuitSide, PublicParams
    from mira_tpu_torch.ops import cuda_msm
    from mira_tpu_torch.ops.commitment import CommitmentKey
    from mira_tpu_torch.convert import msm_reference
    from mira_tpu_torch.ops.msm import bucket_window, fixed_base_window, msm_plain
    from mira_tpu_torch.polynomial import fold_evaluator as fe
    from mira_tpu_torch.utils import tracing
    from mira_tpu_torch.workloads import snarkstar
    from mira_tpu_torch.curves.host import BN254_G1, GRUMPKIN
    from mira_tpu_torch.ivc.step_circuit import TrivialCircuit
    from mira_tpu_torch.workloads.poseidon import PoseidonStepCircuit

    t0 = time.perf_counter()
    small = {}
    # the edge cases' plain versions in CPU worker processes (kernels 1, 3
    # and 3b's first, then kernels 4 and 5's, which finish during the NTT
    # and Poseidon paths), stopped on leaving the block whatever happens
    with multiprocessing.get_context("spawn").Pool(LAYOUT_WORKERS) as pool:
        jobs = submit_layout_plain(pool, rng)
        pippenger_jobs = submit_pippenger_plain(pool, rng)
        for check in (check_field_kernels, check_msm_small, check_fixed_small,
                      check_table_edges, check_ntt_small, check_poseidon_small,
                      check_msm_engines_small, check_msm_layout_cases):
            t1 = time.perf_counter()
            small[check.__name__] = check(
                torch, dev, jobs if check is check_msm_layout_cases else rng)
            log(f"  {check.__name__}: {time.perf_counter() - t1:.1f} s")
        layout_err = small["check_msm_layout_cases"]
        poseidon_cross = small["check_poseidon_small"]
        table_err = small["check_table_edges"]
        phase("kernel_checks_small", t0)

        # -- TensorStar at k=22 (mock keys), in the worker since the start:
        # every kernel time below is taken with the card this process's alone
        t0 = time.perf_counter()
        ts = ts_job.get()
        ts_counts, ts_secs = ts["counts"], ts["secs"]
        log(f"tensorstar process: its result {time.perf_counter() - t_ts:.1f} s "
            "after its start")
        phase("tensorstar_wait", t0)

        # -- the NTT and Poseidon paths need no key: they run while the keys
        # are made
        t0 = time.perf_counter()
        reset_launch_counts()
        log("the NTT and Poseidon paths run while the keys are made on a "
            "background thread (native keygen) and the edge cases' plain "
            f"versions in {LAYOUT_WORKERS} CPU worker processes: their event "
            "times include that host's load, their device times do not")
        ntt_four, ntt_stage = run_ntt_path(torch, dev, rng, prev)
        ntt_counts = launch_counts()
        log(f"launches over the NTT path: {ntt_counts}")
        require_launched(ntt_counts, ("ntt_fourstep", "ntt_stage"), "the NTT path")
        phase("ntt_path", t0)

        t0 = time.perf_counter()
        reset_launch_counts()
        poseidon_at = run_poseidon_path(torch, dev, rng, prev)
        poseidon_counts = launch_counts()
        log(f"launches over the Poseidon path: {poseidon_counts}")
        require_launched(poseidon_counts, ("poseidon",), "the Poseidon path")
        phase("poseidon_path", t0)

        t0 = time.perf_counter()
        pippenger_err = check_pippenger_edges(torch, dev, pippenger_jobs)
        phase("pippenger_edge_cases", t0)

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
    check_fold_eval(torch, dev, rng, pp.secondary.S)
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
    single = []  # the accumulators after each step, for the mesh path
    ckpt_dir = tempfile.TemporaryDirectory()
    ckpt = os.path.join(ckpt_dir.name, f"k{K}.npz")
    for i in range(FOLD_STEPS):
        if i == FOLD_STEPS - 1:  # the state before the last step, resumed below
            t0 = time.perf_counter()
            ivc.save_checkpoint(ckpt)
            ckpt_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        ivc.fold_step()
        torch.cuda.synchronize()
        step_secs.append(time.perf_counter() - t0)
        single.append(accumulators(ivc))
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
    require_launched(counts, MSM_PATH_KERNELS, "the k=17 path")

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
    bucket_plain17, bucket_plain17_ms = want, ms_p  # shared by kernels 4-7
    bucket_at = [{"n": n, "ms": ms_k, "plain_ms": ms_p, "max_abs_err": err,
                  **msm_bucket_bound(n, BN254_G1)}]
    # at the SPS commit width 2^21 against the host MSM (whose result the
    # timings of kernels 4-7 reuse); the plain version is not run there
    s21, P21 = _random_plain(rng, 1 << 21, dev), ck1._enc_slice(1 << 21)
    host21 = point_ints(msm_reference(s21, P21, BN254_G1))
    err21 = max_abs_err(point_ints(decode_one(
        BN254_G1, cuda_msm.msm_cuda(s21, P21, BN254_G1))), host21)
    if err21:
        raise AssertionError("bucket MSM 2^21: kernel != host")
    bucket_at.append({"n": 1 << 21, "ms": timed_cuda(
        lambda: cuda_msm.msm_cuda(s21, P21, BN254_G1), 5), "plain_ms": None,
        "max_abs_err": err21, **msm_bucket_bound(1 << 21, BN254_G1)})
    for a, (sa, Pa) in zip(bucket_at, ((s, P), (s21, P21))):
        a["window"] = bucket_window(a["n"])
        a["phases_ms"] = timed_phases(
            torch, cuda_msm.bucket_phases(sa, Pa, BN254_G1)[0], 5)
        log(f"msm_bucket n={a['n']} c={a['window']}: {a['ms']:.3f} ms, phases "
            f"{json.dumps({k: round(v, 3) for k, v in a['phases_ms'].items()})}")
    kernels.append({
        "name": "msm_bucket", "route": "cuda",
        "source": "mira_tpu_torch/csrc/msm_bucket.cu",
        "replaces": "mira_tpu/ops/pallas_msm.py:781",
        "launches": counts["msm_bucket"], "max_abs_err": max(err, err21, layout_err),
        "ms": ms_k, "plain_ms": ms_p, **msm_bucket_bound(n, BN254_G1),
        "library_ms": None, "phases_ms": bucket_at[0]["phases_ms"],
        "shape": f"N=2^{K} bn254, full-width scalars, c={bucket_at[0]['window']}",
        "at": bucket_at,
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
    n_pts = len(js) - 2
    # the point loop rereads a row's columns once per point after the first:
    # their bytes at the device-memory rate, against one point's time
    ms_one = timed_cuda(lambda: fe.fold_eval_cuda(
        ev.lf, ops_t, n_regs, ev.static_stack, w1, w2, ch[1:2], jm[1:2], consts), 5)
    reread = (n_pts - 1) * (ev.static_stack.shape[0] + 2 * w1.shape[0]) * 32 << K
    log(f"fold_eval 2^{K} rows x {n_pts} points: {ms_k:.3f} ms (one point "
        f"{ms_one:.3f} ms; the rereads {reread / 1e9:.3f} GB, "
        f"{reread / MEM_BYTES_PER_S * 1e3:.3f} ms at the device-memory rate; plain "
        f"{ms_p:.1f} ms)")
    kernels.append({
        "name": "fold_eval", "route": "cuda",
        "source": "mira_tpu_torch/csrc/fold_eval.cu",
        "replaces": "mira_tpu/polynomial/pallas_evaluator.py:323",
        "launches": counts["fold_eval"], "max_abs_err": err,
        "ms": ms_k, "plain_ms": ms_p, "ms_one_point": ms_one,
        **fold_eval_bound(fops, ev.static_stack.shape[0], w1.shape[0], 1 << K,
                          n_pts),
        "library_ms": None,
        "shape": f"nrow=2^{K}, {n_pts} fold points, {len(fops)} ops, {n_regs} "
                 f"registers",
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
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "phases_ms": head["phases_ms"],
        "shape": f"N={head['n']} (the k={K} delta width) {head['curve']}, "
                 f"w={head['window']}", "at": msm_at,
    })
    kernels.append({
        "name": "fixed_table", "route": "cuda",
        "source": "mira_tpu_torch/csrc/fixed_table.cu",
        "replaces": "mira_tpu/ops/pallas_msm.py:895",
        "launches": counts["fixed_table"],
        "max_abs_err": max([table_err] + [t["max_abs_err"] for t in tab_at]),
        "ms": tab_at[0]["ms"], "plain_ms": tab_at[0]["plain_ms"],
        "bound_ms": tab_at[0]["bound_ms"], "bound_by": tab_at[0]["bound_by"],
        "bound_route": tab_at[0]["bound_route"],
        "library_ms": None,
        "shape": f"N={head['n']} {head['curve']}, w={head['window']}", "at": tab_at,
    })
    phase("kernel_timing", t0)

    # -- kernels 4-7: timings at the mesh path's widths, their paths ----------
    t0 = time.perf_counter()
    engine_at = engine_timings(torch, ck1, s, P, bucket_plain17,
                               bucket_plain17_ms, s21, P21, host21)
    pippenger_err = max(pippenger_err, check_pippenger_chunks(
        torch, dev, rng, ck1, cuda_msm.PIPPENGER_CHUNK))
    phase("msm_engine_timing", t0)
    # SnarkStar batch 2 in the worker once its keys are made: beside the
    # rest of this process's paths (the kernel timings are done)
    t0 = time.perf_counter()
    for (_, k, label), fut in zip(key_specs[2:], keygen[2:]):
        log(f"keygen {label} 2^{k} (native, background thread, from the 2^{K + 4} "
            f"key): {fut.result():.3f} s")
    seen = {(a["curve"], a["n"], a["window"]) for a in msm_at}
    b2_job = ts_pool.apply_async(snarkstar_b2_worker,
                                 (int(rng.integers(1 << 30)), seen))
    t_b2 = time.perf_counter()
    phase("snarkstar_keys_wait", t0)
    t0 = time.perf_counter()
    deciders = run_engine_deciders(torch, ivc)
    phase("msm_engine_deciders", t0)
    t0 = time.perf_counter()
    mesh_secs, mesh_counts, mesh_peak, mesh_verify = run_mesh_path(
        torch, dev, pp, sc1, sc2, single, args.profile)
    phase("mesh_path", t0)
    t0 = time.perf_counter()
    ckpt_secs, ckpt_counts = run_checkpoint(torch, dev, pp, sc1, sc2, ckpt, single[-1])
    ckpt_secs["save"] = ckpt_save
    ckpt_dir.cleanup()
    log(f"checkpoint of the k={K} IVC before its step {FOLD_STEPS}: saved in "
        f"{ckpt_save:.3f} s, {ckpt_secs['file_bytes']} bytes; loaded (IVC.resume) in "
        f"{ckpt_secs['load']:.3f} s")
    phase("checkpoint", t0)
    del single
    t0 = time.perf_counter()
    dry_secs, dry_counts = run_dryrun(torch, dev)
    phase("dryrun", t0)
    for method, (name, src, replaces) in ENGINES.items():
        at = engine_at[method]
        if method in deciders:
            launches = {"launches": deciders[method][1][name],
                        "path": f"the k={K} decider, generic_method={method}"}
        else:
            launches = {"launches": mesh_counts[name],
                        "path": f"{MESH_STEPS} k={K} fold_step(mesh=) on a mesh of 1",
                        "launches_dryrun": dry_counts[name]}
        extra = {"sources": ENGINE_SOURCES[method], "phases_ms": at[0]["phases_ms"],
                 "scratch_bytes": at[0]["scratch_bytes"]}
        kernels.append({
            "name": name, "route": "cuda", "source": f"mira_tpu_torch/csrc/{src}",
            "replaces": replaces, **launches,
            "max_abs_err": max([a["max_abs_err"] for a in at]
                               + ([pippenger_err] if method in PIPPENGER_METHODS
                                  else [])),
            "ms": at[0]["ms"], "plain_ms": at[0]["plain_ms"],
            "bound_ms": at[0]["bound_ms"], "bound_by": at[0]["bound_by"],
            "library_ms": None, **extra,
            "shape": f"N=2^{K} bn254 (the cross-term width), full-width scalars",
            "at": at,
        })
    kernels[1]["launches_mesh"] = mesh_counts["fold_eval"]
    kernels[1]["launches_dryrun"] = dry_counts["fold_eval"]
    mesh_summary = {"step_s": mesh_secs, "single_step_s": step_secs,
                    "verify_s": mesh_verify,
                    "peak_gib": mesh_peak / 2**30, "dryrun_s": dry_secs}
    log(f"mesh path summary: {json.dumps(mesh_summary)}")
    log(f"mesh fold steps (s) {mesh_secs} beside this run's single-device "
        f"k={K} fold steps {step_secs}")

    # -- ProtoGalaxy at k=17 on the path's structure and key ---------------------
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tracing.reset()
    pg_secs, pg_prove_counts = run_protogalaxy_path(torch, dev, pp, sc1)
    pg_counts = launch_counts()
    pg_peak = torch.cuda.max_memory_allocated()
    log("host spans of the ProtoGalaxy path (traces, two proves, checks), "
        "[count, seconds] by name: "
        + json.dumps({k: [c, round(t, 3)] for k, (c, t) in tracing.totals().items()}))
    log(f"protogalaxy prove (s): {pg_secs}; launches over the path: {pg_counts}; "
        f"peak device memory {pg_peak / 2**30:.3f} GiB")
    # compute_K's size-16 coset transforms take the engine ops/ntt.py's
    # FOURSTEP_MIN gives that size
    from mira_tpu_torch.ops.ntt import FOURSTEP_MIN

    pg_ntt = "ntt_fourstep" if PG_NTT_SIZE >= FOURSTEP_MIN else "ntt_stage"
    require_launched(pg_counts, ("msm_bucket", pg_ntt, "fold_eval"),
                     "the ProtoGalaxy path")
    phase("protogalaxy_path", t0)

    # the three kernels of the polynomial and hashing side: no PyTorch call
    # computes a BN254 NTT or Poseidon hash, so there is no library time
    head4 = next(e for e in ntt_four if e["log_n"] == NTT_PLAIN_MAX)
    kernels.append({
        "name": "ntt_fourstep", "route": "cuda",
        "source": "mira_tpu_torch/csrc/ntt_fourstep.cu",
        "replaces": "mira_tpu/ops/ntt.py:426",
        "launches": ntt_counts["ntt_fourstep"],
        "max_abs_err": max(e["max_abs_err"] for e in ntt_four),
        "ms": head4["ms"], "plain_ms": head4["plain_ms"],
        "bound_ms": head4["bound_ms"], "bound_by": head4["bound_by"],
        "library_ms": None, "shape": f"n=2^{NTT_PLAIN_MAX} over BN254 Fr, forward",
        "device_ms": head4["device_ms"], "split": head4["split"],
        **{k: head4[k] for k in ("paired_ms", "prev_ms", "prev_device_ms")
           if k in head4},
        "launches_protogalaxy": pg_counts["ntt_fourstep"],
        "launches_dryrun": dry_counts["ntt_fourstep"],
        "at": ntt_four,
    })
    head9 = next(e for e in ntt_stage if e["launches_per_call"] == 1)
    kernels.append({
        "name": "ntt_stage", "route": "cuda",
        "source": "mira_tpu_torch/csrc/ntt_stage.cu",
        "replaces": "mira_tpu/ops/ntt.py:120",
        "launches": ntt_counts["ntt_stage"],
        "launches_protogalaxy": pg_counts["ntt_stage"],
        "launches_per_prove": [c["ntt_stage"] for c in pg_prove_counts],
        "launches_dryrun": dry_counts["ntt_stage"],
        "max_abs_err": max(e["max_abs_err"] for e in ntt_stage),
        "ms": head9["ms"], "plain_ms": head9["plain_ms"],
        "bound_ms": head9["bound_ms"], "bound_by": head9["bound_by"],
        "library_ms": None,
        "shape": f"one stage of n=2^{NTT_PLAIN_MAX} over BN254 Fr",
        "at": ntt_stage,
    })
    head10 = next(e for e in poseidon_at if e.get("log_n") == POSEIDON_SIZES[-1])
    kernels.append({
        "name": "poseidon", "route": "cuda",
        "source": "mira_tpu_torch/csrc/poseidon.cu",
        "replaces": "mira_tpu/ops/pallas_poseidon.py:229",
        "launches": poseidon_counts["poseidon"],
        "max_abs_err": max(e["max_abs_err"] for e in poseidon_at),
        "ms": head10["ms"], "plain_ms": head10["plain_ms"],
        "bound_ms": head10["bound_ms"], "bound_by": head10["bound_by"],
        "library_ms": None,
        "shape": f"N=2^{POSEIDON_SIZES[-1]} 2-to-1 hashes, t=3 rate=2 r_f=r_p=10, "
                 "BN254 Fr",
        "device_ms": head10["device_ms"], "route_taken": head10["route"],
        "crossover": poseidon_cross,
        **{k: head10[k] for k in ("paired_ms", "prev_ms", "prev_device_ms")
           if k in head10},
        "at": poseidon_at,
    })
    kernels[0]["launches_protogalaxy"] = pg_counts["msm_bucket"]
    kernels[1]["launches_protogalaxy"] = pg_counts["fold_eval"]

    if args.profile:
        t0 = time.perf_counter()
        profile_fold_step(torch, ivc, args.profile)
        phase("profile", t0)
    del ivc, pp, ck, ck1, ck2, P, s, s21, P21, fe_state, ev, w1, w2

    # -- the Merkle CLI at k=17 (mock keys) ------------------------------------
    t0 = time.perf_counter()
    merkle_secs, merkle_counts = run_merkle_cli(torch, dev)
    phase("merkle_cli", t0)

    # -- SnarkStar batch 1 at k=19 with real Groth16 proofs -------------------
    t0 = time.perf_counter()
    snark_counts, report = run_snarkstar(torch, dev, 1, SNARK_STEPS)
    phase("snarkstar", t0)
    for k in kernels:
        if k["name"] in MSM_PATH_KERNELS:
            k["launches_snarkstar"] = snark_counts[k["name"]]

    # the kernels at SnarkStar's shapes: its tables (the k=19 delta widths
    # and cross-term widths, both curves) and its fold evaluators over 2^19
    # rows, on the structures and keys the run used
    t0 = time.perf_counter()
    pp_s = report.pop("ivc").pp
    pending = []  # their kernel times, taken once the worker is done
    for side in (pp_s.primary, pp_s.secondary):
        shapes = [sh for sh in report["tables"][side.ck.curve.name]
                  if sh not in early]
        m, t = fixed_checks(torch, dev, rng, side.ck, shapes, "snarkstar",
                            defer=pending)
        kernels[2]["at"] += m
        kernels[3]["at"] += t
        check_fold_eval(torch, dev, rng, side.S)
        kernels[1].setdefault("at", []).append(
            {"path": "snarkstar", "curve": side.ck.curve.name, "nrow": 1 << side.S.k,
             "max_abs_err": 0})
    del pp_s, report, side
    phase("snarkstar_kernel_checks", t0)

    kernels[1]["at"].append({"path": "tensorstar", "nrow": 1 << 22,
                             "rows": "ranges", "max_abs_err": 0})

    # -- SnarkStar batch 2 at k=20 with real Groth16 proofs, in the worker --
    t0 = time.perf_counter()
    b2 = b2_job.get()
    b2_counts = b2["counts"]
    log(f"snarkstar batch 2 (process): {time.perf_counter() - t_b2:.1f} s from its "
        f"submission to its result; phases (s) {json.dumps(b2['secs'])}")
    phase("snarkstar_b2_wait", t0)
    # the kernel times at both batches' shapes, each process's while the
    # other waits
    t0 = time.perf_counter()
    for times in pending:
        times()
    b2.update(ts_pool.apply_async(snarkstar_b2_times).get())
    for k, name in zip(kernels[1:4], ("fold_eval", "msm_fixed", "fixed_table")):
        k["at"] += b2[name]
    for k in kernels[2:4]:
        k["max_abs_err"] = max(a["max_abs_err"] for a in k["at"])
    phase("snarkstar_kernel_times", t0)
    for k in kernels:
        for path, counts in (("tensorstar", ts_counts), ("snarkstar_b2", b2_counts),
                             ("checkpoint", ckpt_counts), ("merkle_cli", merkle_counts)):
            if counts.get(k["name"]):
                k[f"launches_{path}"] = counts[k["name"]]
    log("new paths: " + json.dumps({
        "tensorstar_s": ts_secs, "checkpoint_s": ckpt_secs, "merkle_cli_s": merkle_secs}))

    if "jax" in sys.modules or "mira_tpu" in sys.modules:
        raise AssertionError("jax or mira_tpu was imported")
    # the kernels by what they lose against their bound over this run's paths
    lost = {}
    for k in kernels:
        n = sum(v for key, v in k.items() if key.startswith("launches")
                and isinstance(v, int))
        lost[k["name"]] = (n * (k["ms"] - k["bound_ms"]), n)
    log("ms lost to the bound, launches x (ms - bound_ms) over the paths, "
        "largest first: " + json.dumps(
            {name: [round(v, 3), n] for name, (v, n) in
             sorted(lost.items(), key=lambda kv: -kv[1][0])}))
    # the same over the two default-configuration paths alone (the k=17 fold
    # steps and SnarkStar's run), which rank the kernels to redesign
    main = {k["name"]: ((k["launches"] + k["launches_snarkstar"])
                        * (k["ms"] - k["bound_ms"]),
                        [k["launches"], k["launches_snarkstar"]])
            for k in kernels if k["name"] in MSM_PATH_KERNELS}
    log("ms lost on the main path, launches (k=17 fold steps, SnarkStar) x "
        "(ms - bound_ms), largest first: " + json.dumps(
            {name: [round(v, 3), n] for name, (v, n) in
             sorted(main.items(), key=lambda kv: -kv[1][0])}))
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
