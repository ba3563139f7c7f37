"""Microbenchmarks behind the MSM kernels' design, on one NVIDIA GPU:

    python3 -m mira_tpu_torch.bench.msm_micro

Builds bench/msm_micro.cu with nvcc (sm_90a) and prints: the SASS
instruction mix of one Montgomery product (field.cuh's, and a carry-chain
PTX version), both products' throughput over 270k threads, the one-thread
latency of an XYZZ doubling, a Jacobian doubling and a full XYZZ addition,
and the mixed-addition rate of a madd loop at four block shapes.  Then the
Poseidon sponge's building blocks (kernel 10, t = 3 over BN254 Fr): the
latency of one permutation of one hash on each route (a thread; the lanes
of a warp), and the thread route at 2^20 hashes with the library's
out-of-line product against the same code with the product inlined, in
turns.  Then it times the MSM kernels of the port at their head shapes per
launch with torch.profiler (kernels 1 and 4 at 2^17, kernels 3 and 3b at
248,533 points w=5 and 2^17 w=6, over points of a 2^18 key).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from .. import _build

HERE = os.path.dirname(os.path.abspath(__file__))
BN254_FQ = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47


def _build_micro() -> ctypes.CDLL:
    so = os.path.join(_build.BUILD, "libmsm_micro.so")
    os.makedirs(_build.BUILD, exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
                        os.path.join(HERE, "msm_micro.cu"), "-o", so],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr[-4000:])
    fn = None
    for line in r.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and "registers" in line:
            print(f"ptxas {fn}: {line.strip()}")
    sass = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
                           "-sass", so], capture_output=True, text=True).stdout
    hist, cur = collections.defaultdict(collections.Counter), None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(@!?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur:
            hist[cur][m.group(2)] += 1
    for fn in ("one_mul_cpp", "one_mul_ptx"):
        h = hist.get(fn, {})
        top = sorted(h.items(), key=lambda kv: -kv[1])[:12]
        print(f"SASS {fn} (one product, its loads and stores): {sum(h.values())} "
              "instructions; " + ", ".join(f"{k} {v}" for k, v in top))
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.run_chain.argtypes = [I, P, P, P, I, I]
    lib.run_one.argtypes = [I, P, P, P, I]
    lib.run_dbl.argtypes = [I, P, P, I]
    lib.run_madd.argtypes = [I, P, P, I, I]
    lib.occupancy.argtypes = [I]
    lib.run_poseidon_inline.argtypes = [P, P, I, I, I, I, P, I]
    return lib


def _events(fn) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def micro(lib, dev, rng):

    def rand_fe(n):
        vals = [int.from_bytes(rng.bytes(32), "little") % BN254_FQ for _ in range(n)]
        w = np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)] for v in vals],
                     dtype=np.uint32)
        return torch.from_numpy(w.view(np.int32)).to(dev)

    n = 132 * 2048
    a, b = rand_fe(4096).repeat(n // 4096, 1), rand_fe(4096).repeat(n // 4096, 1)
    outs = [torch.empty_like(a) for _ in range(2)]
    for v in (0, 1):
        _build.check(lib.run_one(v, a.data_ptr(), b.data_ptr(), outs[v].data_ptr(), n),
                     "run_one")
    torch.cuda.synchronize()
    print(f"PTX product == field.cuh's on {n} pairs: {torch.equal(*outs)}")
    for v in (0, 1, 0, 1):
        lib.run_chain(v, a.data_ptr(), b.data_ptr(), outs[0].data_ptr(), n, 10)
        ms = _events(lambda: lib.run_chain(v, a.data_ptr(), b.data_ptr(),
                                           outs[0].data_ptr(), n, 200))
        print(f"products ({'PTX' if v else 'field.cuh'}): {n * 200 / ms / 1e6:.2f} "
              f"G/s over {n} threads")
    pt = rand_fe(8)
    out = torch.empty_like(pt)
    for v, name in ((0, "xyzz_double"), (1, "jac_double"), (2, "xyzz_add")):
        lib.run_dbl(v, pt.data_ptr(), out.data_ptr(), 10)
        ms = _events(lambda: lib.run_dbl(v, pt.data_ptr(), out.data_ptr(), 2000))
        print(f"{name}: {ms / 2000 * 1e3:.3f} us per step in one thread")
    tab = rand_fe(2048).reshape(1024, 16)
    for cfg, blk in enumerate((256, 256, 256, 128)):
        nb = lib.occupancy(cfg)
        grid = nb * torch.cuda.get_device_properties(dev).multi_processor_count
        o = torch.empty(grid * blk, 8, dtype=torch.int32, device=dev)
        lib.run_madd(cfg, tab.data_ptr(), o.data_ptr(), grid, 10)
        ms = _events(lambda: lib.run_madd(cfg, tab.data_ptr(), o.data_ptr(), grid, 100))
        print(f"madd loop, {nb} blocks of {blk} an SM: {grid * blk * 100 / ms / 1e6:.3f} "
              "G madd/s")


def poseidon_micro(lib, dev, rng):
    """Kernel 10's latency per permutation on each route, one 2-to-1-width
    hash (t = 3) of 400 inputs (201 permutations), and the thread route at
    2^20 hashes with the product out of line (the library) and inlined."""
    from ..fields.limbs import limb_field
    from ..fields.params import BN254_FR
    from ..ops import cuda_poseidon

    p = BN254_FR
    lf = limb_field(p)

    def rand(n):
        vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
        return lf.encode(vals, dev)

    one = rand(400).reshape(1, 400, 8)
    for route in cuda_poseidon.ROUTES:
        fn = lambda: cuda_poseidon._launch(one, p, 3, 2, 10, 10, route)
        fn()
        ms = _events(lambda: [fn() for _ in range(5)]) / 5
        print(f"poseidon permutation, one hash on the {route} route: "
              f"{ms / 201 * 1e3:.2f} us")
    consts = cuda_poseidon._constants(p, 3, 2, 10, 10, str(dev))

    def inline(values):
        out = torch.empty(values.shape[0], 8, dtype=torch.int32, device=dev)
        _build.check(lib.run_poseidon_inline(
            values.data_ptr(), out.data_ptr(), values.shape[0], values.shape[1],
            10, 10, consts.data_ptr(), consts.shape[0]), "run_poseidon_inline")
        return out

    inline(one)
    ms = _events(lambda: [inline(one) for _ in range(5)]) / 5
    print(f"poseidon permutation, one hash on the thread route, product "
          f"inlined: {ms / 201 * 1e3:.2f} us")
    pairs = torch.cat([rand(1 << 12)] * (1 << 9)).reshape(1 << 20, 2, 8)
    call = lambda: cuda_poseidon._launch(pairs, p, 3, 2, 10, 10, "thread")
    if not torch.equal(call(), inline(pairs)):
        raise AssertionError("poseidon: the inlined product's hashes differ")
    times = {"call": [], "inline": []}
    for name in ("call", "inline", "inline", "call"):
        fn = call if name == "call" else lambda: inline(pairs)
        fn()
        times[name].append(_events(lambda: [fn() for _ in range(5)]) / 5)
    print("poseidon 2^20 hashes, thread route, in turns (ms): "
          + ", ".join(f"{k} {v}" for k, v in times.items()))


def profile_msms(dev, rng):
    from torch.profiler import ProfilerActivity, profile

    from ..curves.host import BN254_G1
    from ..ops import cuda_msm
    from ..ops.commitment import CommitmentKey

    ck = CommitmentKey.load_or_setup_cache(BN254_G1, 18, "bn256", device=dev)

    def scalars(n):
        w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
        w[:, 7] &= 0x1FFFFFFF
        return torch.from_numpy(w.view(np.int32)).to(dev)

    cases = []
    P17, s17 = ck._enc_slice(1 << 17), scalars(1 << 17)
    cases.append(("msm_bucket 2^17", lambda: cuda_msm.msm_cuda(s17, P17, BN254_G1)))
    cases.append(("msm_pippenger 2^17",
                  lambda: cuda_msm.msm_pippenger_cuda(s17, P17, BN254_G1)))
    for n, w in ((248533, 5), (1 << 17, 6)):
        Pn, sn = ck._enc_slice(n), scalars(n)
        tab = cuda_msm.fixed_table_cuda(Pn, BN254_G1, w)
        cases.append((f"fixed_table {n} w={w}",
                      lambda P=Pn, w=w: cuda_msm.fixed_table_cuda(P, BN254_G1, w)))
        cases.append((f"msm_fixed {n} w={w}",
                      lambda s=sn, t=tab, w=w: cuda_msm.msm_fixed_cuda(s, t, BN254_G1, w)))
    for name, fn in cases:
        fn()
        ms = _events(lambda: [fn() for _ in range(5)]) / 5
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        print(f"{name}: {ms:.3f} ms a call (CUDA events); per launch:")
        for ev in pr.key_averages():
            dt = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            if dt and ev.count and ev.key.startswith("void"):
                print(f"    {ev.key[:72]:72s} x{ev.count // 3} {dt / ev.count / 1e3:.3f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()
    if not torch.cuda.is_available():
        print("msm_micro: no CUDA device visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    lib = _build_micro()
    micro(lib, dev, rng)
    poseidon_micro(lib, dev, rng)
    profile_msms(dev, rng)
    print(f"msm_micro: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
