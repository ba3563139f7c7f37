"""Measurements behind the four-step NTT kernel's rules, on one NVIDIA GPU:

    python3 -m mira_tpu_torch.bench.ntt_micro [--against FILE]

Prints the device time per transform (chip_smoke.py's `device_ms`: CUDA
events around calls queued behind a sleep on the card) of
csrc/ntt_fourstep.cu over BN254 Fr at 2^14..2^24 on the rule's cut and
radix (`fourstep_split`, `fourstep_radix`), on the other cut where the
kernel takes one (two passes below 2^21) and at the other radix (2 or 4
elements a thread), beside the stage kernel; then the same source built
with room for two and for four tiles an SM (its launch bounds) against the
tree's three, in turns, at 2^16..2^24.  `--against FILE` builds FILE,
another csrc/ntt_fourstep.cu with the same C interface, and times it in
turns with the tree's at 2^16..2^24.  Every result is held to the rule's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from .. import _build

HERE = os.path.dirname(os.path.abspath(__file__))
BOUNDS = "__launch_bounds__(MAX_THREADS, 3)"  # the tree's tiles an SM


def _library(name: str, src: str):
    """`src`, the text of a csrc/ntt_fourstep.cu, built beside the tree's
    field.cuh as a library whose mira_ntt_pass stands in for the tree's."""
    vdir = os.path.join(_build.BUILD, "ntt_micro")
    os.makedirs(vdir, exist_ok=True)
    path = os.path.join(vdir, f"{name}.cu")
    open(path, "w").write(src)
    shutil.copy(os.path.join(_build.CSRC, "field.cuh"), vdir)
    so = os.path.join(vdir, f"lib{name}.so")
    for line in _build._build(so, [path]).splitlines():
        if "registers" in line or "spill" in line:
            print(f"{name} ptxas: {line.strip()}")
    lib = ctypes.CDLL(so)
    lib.mira_ntt_pass.argtypes = _build._SIGNATURES["mira_ntt_pass"]
    lib.mira_ntt_pass.restype = ctypes.c_int
    return lib


def _tiles(tiles: int):
    """The tree's kernel built with room for `tiles` tiles an SM."""
    src = open(os.path.join(_build.CSRC, "ntt_fourstep.cu")).read()
    if BOUNDS not in src:
        raise RuntimeError("ntt_micro: the kernel's launch bounds moved")
    return _library(f"ntt_tiles{tiles}",
                    src.replace(BOUNDS, f"__launch_bounds__(MAX_THREADS, {tiles})"))


def _at_radix(a, p, split, radix):
    """`cuda_ntt._fourstep` forward with the passes of `radix` (1 or 2):
    a callable of one transform, its launch arguments built once."""
    from ..ops import cuda_ntt

    log_n = a.shape[-2].bit_length() - 1
    passes = cuda_ntt.fourstep_passes(log_n, split, radix)
    tables = cuda_ntt.fourstep_tables(p, log_n, split, False, str(a.device))
    params = [(ctypes.c_longlong * len(cuda_ntt.PASS_FIELDS))(
        *(par[f] for f in cuda_ntt.PASS_FIELDS)) for par in passes]
    bufs = [torch.empty_like(a), torch.empty_like(a)]
    stream = _build.stream_ptr(a.device)

    def run():
        src = a
        for i, (par, tabs) in enumerate(zip(params, tables)):
            dst = bufs[(len(params) - 1 - i) % 2]
            _build.check(_build.lib().mira_ntt_pass(
                _build.field_id(p), src.data_ptr(), dst.data_ptr(),
                ctypes.addressof(par), *(t.data_ptr() for t in tabs), 1, stream),
                "ntt_fourstep")
            src = dst
        return src

    return run


def _in_turns(cs, libs: dict, inputs: dict, label: str):
    """Each library of `libs` as the tree's in turns (forward, back), at
    2^16..2^24, each held to the tree's result (`cs`: chip_smoke, for its
    `device_ms`)."""
    from ..fields.params import BN254_FR
    from ..ops import ntt

    tree = _build.lib()
    order = list(libs) + list(libs)[::-1]
    for log_n in (16, 18, 20, 22, 24):
        a = inputs[log_n]
        want = ntt.ntt(a, BN254_FR)
        reps = 5 if log_n >= 23 else 20
        row = {}
        for key in order:
            _build._lib = libs[key]
            fn = lambda: ntt.ntt(a, BN254_FR)
            if not torch.equal(fn(), want):
                _build._lib = tree
                raise AssertionError(f"2^{log_n}: {label} {key} != rule")
            row.setdefault(key, []).append(round(cs.device_ms(fn, reps), 4))
        _build._lib = tree
        print(f"2^{log_n} device ms by {label} (in turns): {json.dumps(row)}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="FILE",
                    help="another csrc/ntt_fourstep.cu to time in turns with "
                         "the tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ntt_micro: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import chip_smoke as cs

    from ..fields.limbs import limb_field
    from ..fields.params import BN254_FR
    from ..ops import cuda_ntt, ntt

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    tree = _build.lib()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    p = BN254_FR
    lf = limb_field(p)
    inputs = {}
    for log_n in range(14, 25):
        a = inputs[log_n] = lf.from_plain(cs._random_plain(rng, 1 << log_n, dev))
        want = ntt.ntt(a, p)
        reps = 5 if log_n >= 23 else 20
        split = cuda_ntt.fourstep_split(log_n)
        radix = cuda_ntt.fourstep_radix(log_n)
        row = {"rule": [list(split), radix],
               "rule_ms": round(cs.device_ms(lambda: ntt.ntt(a, p), reps), 4)}
        cuts = [split]
        if log_n < cuda_ntt.THREE_PASS_MIN_LOG:
            cuts.append(cuda_ntt.fourstep_split(log_n, 5 - len(split)))
        for cut in cuts:
            for r in (1, 2):
                if cut == split and r == radix:
                    continue
                fn = _at_radix(a, p, cut, r)
                if not torch.equal(fn(), want):
                    raise AssertionError(f"2^{log_n} {cut} radix {r} != rule")
                R = cuda_ntt.fourstep_passes(log_n, cut, r)[0]["R"]
                row[f"{list(cut)} R={R}"] = round(cs.device_ms(fn, reps), 4)
        row["stage"] = round(cs.device_ms(lambda: ntt.ntt(a, p, engine="stage"),
                                          reps), 4)
        print(f"2^{log_n} device ms: {json.dumps(row)}", flush=True)
    _in_turns(cs, {3: tree, 2: _tiles(2), 4: _tiles(4)}, inputs, "tiles an SM")
    if args.against:
        other = _library("ntt_against", open(args.against).read())
        _in_turns(cs, {"tree": tree, "against": other}, inputs,
                  f"source (against {args.against})")
    print(f"ntt_micro: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
