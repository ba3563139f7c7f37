"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` (in parallel, one process per file) and
links them into one shared library with a plain C interface,
`build/libmira_kernels-<digest>.so`, on first use; the digest of the
sources names the file, so an edited source builds anew.  The library is
loaded with ctypes; pointers and the stream go in as `c_void_p`.  Nothing
builds at import time: the CPU tests import every module on machines
without `nvcc`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last build in this process
build_log = ""  # ptxas report (registers, spills) of the last build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mira_field_test": [_I, _I, _I, _P, _P, _P, _P],
    "mira_msm_bucket_sort": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "mira_msm_bucket_seg": [_I, _I, _I],
    "mira_msm_bucket_acc": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "mira_msm_bucket_reduce": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "mira_msm_bucket_finish": [_I, _P, _I, _I, _P, _P],
    "mira_fold_eval": [_I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I,
                       _I, _P, _P],
    "mira_fold_eval_block": [_I, _I],
    "mira_msm_fixed_blocks": [_I, _I, _I, _I],
    "mira_msm_fixed_recode": [_P, _I, _I, _I, _P, _P],
    "mira_msm_fixed_acc": [_I, _I, _P, _P, _I, _I, _I, _P, _I, _P],
    "mira_msm_fixed_finish": [_I, _I, _P, _I, _I, _P, _P, _P, _P],
    "mira_fixed_table": [_I, _P, _P, _P, _I, _I, _P, _P, _P],
    "mira_ntt_stage": [_I, _P, _P, _P, _I, _I, _I, _P, _I, _P],
    "mira_ntt_pass": [_I, _P, _P, _P, _P, _P, _P, _I, _P],
    "mira_poseidon": [_I, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P],
    "mira_msm_pippenger_recode": [_P, _I, _I, _I, _P, _P],
    "mira_msm_pippenger_finish": [_I, _I, _P, _I, _I, _P, _P, _P, _P],
    "mira_field_lincomb": [_I, _P, _I, _P],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _run(cmd, what: str) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {what} ({res.returncode}):\n{res.stderr[-8000:]}")
    return res.stderr


def _build(so: str, sources) -> str:
    """Compile each .cu in its own nvcc process, all at once (one file's
    ptxas pass takes up to a minute), then link them into `so`.  Returns
    the ptxas report."""
    cus = [p for p in sources if p.endswith(".cu")]
    tmpdir = tempfile.mkdtemp(dir=BUILD)
    try:
        objs = [os.path.join(tmpdir, os.path.basename(p) + ".o") for p in cus]
        with ThreadPoolExecutor(len(cus)) as pool:
            logs = list(pool.map(
                lambda src, obj: _run(
                    [_nvcc(), *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v", "-c", src, "-o", obj], src),
                cus, objs))
        tmp = f"{so}.{os.getpid()}.tmp"
        _run([_nvcc(), *ARCH, "-shared", "-o", tmp, *objs], "the link")
        os.replace(tmp, so)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return "".join(logs)


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        digest = hashlib.sha256(
            b"".join(open(p, "rb").read() for p in srcs) + " ".join(ARCH).encode()
        ).hexdigest()[:16]
        so = os.path.join(BUILD, f"libmira_kernels-{digest}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD, exist_ok=True)
            t0 = time.perf_counter()
            build_log = _build(so, srcs)
            build_seconds = time.perf_counter() - t0
        handle = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
        return _lib


def field_id(modulus: int) -> int:
    """The kernels' `field` argument for a base-field modulus: 0 for BN254
    Fq (G1), 1 for BN254 Fr (Grumpkin).  Any other modulus raises, since
    the kernels know only these two."""
    from .fields.params import BN254_FQ, BN254_FR

    ids = {BN254_FQ: 0, BN254_FR: 1}
    if modulus not in ids:
        raise ValueError(f"no CUDA field for modulus {modulus:#x}")
    return ids[modulus]


def check(err: int, what: str):
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
