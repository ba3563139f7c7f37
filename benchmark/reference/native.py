"""The reference's frozen host libraries (msm.cpp, keygen.cpp), each built
with g++, and its one CUDA library (keygen.cu), built with nvcc: each into a
fixed directory of the checkout on first use, again when its source is
newer."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), ".build")
_lock = threading.Lock()
_libs = {}


def _load(src: str, so: str, cmd) -> ctypes.CDLL:
    """`so` built from `src` by `cmd + [src, "-o", out]` unless it is newer."""
    if so not in _libs:
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.part"
            subprocess.run([*cmd, src, "-o", tmp], check=True)
            os.replace(tmp, so)
        _libs[so] = ctypes.CDLL(so)
    return _libs[so]


def library(name: str) -> ctypes.CDLL:
    """reference/<name>.cpp as a loaded shared library."""
    with _lock:
        return _load(os.path.join(HERE, f"{name}.cpp"),
                     os.path.join(BUILD_DIR, f"libref_{name}.so"),
                     ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"])


def nvcc() -> Optional[str]:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return path if os.path.exists(path) else None


def cuda_library(name: str) -> Optional[ctypes.CDLL]:
    """reference/<name>.cu as a loaded shared library, None without nvcc."""
    compiler = nvcc()
    if compiler is None:
        return None
    with _lock:
        return _load(os.path.join(HERE, f"{name}.cu"),
                     os.path.join(BUILD_DIR, f"libref_{name}_cuda.so"),
                     [compiler, "-O3", "-arch=sm_90a", "-std=c++17", "-shared",
                      "-Xcompiler", "-fPIC"])
