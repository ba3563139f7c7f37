"""The reference's frozen host libraries (msm.cpp, keygen.cpp): each built
with g++ into a fixed directory of the checkout on first use."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), ".build")
_lock = threading.Lock()
_libs = {}


def library(name: str) -> ctypes.CDLL:
    """reference/<name>.cpp as a loaded shared library."""
    with _lock:
        if name not in _libs:
            src = os.path.join(HERE, f"{name}.cpp")
            so = os.path.join(BUILD_DIR, f"libref_{name}.so")
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.part"
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                                src, "-o", tmp], check=True)
                os.replace(tmp, so)
            _libs[name] = ctypes.CDLL(so)
        return _libs[name]
