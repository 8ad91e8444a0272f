"""Builds the package's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for sm_90a into `_build/<name>_<hash of the source>.so` (so an edit
rebuilds), then loaded with ctypes. Nothing is compiled when the package is
imported; a machine without `nvcc` can import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}
# name -> {"path", "seconds" (0.0 when the library was already built),
#          "log" (what nvcc printed: registers, shared memory, spills)}
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
        "kernels of potato_tpu_torch cannot be built here")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def build_library(name: str) -> str:
    """Compile csrc/<name>.cu if its current source has not been built yet;
    returns the path of the shared library."""
    src = source_path(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")
    log_path = out + ".log"
    if os.path.exists(out):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        build_info[name] = {"path": out, "seconds": 0.0, "log": log}
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, out)   # atomic: a concurrent build never loads half a file
    build_info[name] = {"path": out, "seconds": seconds, "log": log}
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(build_library(name))
    return lib
