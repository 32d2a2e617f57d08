"""Build a CUDA source of `csrc/` into a shared library and load it.

`nvcc` compiles one `.cu` file with a plain C interface for Hopper
(`sm_90a`) into `p3achygo_tpu_torch/_build/`, at first use; the library is
named after a hash of its source and flags, so an edited source rebuilds and
an unchanged one is loaded as it is. Nothing here runs at import time and
nothing needs CUDA until `load_library` is called.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, Tuple[ctypes.CDLL, float]] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of p3achygo_tpu_torch "
                       "are built at first use and need the CUDA toolkit")


def load_library(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` (if not yet built) and return the CDLL."""
    lib = _LOADED.get(source)
    if lib is not None:
        return lib[0]
    src_path = os.path.join(CSRC_DIR, source)
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    so_path = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:12]}.so")
    seconds = 0.0
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src_path],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        seconds = time.perf_counter() - t0
    cdll = ctypes.CDLL(so_path)
    _LOADED[source] = (cdll, seconds)
    return cdll


def build_seconds(source: str) -> float:
    """Seconds the first `load_library(source)` of this process spent in
    nvcc (0.0 when the library was already built)."""
    return _LOADED[source][1]
