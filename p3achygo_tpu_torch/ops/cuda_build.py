"""Build the CUDA sources of `csrc/` into shared libraries and load them.

`nvcc` compiles each `.cu` file with a plain C interface for Hopper
(`sm_90a`) into `p3achygo_tpu_torch/_build/`, at first use; a library is
named after a hash of its source, the headers of `csrc/` and the flags, so
an edited source or header rebuilds and an unchanged one is loaded as it
is. `build_libraries` starts one `nvcc` per source, all at once, and waits
for them together. Nothing here runs at import time and nothing needs CUDA
until a library is asked for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, NamedTuple, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


class _Built(NamedTuple):
    lib: ctypes.CDLL
    seconds: float  # wall seconds nvcc took in this process (0.0: prebuilt)
    log: str  # nvcc's stderr (ptxas registers / shared memory / spills)


_LOADED: Dict[str, _Built] = {}


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


def built_path(source: str) -> str:
    """The library of `csrc/<source>`, named after a hash of the source,
    every header of `csrc/` (so an edited header rebuilds its includers)
    and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:12]}.so")


def build_libraries(sources: Sequence[str]) -> List[ctypes.CDLL]:
    """Compile every `csrc/<source>` not yet built, one nvcc process each,
    started together; return the loaded libraries in order."""
    todo = [s for s in dict.fromkeys(sources) if s not in _LOADED]
    procs = {}
    t0 = time.perf_counter()
    try:
        for source in todo:
            so_path = built_path(source)
            if os.path.exists(so_path):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC_DIR, source)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs[source] = (proc, tmp, so_path)
        logs, seconds = {}, {}
        for source, (proc, tmp, so_path) in procs.items():
            _, err = proc.communicate()
            seconds[source] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n{err}")
            os.replace(tmp, so_path)
            logs[source] = err
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    for source in todo:
        _LOADED[source] = _Built(ctypes.CDLL(built_path(source)),
                                 seconds.get(source, 0.0), logs.get(source, ""))
    return [_LOADED[s].lib for s in sources]


def load_library(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` (if not yet built) and return the CDLL."""
    built = _LOADED.get(source)
    if built is not None:
        return built.lib
    return build_libraries([source])[0]


def build_seconds(source: str) -> float:
    """Seconds from the start of the build that compiled `source` in this
    process to the end of its nvcc (0.0 when it was already built)."""
    return _LOADED[source].seconds


def build_log(source: str) -> str:
    """nvcc's stderr for `source` in this process ('' when prebuilt)."""
    return _LOADED[source].log
