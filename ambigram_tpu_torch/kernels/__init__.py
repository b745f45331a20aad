"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``ambigram_tpu_torch/csrc/<name>.cu`` with a plain C
interface. ``load(name)`` compiles it with nvcc for ``sm_90a`` into a
shared library under ``ambigram_tpu_torch/_build/`` at first use and
opens it with ctypes; the library's file name carries a hash of the
source and the flags, so an edited source is rebuilt. Nothing is built
when a module is imported: the CPU tests import every module, and a CPU
host has no nvcc. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# one lock per kernel, so two kernels build concurrently (one nvcc each)
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()
# per kernel: {"seconds": build wall time (0.0 when the library was
# already built), "log": nvcc's output (ptxas register/spill report),
# "path": the shared library}
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def build(src: str, so: str) -> dict:
    """Compile the CUDA source `src` into the shared library `so` with
    nvcc; {"seconds", "log"} of the build. Raises with nvcc's output when
    the build fails."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    info = {"seconds": time.perf_counter() - t0, "log": (proc.stdout + proc.stderr).strip()}
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed to build %s (exit %d): %s\n%s" % (src, proc.returncode, " ".join(cmd), info["log"])
        )
    os.replace(tmp, so)
    return info


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, name + ".cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        so = os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, digest.hexdigest()[:16]))
        info = {"seconds": 0.0, "log": "", "path": so}
        if not os.path.exists(so):
            info.update(build(src, so))
        lib = ctypes.CDLL(so)
        BUILD_INFO[name] = info
        _LIBS[name] = lib
        return lib
