"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` by hand into ``build/lib<name>-<hash>.so`` on first use, then loaded
with ``ctypes``.  The file name carries a hash of the source and of every
``csrc/*.cuh`` header, so an edited kernel or header is never served from a
stale library.  Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import glob
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

# sm_90a, not sm_90: the `a` target admits wgmma/setmaxnreg for later kernels
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit")


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu`` and of every ``csrc/*.cuh`` header."""
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in [os.path.join(CSRC, f"{name}.cu"), *headers]:
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read() + b"\0")
    return h.hexdigest()[:12]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path.  nvcc's output (the ptxas register and
    shared-memory report) is kept beside it as ``.log``.  Builds of
    different kernels may run in parallel threads."""
    src = os.path.join(CSRC, f"{name}.cu")
    lib = os.path.join(BUILD, f"lib{name}-{source_digest(name)}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    with open(lib[:-3] + ".log", "w") as fh:
        fh.write(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, lib)           # atomic: a concurrent builder sees all or nothing
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            # compile-once build: the lock is held across build() so exactly
            # one thread runs nvcc; every other thread must wait for the
            # artifact, not race the compiler
            # graftlint: disable=GL006
            lib = _loaded[name] = ctypes.CDLL(build(name))
        return lib
