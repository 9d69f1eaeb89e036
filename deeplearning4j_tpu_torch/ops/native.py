"""Build and load the port's CUDA sources as plain-C shared libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ``_build/lib<name>-<hash>.so`` inside this package (the directory
is git-ignored) and loaded with ``ctypes``. The hash covers the source
and the compiler flags, so an edited source builds anew and an
unchanged one is loaded from the previous build. A file lock keeps two
processes from building the same library at once.

Nothing here runs at import: the CPU test suite imports every module of
the port on machines without ``nvcc``. A build runs at the first
launch of a kernel, or up front through :func:`build`, and a failed
build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: compiler output and seconds of every build this process ran, by name
#: (``-Xptxas -v`` lists each kernel's registers, shared memory, spills)
build_logs: Dict[str, Dict[str, object]] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (searched PATH and $CUDA_HOME/bin): the port's "
            "CUDA kernels are built on the machine with the card")
    return path


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> Dict[str, str]:
    """Build every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns name -> path."""
    paths = {n: library_path(n) for n in names}
    if all(os.path.exists(p) for p in paths.values()):
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
            t0 = time.perf_counter()
            procs = {
                n: subprocess.Popen(
                    [nvcc(), *NVCC_FLAGS, "-o", f"{p}.{os.getpid()}.tmp",
                     _source(n)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                for n, p in todo.items()}
            failed = []
            for n, proc in procs.items():
                out, _ = proc.communicate()
                build_logs[n] = {"seconds": time.perf_counter() - t0,
                                 "output": out}
                tmp = f"{todo[n]}.{os.getpid()}.tmp"
                if proc.returncode != 0:
                    failed.append(f"{_source(n)}:\n{out}")
                else:
                    os.replace(tmp, todo[n])
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (built first if needed), loaded once
    per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build([name])[name])
        return lib
