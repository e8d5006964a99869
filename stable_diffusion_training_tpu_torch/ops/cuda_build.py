"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each library is compiled from ``csrc/`` at first use into ``_build/`` (listed
in ``.gitignore``), under a directory named by a hash of its sources and
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. The libraries export plain C functions (no PyTorch headers), which keeps
a build to seconds. Nothing here runs at import time: a machine without
``nvcc`` imports the package and uses the kernels' plain versions on CPU
tensors.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, compiler output) of the build this process ran, if any
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the CUDA "
            "kernels build only on a machine with the CUDA toolkit"
        )
    return path


def library_path(name: str, sources: Sequence[str]) -> str:
    digest = hashlib.sha256()
    for flag in NVCC_FLAGS:
        digest.update(flag.encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for src in (*sources, *headers):  # every header: a source may include any
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}", f"lib{name}.so")


def build(name: str, sources: Sequence[str]) -> str:
    """Compile ``sources`` (file names under ``csrc/``) into a shared
    library unless a build of the same sources exists; returns its path."""
    return build_many({name: sources})[name]


def build_many(libraries: Dict[str, Sequence[str]]) -> Dict[str, str]:
    """Build several libraries at once: one ``nvcc`` per library that is not
    built yet, all started together, then waited for. Returns each path."""
    paths = {name: library_path(name, srcs) for name, srcs in libraries.items()}
    running = {}
    for name, srcs in libraries.items():
        path = paths[name]
        if os.path.exists(path) or name in running:
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp]
        cmd += [os.path.join(CSRC_DIR, s) for s in srcs]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, start) in running.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {name}:\n{out}")
            continue
        os.replace(tmp, paths[name])  # atomic: a concurrent loader sees all or nothing
        BUILD_LOG[name] = (seconds, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name, sources))
        _LOADED[name] = lib
    return lib
