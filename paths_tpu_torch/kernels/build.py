"""Build the port's CUDA kernels into shared libraries and load them.

Each `csrc/*.cu` source compiles with `nvcc -gencode
arch=compute_90a,code=sm_90a` into its own shared library with a plain C
interface, loaded through ctypes. Libraries go to `paths_tpu_torch/_build/`
(listed in `.gitignore`) under a name that carries a hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads at once.
A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
# kernel name -> source under the package
SOURCES = {"flash_attention": "csrc/flash_attention.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# kernel name -> nvcc's output of the build made by this process (ptxas
# registers / spills), for the chip script to print
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> str:
    src = os.path.join(_PKG, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one `nvcc`
    each, all started together. Returns name -> library path."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not os.path.isfile(paths[n])]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_PKG, SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{log}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _loaded[name] = lib
        return lib
