"""Build the port's CUDA kernels into shared libraries and load them.

Each `csrc/*.cu` source compiles with `nvcc -gencode
arch=compute_90a,code=sm_90a` into its own shared library with a plain C
interface, loaded through ctypes. Libraries go to `paths_tpu_torch/_build/`
(listed in `.gitignore`) under a name that carries a hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads at once.
The hash also covers the shared headers (`csrc/*.cuh`). A failed build
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
# kernel name -> source under the package
SOURCES = {"flash_attention": "csrc/flash_attention.cu",
           "flash_attention_bwd": "csrc/flash_attention_bwd.cu",
           "vit_fused": "csrc/vit_fused.cu",
           "vit_int8": "csrc/vit_int8.cu"}
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
    for path in [os.path.join(_PKG, SOURCES[name])] + headers:
        with open(path, "rb") as f:
            digest.update(f.read())
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


def load_with_signatures(name: str,
                         signatures: Dict[str, Tuple[list, object]]) -> ctypes.CDLL:
    """`load(name)` with the C signatures `entry -> (argtypes, restype)` set:
    without them ctypes passes a pointer as a 32-bit int."""
    lib = load(name)
    for entry, (argtypes, restype) in signatures.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def launch(lib: ctypes.CDLL, entry: str, x, *args) -> None:
    """Call launch entry `entry` of `lib` with `args` and, last, the current
    stream of CUDA tensor x's device; raise if the launch was refused."""
    import torch

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.paths_cuda_error_string(rc).decode())
