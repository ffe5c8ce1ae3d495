"""Build the port's native host libraries:

    python -m paths_tpu_torch.native.build

`tablebuild.cpp` (the level-table builder) and `jpegdec.cpp` (the batched
JPEG decoder, linked against libjpeg) compile with g++ into
`paths_tpu_torch/_build/` (listed in `.gitignore`), each under a name that
carries a hash of its source and flags, so an edited source is never loaded
stale. `build_*` always runs g++ (the flags hold `-march=native`, so a
library is built on the host that loads it); a library function never
builds: `native.load` and `native.jpeg.load` load what is there and report
None otherwise, and callers take the numpy path or PIL. A decoder build that
fails (no libjpeg headers) is reported on stderr and returns None.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(SRC_DIR), "_build")
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17"]
# library -> (source, link flags)
LIBRARIES: Dict[str, Tuple[str, List[str]]] = {
    "host": ("tablebuild.cpp", []),
    "jpeg": ("jpegdec.cpp", ["-ljpeg"]),
}
# library -> the g++ command line of the last build in this process
commands: Dict[str, str] = {}
_paths: Dict[str, str] = {}


def library_path(name: str) -> str:
    """Where library `name` ("host" or "jpeg") is built: its file name
    carries a hash of the source and the flags."""
    path = _paths.get(name)
    if path is None:
        src, link = LIBRARIES[name]
        digest = hashlib.sha256(" ".join(CXX_FLAGS + link).encode())
        with open(os.path.join(SRC_DIR, src), "rb") as f:
            digest.update(f.read())
        path = os.path.join(BUILD_DIR,
                            f"libpaths_torch_{name}-{digest.hexdigest()[:12]}.so")
        _paths[name] = path
    return path


def _compile(name: str, verbose: bool) -> str:
    src, link = LIBRARIES[name]
    out = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, os.path.join(SRC_DIR, src), "-o", tmp, *link]
    commands[name] = " ".join(cmd)
    if verbose:
        print(commands[name])
    subprocess.run(cmd, check=True)
    os.replace(tmp, out)       # atomic: a concurrent loader sees all or none
    return out


def build(verbose: bool = True) -> str:
    """Build the table builder; raises if g++ fails."""
    return _compile("host", verbose)


def build_jpeg(verbose: bool = True) -> Optional[str]:
    """Build the batched JPEG decoder. A separate library, so hosts without
    libjpeg headers still get the table builder; returns None (and says so
    on stderr) when the toolchain cannot compile or link it: tile decode
    then goes through PIL."""
    try:
        return _compile("jpeg", verbose)
    except subprocess.CalledProcessError:
        print("libpaths_torch_jpeg skipped (libjpeg dev files not found); "
              "tile decode falls back to PIL", file=sys.stderr)
        return None


if __name__ == "__main__":
    from paths_tpu_torch import native
    from paths_tpu_torch.native import jpeg as njpeg

    print(f"Built {build()}")
    print(f"Loaded OK; OpenMP threads: {native.load().omp_thread_count()}")
    jpath = build_jpeg()
    if jpath:
        print(f"Built {jpath}; decode threads: "
              f"{njpeg.load().jpeg_omp_thread_count()}")
