"""ctypes bindings for the port's native host kernels (`tablebuild.cpp`;
counterpart of `paths_tpu.native`).

`load()` returns the shared library handle, or None when it is not built;
callers (`engine.tables.build_level_table`) then take the numpy path. Build
with:

    python -m paths_tpu_torch.native.build

The library is loaded by its full path with ctypes' default RTLD_LOCAL, so
its symbols never mix with another library's of the same names.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None


def load() -> Optional[ctypes.CDLL]:
    """The loaded table-builder library, or None while it is not built."""
    global _lib
    if _lib is not None:
        return _lib
    # imported here: `python -m paths_tpu_torch.native.build` imports this
    # package first, and must find its module not yet loaded
    from paths_tpu_torch.native.build import library_path

    path = library_path("host")
    if not os.path.isfile(path):
        return None
    lib = ctypes.CDLL(path)
    i64, i32p, f32p, u8p = (ctypes.c_int64,
                            np.ctypeslib.ndpointer(np.int32, flags="C"),
                            np.ctypeslib.ndpointer(np.float32, flags="C"),
                            np.ctypeslib.ndpointer(np.uint8, flags="C"))
    lib.build_level_table.restype = ctypes.c_int64
    lib.build_level_table.argtypes = [f32p, i64, i64, i64, f32p, i32p, i32p, i64]
    lib.scan_background.restype = ctypes.c_int64
    lib.scan_background.argtypes = [f32p, i64, i64, u8p]
    lib.omp_thread_count.restype = ctypes.c_int
    lib.omp_thread_count.argtypes = []
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def build_level_table_native(grid: np.ndarray, min_rows: int = 0) -> Optional[dict]:
    """Native equivalent of `engine.tables.build_level_table_numpy`; None
    when the library is not built or the grid is not float32."""
    lib = load()
    if lib is None or grid.dtype != np.float32:
        # non-f32 grids (float16 stores) take the numpy path: the C kernels
        # are f32-only, and an upcast here would widen the table dtype
        # downstream (the tables ship at their host dtype)
        return None
    grid = np.ascontiguousarray(grid)
    h, w, d = grid.shape
    cells = h * w

    # exact m: count + background fill up to min_rows (the numpy sizing)
    bg = np.empty(cells, np.uint8)
    count = int(lib.scan_background(grid.reshape(-1, d), cells, d, bg))
    n_bg = cells - count
    m = max(count + min(n_bg, max(min_rows - count, 0)), min_rows, count)

    fts = np.zeros((m, d), np.float32)
    locs = np.zeros((m, 2), np.int32)
    index = np.empty((h, w), np.int32)
    lib.build_level_table(grid.reshape(-1, d), h, w, d,
                          fts, locs, index.reshape(-1), m)
    return {"fts": fts, "locs": locs, "count": np.int32(count),
            "index": index, "grid_hw": np.array([h, w], np.int32)}
