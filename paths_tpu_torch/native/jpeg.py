"""ctypes binding for the port's native batched JPEG decoder (`jpegdec.cpp`;
counterpart of `paths_tpu.native.jpeg`).

Decode is the true WSI-preprocessing bottleneck on production hosts (the
reference pipeline fans decode over 32 processes). This module decodes a
batch of compressed tiles in one GIL-free native call, OpenMP-parallel,
straight into one contiguous uint8 array. Callers
(`preprocess.wsi.TiledJpegWSI`) fall back to PIL when the library is not
built (`python -m paths_tpu_torch.native.build`).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from paths_tpu_torch.native.build import library_path

_lib: Optional[ctypes.CDLL] = None


def load() -> Optional[ctypes.CDLL]:
    """The loaded decoder library, or None while it is not built (or libjpeg
    is missing at run time)."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path("jpeg")
    if not os.path.isfile(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:        # e.g. libjpeg missing at run time
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i64, i64p = ctypes.c_int64, np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.jpeg_decode_batch.restype = ctypes.c_int64
    lib.jpeg_decode_batch.argtypes = [u8p, i64p, i64, u8p, i64, i64, i32p,
                                      ctypes.c_uint8]
    lib.jpeg_header_dims.restype = ctypes.c_int32
    lib.jpeg_header_dims.argtypes = [u8p, i64, i32p]
    lib.jpeg_omp_thread_count.restype = ctypes.c_int
    lib.jpeg_omp_thread_count.argtypes = []
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def header_dims(buf: bytes) -> Optional[Tuple[int, int]]:
    """(h, w) from a JPEG header, or None on error / library missing."""
    lib = load()
    if lib is None:
        return None
    arr = np.frombuffer(buf, np.uint8)
    dims = np.empty(2, np.int32)
    if lib.jpeg_header_dims(arr, arr.size, dims) != 0:
        return None
    return int(dims[0]), int(dims[1])


def decode_batch(bufs: Sequence[bytes], out_hw: Tuple[int, int],
                 pad: int = 255) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode JPEG byte strings into one (n, H, W, 3) uint8 array.

    Each image is placed top-left in its slot, the remainder `pad`-filled
    (the WSI out-of-bounds-is-white contract). Returns (out, dims) where
    dims is (n, 2) int32 actual sizes, (-1, -1) marking failed slots, or
    None when the native library is not built (callers fall back to PIL).
    Images larger than `out_hw` count as failures.
    """
    lib = load()
    if lib is None:
        return None
    n = len(bufs)
    h, w = int(out_hw[0]), int(out_hw[1])
    out = np.empty((n, h, w, 3), np.uint8)
    dims = np.empty((n, 2), np.int32)
    if n == 0:
        return out, dims
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in bufs], out=offsets[1:])
    blob = np.empty(int(offsets[-1]) if offsets[-1] else 1, np.uint8)
    for i, b in enumerate(bufs):
        blob[int(offsets[i]): int(offsets[i + 1])] = np.frombuffer(b, np.uint8)
    lib.jpeg_decode_batch(blob, offsets, n, out.reshape(-1), h, w,
                          dims.reshape(-1), pad)
    return out, dims
