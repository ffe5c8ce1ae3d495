"""ctypes bindings for the host's `libzstd` (no Python zstd package).

The Orbax reader (`train/ocdbt.py`) needs it: tensorstore compresses the
OCDBT manifests, b-tree nodes and (through zarr's `zstd` compressor) the
array chunks of a JAX-written checkpoint. The library is found with
`ctypes.util.find_library("zstd")`, else as `libzstd.so.1`. Where it is
absent, `decompress` and `compress` raise `ZstdUnavailable`, which names the
library. There is no pure-Python fallback. The port's own Orbax writer
(`train/orbax.py`) compresses nothing, so it needs no libzstd.

    decompress(frame, size=None) -> bytes   # one or more concatenated frames
    compress(data, level=1) -> bytes        # one frame
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Optional


class ZstdUnavailable(RuntimeError):
    """libzstd is not on this host."""


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def find_library() -> Optional[str]:
    """The name ctypes loads libzstd by, or None where the host lacks it."""
    name = ctypes.util.find_library("zstd")
    if name:
        return name
    try:
        ctypes.CDLL("libzstd.so.1")
    except OSError:
        return None
    return "libzstd.so.1"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    name = find_library()
    if name is None:
        raise ZstdUnavailable(
            "libzstd (the zstd shared library, libzstd.so.1) was not found on "
            "this host; the Orbax checkpoint reader needs it to read "
            "JAX-written (zstd-compressed) checkpoints")
    lib = ctypes.CDLL(name)
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_compressBound.argtypes = [size_t]
    lib.ZSTD_compressBound.restype = size_t
    lib.ZSTD_compress.argtypes = [vp, size_t, vp, size_t, ctypes.c_int]
    lib.ZSTD_compress.restype = size_t
    lib.ZSTD_createDStream.argtypes = []
    lib.ZSTD_createDStream.restype = vp
    lib.ZSTD_freeDStream.argtypes = [vp]
    lib.ZSTD_freeDStream.restype = size_t
    lib.ZSTD_initDStream.argtypes = [vp]
    lib.ZSTD_initDStream.restype = size_t
    lib.ZSTD_decompressStream.argtypes = [vp, ctypes.POINTER(_OutBuffer),
                                          ctypes.POINTER(_InBuffer)]
    lib.ZSTD_decompressStream.restype = size_t
    return lib


def available() -> bool:
    try:
        _lib()
    except ZstdUnavailable:
        return False
    return True


def _check(lib, rc: int, what: str) -> int:
    if lib.ZSTD_isError(rc):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(rc).decode()}")
    return rc


def decompress(frame: bytes, size: Optional[int] = None) -> bytes:
    """The data of `frame` (zstd frames back to back). `size`, where known,
    sizes the output buffer; the frames' content size need not be stored."""
    lib = _lib()
    frame = bytes(frame)
    src = ctypes.create_string_buffer(frame, len(frame))
    cap = max(size or 4 * len(frame), 64)
    dst = ctypes.create_string_buffer(cap)
    inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(frame), 0)
    outb = _OutBuffer(ctypes.cast(dst, ctypes.c_void_p), cap, 0)
    ds = lib.ZSTD_createDStream()
    try:
        _check(lib, lib.ZSTD_initDStream(ds), "init")
        while True:
            rc = _check(lib, lib.ZSTD_decompressStream(
                ds, ctypes.byref(outb), ctypes.byref(inb)), "decompress")
            if rc == 0 and inb.pos == inb.size:
                break
            if outb.pos == outb.size:   # grow the output and go on
                cap *= 2
                grown = ctypes.create_string_buffer(cap)
                ctypes.memmove(grown, dst, outb.pos)
                dst = grown
                outb.dst = ctypes.cast(dst, ctypes.c_void_p)
                outb.size = cap
            elif inb.pos == inb.size:
                raise ValueError("zstd decompress: truncated frame")
    finally:
        lib.ZSTD_freeDStream(ds)
    return dst.raw[:outb.pos]


def compress(data: bytes, level: int = 1) -> bytes:
    """One zstd frame holding `data`."""
    lib = _lib()
    data = bytes(data)
    cap = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(cap)
    n = _check(lib, lib.ZSTD_compress(dst, cap, data, len(data), level),
               "compress")
    return dst.raw[:n]
