"""Zarr v2 arrays as Orbax stores them: `<name>/.zarray` (JSON) beside one
file or key per chunk, `<name>/<i>.<j>...` (a 0-d array's chunk is `0`).

    read_array(get, name) -> np.ndarray, or a torch bfloat16 tensor
    write_array(directory, name, array)

`get(key)` returns a key's bytes or None; a chunk that is absent holds the
fill value (tensorstore leaves out chunks that equal it unless told to store
them). `.zarray` fields read: dtype (a numpy type string, or "bfloat16"),
shape, chunks, order ("C" or "F"), compressor (none, or zstd through the
host's libzstd: what Orbax writes), fill_value, dimension_separator; filters
must be null. numpy has no bfloat16, so a bfloat16 array comes back as a torch
tensor of that type, and `write_array` takes one. The writer stores a single
uncompressed chunk in C order.
"""
from __future__ import annotations

import itertools
import json
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

BF16 = "bfloat16"


def _fill(value, dtype: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):   # zarr spells the float specials as strings
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}[value]
    return np.asarray(value).astype(dtype)


def _decompress(data: bytes, compressor: Optional[dict], size: int) -> bytes:
    if compressor is None:
        return data
    if compressor.get("id") != "zstd":
        raise ValueError(f"zarr compressor {compressor!r} is not supported")
    from paths_tpu_torch.native import zstd

    return zstd.decompress(data, size)


def read_array(get: Callable[[str], Optional[bytes]], name: str):
    """The array `name` of a store read through `get`."""
    meta = json.loads(get(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise ValueError(f"{name}: only zarr v2 without filters is supported")
    bf16 = meta["dtype"] == BF16
    dtype = np.dtype("<u2" if bf16 else meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    fill = _fill(meta["fill_value"], np.float32 if bf16 else dtype)
    if bf16:   # the top half of the f32 bits
        fill = np.asarray(fill, np.float32).view(np.uint32) >> 16
    out = np.full(shape, fill, dtype)
    nbytes = math.prod(chunks) * dtype.itemsize
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = get(key)
        if data is None:
            continue
        raw = _decompress(data, meta.get("compressor"), nbytes)
        chunk = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        sel = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[sel] = chunk[tuple(slice(0, s.stop - s.start) for s in sel)]
    out = out.astype(dtype.newbyteorder("="), copy=False)
    if bf16:
        return torch.from_numpy(out.view(np.int16).copy()).view(torch.bfloat16)
    return out


def write_array(directory: str, name: str, array) -> None:
    """`array` (numpy, or a CPU torch bfloat16 tensor) as zarr v2 under
    `directory/name`: one chunk, no compressor, no fill value."""
    if isinstance(array, torch.Tensor):
        if array.dtype != torch.bfloat16:
            raise TypeError("write_array takes numpy arrays and bfloat16 "
                            "tensors")
        raw = array.contiguous().view(torch.int16).numpy().astype("<i2")
        dtype_str, shape = BF16, tuple(array.shape)
    else:
        arr = np.asarray(array)
        raw = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder("<")))
        dtype_str, shape = raw.dtype.str, arr.shape
    meta = {"chunks": list(shape), "compressor": None,
            "dimension_separator": ".", "dtype": dtype_str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(shape), "zarr_format": 2}
    path = os.path.join(directory, name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f, sort_keys=True, separators=(",", ":"))
    chunk = ".".join("0" for _ in shape) or "0"
    with open(os.path.join(path, chunk), "wb") as f:
        f.write(raw.tobytes())
