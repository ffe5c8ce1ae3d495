"""A reader for the OCDBT key-value store that tensorstore writes (the store
under a JAX package's Orbax checkpoint; tensorstore 0.1.x format).

    read_store(root) -> {key (bytes): value (bytes)}

`root` holds `manifest.ocdbt`. The latest version of the manifest names the
root b-tree node; interior nodes name their children, and leaves hold each
value inline or as a reference (data file, offset, length). Data file paths
are relative to `root`: Orbax's root manifest reaches the per-process store
through paths such as `ocdbt.process_0/d/<hash>`.

Every manifest and node is a container: magic (u32 big-endian), total length
(u64 LE), format version (varint, 0), compression (varint: 0 none, 1 zstd),
the body, and a CRC-32C (u32 LE, not checked here). Varints are LEB128.
Columns are stored one field at a time for all entries. zstd bodies need the
host's libzstd (`paths_tpu_torch.native.zstd`). A manifest of the
"numbered" kind (versions in separate files) is refused.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_ZSTD = 1


class _Cursor:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        v = shift = 0
        while True:
            c = self.data[self.pos]
            self.pos += 1
            v |= (c & 0x7F) << shift
            shift += 7
            if c < 0x80:
                return v

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("OCDBT: truncated body")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]


def _container(raw: bytes, magic: int, what: str) -> _Cursor:
    """The body of a manifest or node, decompressed."""
    if len(raw) < 18 or struct.unpack(">I", raw[:4])[0] != magic:
        raise ValueError(f"OCDBT: {what} has the wrong magic")
    if struct.unpack("<Q", raw[4:12])[0] != len(raw):
        raise ValueError(f"OCDBT: {what} length field disagrees with its size")
    head = _Cursor(raw[:-4])
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"OCDBT: {what} format version {version}")
    body = raw[head.pos:-4]
    if compression == _ZSTD:
        from paths_tpu_torch.native import zstd

        body = zstd.decompress(body)
    elif compression != 0:
        raise ValueError(f"OCDBT: {what} compression {compression}")
    return _Cursor(body)


def _data_files(c: _Cursor) -> List[str]:
    """The data file table: paths prefix-compressed against the previous
    one; each path is a base path followed by a relative path, which
    concatenate to the file's path under the store's root."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    c.varints(n)   # base path lengths: the split does not change the path
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + c.take(s)
        paths.append(prev.decode())
    return paths


def _skip_config(c: _Cursor) -> None:
    c.take(16)                     # uuid
    kind = c.varint()
    if kind != 0:
        raise ValueError("OCDBT: numbered manifests are not supported")
    c.varint()                     # max_inline_value_bytes
    c.varint()                     # max_decoded_node_bytes
    c.u8()                         # version_tree_arity_log2
    if c.varint() == _ZSTD:        # compression, then the zstd level
        c.take(4)


def _latest_root(raw: bytes):
    """(height, data file, offset, length) of the newest version's root,
    or None for an empty store."""
    c = _container(raw, MANIFEST_MAGIC, "manifest")
    _skip_config(c)
    files = _data_files(c)
    n = c.varint()
    if n == 0:
        return None
    gens = c.varints(n)
    heights = [c.u8() for _ in range(n)]
    ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
    newest = max(range(n), key=gens.__getitem__)
    if lengths[newest] == 0:
        return None
    return (heights[newest], files[ids[newest]], offsets[newest],
            lengths[newest])


def _read_file(root: str, path: str, offset: int, length: int) -> bytes:
    with open(os.path.join(root, path), "rb") as f:
        f.seek(offset)
        out = f.read(length)
    if len(out) != length:
        raise ValueError(f"OCDBT: {path} holds fewer than {offset + length} "
                         "bytes")
    return out


def _keys(c: _Cursor, n: int, common: bool):
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common_len = c.varints(n) if common else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + c.take(s)
        keys.append(prev)
    return keys, common_len


def _visit(root: str, ref, key_prefix: bytes, out: Dict[bytes, bytes]) -> None:
    height, path, offset, length = ref
    c = _container(_read_file(root, path, offset, length), BTREE_MAGIC,
                   f"b-tree node {path}@{offset}")
    if c.u8() != height:
        raise ValueError(f"OCDBT: node {path}@{offset} has an unexpected "
                         "height")
    files = _data_files(c)
    n = c.varint()
    if height == 0:
        keys, _ = _keys(c, n, common=False)
        lengths = c.varints(n)
        indirect = c.varints(n)
        refs = [i for i in range(n) if indirect[i]]
        ids, offsets = c.varints(len(refs)), c.varints(len(refs))
        where = {i: (files[f], o) for i, f, o in zip(refs, ids, offsets)}
        for i, key in enumerate(keys):
            if i in where:
                value = _read_file(root, *where[i], lengths[i])
            else:
                value = c.take(lengths[i])
            out[key_prefix + key] = value
        return
    # interior: each child's keys omit the part of its entry's key that is
    # common to its whole subtree
    keys, common = _keys(c, n, common=True)
    ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
    for key, cl, f, o, ln in zip(keys, common, ids, offsets, lengths):
        _visit(root, (height - 1, files[f], o, ln), key_prefix + key[:cl], out)


def read_store(root: str) -> Dict[bytes, bytes]:
    """Every key of the newest version of the store at `root`, with its
    value."""
    with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
        ref = _latest_root(f.read())
    out: Dict[bytes, bytes] = {}
    if ref is not None:
        _visit(root, ref, b"", out)
    return out
