"""A read-only OCDBT key/value store over a directory.

OCDBT ("optionally-cooperative distributed B+tree") is the key/value format
that tensorstore writes under Orbax checkpoints (``use_ocdbt``), the format
of the JAX package's ``clip_{epoch}`` directories and ``save_pytree``
artifacts. The port reads it without tensorstore:

- ``manifest.ocdbt``: the store's config, a table of data files, and the
  versions; the newest version names the root node of its B+tree;
- B+tree nodes: interior nodes (a key, a common prefix and a child
  reference per entry) and leaf nodes (keys with inline values, or
  references to values in data files by file, offset and length). Keys are
  prefix-compressed against the previous key, and a child's keys omit the
  prefix its subtree shares;
- data files ``d/<hex>``: nodes and large values at offsets, read by seek;
- a multi-process save keeps each process's files under
  ``ocdbt.process_<i>/``; the top-level tree names them through the base
  paths of its data file tables, which a node passes to the nodes it names.

Manifests and nodes share a header: a big-endian ``u32`` magic, the file's
length as a little-endian ``u64``, varint format version (0) and
compression (0 none, 1 zstd), the body, and a little-endian CRC-32C of
every byte before it, checked on every read. Varints are LEB128; the
columns of a table are stored one after another. Unknown magics,
versions, compressions and manifest kinds raise ``ValueError``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple, Union

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the OCDBT footer holds it."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Cursor over a body: varints, fixed-width integers and byte runs."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise ValueError(f"{self.what}: truncated")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, width: int) -> int:
        return int.from_bytes(self.take(width), "little")

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} bytes left over")


@dataclass(frozen=True)
class DataFile:
    base: str   # the base path that nodes read from this file pass on
    path: str   # relative to the store's directory


@dataclass(frozen=True)
class Ref:
    """A value or a node in a data file."""
    file: DataFile
    offset: int
    length: int


def _body(raw: bytes, magic: int, what: str, max_bytes: int) -> bytes:
    """The body of a manifest or node file, its header and CRC checked."""
    if len(raw) < 16 or int.from_bytes(raw[:4], "big") != magic:
        raise ValueError(f"{what}: not an OCDBT {'manifest' if magic == MANIFEST_MAGIC else 'node'}"
                         f" (magic {raw[:4].hex()}, expected {magic:08x})")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise ValueError(f"{what}: its header says {int.from_bytes(raw[4:12], 'little')} bytes, "
                         f"{len(raw)} read")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"{what}: CRC-32C mismatch")
    r = _Reader(raw[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version}; only 0 is known")
    body = raw[r.pos:-4]
    if compression == 1:
        return zstd.decompress(body, max_bytes, what=what, exact=False).tobytes()
    if compression != 0:
        raise ValueError(f"{what}: OCDBT compression {compression}; only 0 (none) and 1 "
                         "(zstd) are known")
    return bytes(body)


def _data_files(r: _Reader, base: str) -> List[DataFile]:
    """A data file table: prefix-compressed paths, each with the length of
    its base path; ``base`` (that of the file the table was read from) goes
    in front of both."""
    n = r.varint()
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev) or base_len[i] > shared[i] + suffix[i]:
            raise ValueError(f"{r.what}: bad data file table")
        path = prev[:shared[i]] + r.take(suffix[i])
        files.append(DataFile(base + path[:base_len[i]].decode(), base + path.decode()))
        prev = path
    return files


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """A node's keys (each stored as the length it shares with the previous
    key and the rest) and, in an interior node, each subtree's common
    prefix length."""
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise ValueError(f"{r.what}: bad key prefix")
        prev = prev[:shared[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, common


def _read_at(root: str, ref: Ref, what: str) -> bytes:
    with open(os.path.join(root, ref.file.path), "rb") as f:
        f.seek(ref.offset)
        data = f.read(ref.length)
    if len(data) != ref.length:
        raise ValueError(f"{what}: {ref.file.path} ends before offset {ref.offset} + "
                         f"{ref.length}")
    return data


class OcdbtStore:
    """The newest version of the OCDBT store in ``root``: ``list(prefix)``
    and ``read(key)``. Opening reads the manifest and every B+tree node;
    values stay on disk until they are read."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, MANIFEST)
        with open(path, "rb") as f:
            raw = f.read()
        r = _Reader(_body(raw, MANIFEST_MAGIC, path, 1 << 30), path)
        r.take(16)  # the store's uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{path}: manifest kind {kind} (numbered manifests); only 0 "
                             "(single) is known")
        r.varint()  # the largest value stored inline
        self.max_decoded_node_bytes = r.varint()
        r.uint(1)  # the version tree's arity (log2)
        method = r.varint()
        if method == 1:
            r.uint(4)  # zstd level
        elif method != 0:
            raise ValueError(f"{path}: compression method {method}; only 0 and 1 are known")
        files = _data_files(r, "")
        # the newest versions, inline (a leaf of the version tree) ...
        n = r.varint()
        generation = r.varints(n)
        height = [r.uint(1) for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        r.varints(2 * n)  # bytes of tree nodes, bytes of indirect values
        [r.uint(8) for _ in range(n)]  # commit times
        # ... and the nodes of older versions, which a read of the newest needs not
        m = r.varint()
        r.varints(5 * m)  # generation, file, offset, length, generations
        r.take(8 * m)     # commit times
        r.take(m)         # heights
        r.end()
        if not n:
            raise ValueError(f"{path}: the store has no version")
        newest = max(range(n), key=generation.__getitem__)
        self.generation = generation[newest]
        self.root_node = None
        self._values: Dict[bytes, Union[bytes, Ref]] = {}
        if num_keys[newest]:
            if file_id[newest] >= len(files):
                raise ValueError(f"{path}: root in data file {file_id[newest]} of {len(files)}")
            self.root_node = Ref(files[file_id[newest]], offset[newest], length[newest])
            self._walk(self.root_node, height[newest], b"")

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        what = f"{os.path.join(self.root, ref.file.path)}@{ref.offset}"
        r = _Reader(_body(_read_at(self.root, ref, what), NODE_MAGIC, what,
                          self.max_decoded_node_bytes), what)
        if r.uint(1) != height:
            raise ValueError(f"{what}: node of another height than its reference says")
        files = _data_files(r, ref.file.base)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)

        def file(i: int) -> DataFile:
            if i >= len(files):
                raise ValueError(f"{what}: data file {i} of {len(files)}")
            return files[i]

        if height:
            file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # keys, node bytes and value bytes of each subtree
            r.end()
            for i in range(n):
                child = Ref(file(file_id[i]), offset[i], length[i])
                self._walk(child, height - 1, prefix + keys[i][:common[i]])
            return
        length = r.varints(n)
        kind = r.varints(n)
        if any(k > 1 for k in kind):
            raise ValueError(f"{what}: value kind {max(kind)}; only 0 (inline) and 1 "
                             "(indirect) are known")
        indirect = [i for i in range(n) if kind[i] == 1]
        file_id, offset = r.varints(len(indirect)), r.varints(len(indirect))
        refs = {i: Ref(file(f), o, length[i]) for i, f, o in zip(indirect, file_id, offset)}
        for i in range(n):
            self._values[prefix + keys[i]] = refs[i] if kind[i] else r.take(length[i])
        r.end()

    def list(self, prefix: str = "") -> List[str]:
        """The keys that start with ``prefix``, sorted."""
        p = prefix.encode()
        return sorted(k.decode() for k in self._values if k.startswith(p))

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def read(self, key: str) -> bytes:
        """The value of ``key``; ``KeyError`` where there is none."""
        value = self._values[key.encode()]
        if isinstance(value, Ref):
            return _read_at(self.root, value, f"{self.root}: {key}")
        return value
