"""The OCDBT key-value store (tensorstore's "optionally cooperative
distributed B+tree"), read and written in Python without tensorstore.

Orbax keeps a checkpoint's arrays in one such store: a directory with a
``manifest.ocdbt`` and data files ``d/<hex>`` holding B+tree nodes and
out-of-line values. Every manifest and node is

    magic (uint32 big-endian) | length (uint64 LE, the whole record)
    | version (varint, 0) | compression (varint: 0 raw, 1 zstd)
    | body | CRC-32C of everything before it (uint32 LE)

Numbers in a body are LEB128 varints; tables are stored column by
column. A manifest (magic 0x0cdb3a2a) holds the config (uuid,
manifest kind, max inline value bytes, max decoded node bytes, version
tree arity log2, compression method and its zstd level as int32), a
data-file table, the newest versions inline (generation, root height,
root reference, key and byte counts, commit time) and references to
version-tree nodes (magic 0x0cdb1234) that hold the older ones. A
B+tree node (magic 0x0cdb20de) holds its height, a data-file table and
its entries: prefix-compressed keys relative to the node's subtree
prefix, then for a leaf each value inline or as (data file, offset,
length), and for an interior node each child's subtree prefix length,
reference and counts. A data-file table is prefix-compressed paths,
each split into a base path and a relative path; a node read through a
data file with base path ``b`` resolves its own files under ``b`` too,
which is how a merged store's root reaches the per-process directory
(``ocdbt.process_0/d/...``) orbax writes first.

`OcdbtReader` reads the newest version of any such store, zstd-
compressed or not (`compress.zstd`). `write_store` writes one
uncompressed version: small values inline, each array's bytes as one
out-of-line value in a data file of its own, the keys in one leaf node,
or in a tree of them when they overflow ``max_node_bytes``. Values are
written and read with file I/O on numpy buffers, never copied through
Python ``bytes``.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np

__all__ = ["OcdbtReader", "ValueRef", "write_store", "crc32c"]

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234
_NULL = (1 << 64) - 1  # offset and length of an empty tree's root
_MAX_INLINE = 1024  # orbax's config
_MAX_NODE_BYTES = 100_000_000
_ARITY_LOG2 = 4


# ----------------------------------------------------------------- CRC-32C


def _crc_table() -> List[int]:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``; zlib.crc32 is the other CRC-32."""
    c = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ----------------------------------------------------------------- parsing


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf, self.i = buf, 0

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.i >= len(self.buf):
                raise ValueError("ocdbt: truncated varint")
            b = self.buf[self.i]
            self.i += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError("ocdbt: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.buf):
            raise ValueError("ocdbt: truncated record")
        out = self.buf[self.i : self.i + n]
        self.i += n
        return out

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def done(self) -> None:
        if self.i != len(self.buf):
            raise ValueError(f"ocdbt: {len(self.buf) - self.i} bytes left after the record")


def _record_body(buf: bytes, magic: int, max_size: int) -> bytes:
    """Check a record's header and CRC-32C; its body, decompressed."""
    if len(buf) < 18 or struct.unpack(">I", buf[:4])[0] != magic:
        raise ValueError(f"ocdbt: not a record with magic {magic:#010x}")
    (length,) = struct.unpack("<Q", buf[4:12])
    if length != len(buf):
        raise ValueError(f"ocdbt: record length {length} but {len(buf)} bytes read")
    if crc32c(buf[:-4]) != struct.unpack("<I", buf[-4:])[0]:
        raise ValueError("ocdbt: CRC-32C mismatch")
    cur = _Cursor(buf[:-4])
    cur.i = 12
    if cur.varint() != 0:
        raise ValueError("ocdbt: unknown record version")
    compression = cur.varint()
    body = buf[cur.i : -4]
    if compression == 0:
        return body
    if compression == 1:
        from modegpt_tpu_torch.compress import zstd

        return zstd.decompress(body, max_size=max_size)
    raise ValueError(f"ocdbt: unknown compression format {compression}")


def _file_table(cur: _Cursor) -> List[Tuple[str, str]]:
    """[(base path, relative path)] of a data-file table."""
    n = cur.varint()
    if n == 0:
        return []
    prefix = [0] + cur.varints(n - 1)
    suffix = cur.varints(n)
    base = cur.varints(n)
    out, prev = [], b""
    for i in range(n):
        path = prev[: prefix[i]] + cur.take(suffix[i])
        if base[i] > len(path):
            raise ValueError("ocdbt: base path longer than its path")
        out.append((path[: base[i]].decode(), path[base[i] :].decode()))
        prev = path
    return out


def _keys(cur: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError("ocdbt: key prefix longer than the previous key")
        key = prev[: prefix[i]] + cur.take(suffix[i])
        keys.append(key)
        prev = key
    return keys, common


class ValueRef(NamedTuple):
    """An out-of-line value: ``length`` bytes at ``offset`` of ``path``."""

    path: str
    offset: int
    length: int


class _NodeRef(NamedTuple):
    path: str  # the data file, relative to the store root
    base: str  # the base path the node's own files resolve under
    offset: int
    length: int


class _Version(NamedTuple):
    generation: int
    root_height: int
    root: Optional[_NodeRef]
    num_keys: int
    commit_time: int


def _ref(files, prefix: str, fid: int, offset: int, length: int) -> _NodeRef:
    if fid >= len(files):
        raise ValueError(f"ocdbt: data file {fid} not in the table of {len(files)}")
    base, rel = files[fid]
    return _NodeRef(prefix + base + rel, prefix + base, offset, length)


def _versions(cur: _Cursor, files, n: int) -> List[_Version]:
    gen = cur.varints(n)
    height = cur.u8s(n)
    fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
    keys = cur.varints(n)
    cur.varints(n)  # tree bytes
    cur.varints(n)  # indirect value bytes
    commit = cur.u64s(n)
    out = []
    for i in range(n):
        root = None if off[i] == _NULL else _ref(files, "", fid[i], off[i], length[i])
        out.append(_Version(gen[i], height[i], root, keys[i], commit[i]))
    return out


def _version_node_refs(cur: _Cursor, files, n: int, heights: Optional[List[int]] = None):
    gen = cur.varints(n)
    fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
    cur.varints(n)  # generations below each
    cur.u64s(n)  # commit times
    if heights is None:
        heights = cur.u8s(n)
    return [(gen[i], heights[i], _ref(files, "", fid[i], off[i], length[i])) for i in range(n)]


class OcdbtReader:
    """The newest version of the OCDBT store at ``root``: its keys, and
    each value inline (``bytes``) or out of line (`ValueRef`, path
    relative to ``root``)."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
            body = _record_body(f.read(), MANIFEST_MAGIC, 1 << 30)
        cur = _Cursor(body)
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            raise ValueError("ocdbt: numbered manifests are not supported (orbax writes single-file ones)")
        cur.varint()  # max inline value bytes
        self.max_node_bytes = cur.varint()
        cur.u8s(1)  # version tree arity log2
        if cur.varint() == 1:
            cur.take(4)  # zstd level
        files = _file_table(cur)
        inline = _versions(cur, files, cur.varint())
        self._version_nodes = _version_node_refs(cur, files, cur.varint())
        cur.done()
        versions = inline or self.versions()
        if not versions:
            raise ValueError("ocdbt: the manifest holds no version")
        self.version = max(versions, key=lambda v: v.generation)
        self.values: Dict[str, Union[bytes, ValueRef]] = {}
        if self.version.root is not None:
            self._walk(self.version.root, self.version.root_height, b"")

    def _read(self, ref: _NodeRef, magic: int) -> bytes:
        with open(os.path.join(self.root, ref.path), "rb") as f:
            f.seek(ref.offset)
            buf = f.read(ref.length)
        if len(buf) != ref.length:
            raise ValueError(f"ocdbt: {ref.path} ends before offset {ref.offset} + {ref.length}")
        return _record_body(buf, magic, max(self.max_node_bytes, 1 << 20))

    def versions(self) -> List[_Version]:
        """Every version the manifest's version tree nodes hold (the
        newest ones are inline in the manifest and not repeated)."""
        out: List[_Version] = []
        stack = [(h, ref) for _, h, ref in self._version_nodes]
        while stack:
            height, ref = stack.pop()
            cur = _Cursor(self._read(ref, VERSION_TREE_MAGIC))
            cur.u8s(1)  # arity log2
            if cur.u8s(1)[0] != height:
                raise ValueError("ocdbt: version node height does not match its reference")
            files = _file_table(cur)
            n = cur.varint()
            if height == 0:
                out.extend(_versions(cur, files, n))
            else:
                stack.extend((height - 1, r) for _, _, r in _version_node_refs(cur, files, n, [height - 1] * n))
            cur.done()
        return sorted(out, key=lambda v: v.generation)

    def _walk(self, ref: _NodeRef, height: int, prefix: bytes) -> None:
        cur = _Cursor(self._read(ref, BTREE_MAGIC))
        if cur.u8s(1)[0] != height:
            raise ValueError("ocdbt: B+tree node height does not match its reference")
        files = _file_table(cur)
        n = cur.varint()
        keys, common = _keys(cur, n, interior=height > 0)
        if height > 0:
            fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
            for _ in range(3):
                cur.varints(n)  # keys, tree bytes, indirect value bytes below each child
            cur.done()
            for i in range(n):
                child = _ref(files, ref.base, fid[i], off[i], length[i])
                self._walk(child, height - 1, prefix + keys[i][: common[i]])
            return
        lengths = cur.varints(n)
        kinds = cur.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError("ocdbt: unknown value kind")
        fid, off = cur.varints(len(indirect)), cur.varints(len(indirect))
        for j, i in enumerate(indirect):
            r = _ref(files, ref.base, fid[j], off[j], lengths[i])
            self.values[(prefix + keys[i]).decode()] = ValueRef(r.path, r.offset, r.length)
        for i in range(n):
            if kinds[i] == 0:
                self.values[(prefix + keys[i]).decode()] = cur.take(lengths[i])
        cur.done()

    def keys(self) -> List[str]:
        return sorted(self.values)

    def read(self, key: str) -> bytes:
        """A value's bytes (small values: .zarray, node-sized data)."""
        v = self.values[key]
        if isinstance(v, bytes):
            return v
        out = np.empty(v.length, dtype=np.uint8)
        self.read_into(key, out)
        return out.tobytes()

    def read_into(self, key: str, out: np.ndarray) -> None:
        """Read a value's bytes into the C-contiguous array ``out``, whose
        size in bytes must equal the value's."""
        v = self.values[key]
        dst = out.reshape(-1).view(np.uint8)
        length = len(v) if isinstance(v, bytes) else v.length
        if dst.nbytes != length:
            raise ValueError(f"ocdbt: {key} holds {length} bytes, the buffer {dst.nbytes}")
        if isinstance(v, bytes):
            dst[:] = np.frombuffer(v, dtype=np.uint8)
            return
        with open(os.path.join(self.root, v.path), "rb", buffering=0) as f:
            f.seek(v.offset)
            view, got = memoryview(dst), 0
            while got < length:
                n = f.readinto(view[got:])
                if not n:
                    raise ValueError(f"ocdbt: {v.path} ends inside {key}")
                got += n


# ----------------------------------------------------------------- writing


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vs: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _encode_file_table(paths: List[str]) -> bytes:
    """Paths relative to the store root; every base path is empty."""
    raw = [p.encode() for p in paths]
    prefix = [_common_prefix(raw[i - 1], raw[i]) for i in range(1, len(raw))]
    suffix = [len(p) - (prefix[i - 1] if i else 0) for i, p in enumerate(raw)]
    tail = b"".join(p[(prefix[i - 1] if i else 0) :] for i, p in enumerate(raw))
    return _varint(len(raw)) + _varints(prefix) + _varints(suffix) + _varints([0] * len(raw)) + tail


def _encode_keys(keys: List[bytes], common: Optional[List[int]]) -> bytes:
    prefix = [_common_prefix(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    out = _varint(len(keys)) + _varints(prefix)
    out += _varints(len(k) - (prefix[i - 1] if i else 0) for i, k in enumerate(keys))
    if common is not None:
        out += _varints(common)
    return out + b"".join(k[(prefix[i - 1] if i else 0) :] for i, k in enumerate(keys))


def _record(magic: int, body: bytes) -> bytes:
    head = struct.pack(">I", magic) + struct.pack("<Q", 4 + 8 + 2 + len(body) + 4) + b"\x00\x00"
    rec = head + body
    return rec + struct.pack("<I", crc32c(rec))


class _Leaf(NamedTuple):
    key: bytes
    value: Union[bytes, Tuple[str, int, int]]  # inline, or (data file, offset, length)


def _leaf_body(entries: List[_Leaf], strip: int) -> bytes:
    files = sorted({e.value[0] for e in entries if not isinstance(e.value, bytes)})
    fid = {p: i for i, p in enumerate(files)}
    indirect = [e.value for e in entries if not isinstance(e.value, bytes)]
    body = b"\x00" + _encode_file_table(files) + _encode_keys([e.key[strip:] for e in entries], None)
    body += _varints(len(e.value) if isinstance(e.value, bytes) else e.value[2] for e in entries)
    body += _varints(0 if isinstance(e.value, bytes) else 1 for e in entries)
    body += _varints(fid[v[0]] for v in indirect) + _varints(v[1] for v in indirect)
    return body + b"".join(e.value for e in entries if isinstance(e.value, bytes))


class _Child(NamedTuple):
    first: bytes  # first key below, full
    last: bytes
    offset: int
    length: int
    num_keys: int
    tree_bytes: int
    indirect_bytes: int


def _interior_body(height: int, children: List[_Child], node_file: str, strip: int) -> bytes:
    common = [_common_prefix(c.first, c.last) - strip for c in children]
    n = len(children)
    body = bytes([height]) + _encode_file_table([node_file])
    body += _encode_keys([c.first[strip:] for c in children], common)
    body += _varints([0] * n) + _varints(c.offset for c in children) + _varints(c.length for c in children)
    body += _varints(c.num_keys for c in children) + _varints(c.tree_bytes for c in children)
    return body + _varints(c.indirect_bytes for c in children)


def _groups(items: list, size_of, max_bytes: int) -> List[list]:
    """Split ``items`` in order into runs whose summed size stays under
    ``max_bytes`` (each run at least one item)."""
    out, run, used = [], [], 0
    for it in items:
        s = size_of(it)
        if run and used + s > max_bytes:
            out.append(run)
            run, used = [], 0
        run.append(it)
        used += s
    if run:
        out.append(run)
    return out


def write_store(root: str, entries: Dict[str, Union[bytes, Tuple[str, int, int]]],
                max_node_bytes: int = _MAX_NODE_BYTES) -> None:
    """Write one uncompressed version of an OCDBT store at ``root``.

    ``entries`` maps each key to its value: ``bytes`` (stored inline up to
    1024 bytes, else in a data file of its own), or ``(path, offset,
    length)`` for bytes the caller has already written to a data file
    under ``root`` (`new_data_file`). B+tree nodes go to one more data
    file; leaves hold keys up to ``max_node_bytes`` of body each, and
    interior levels are added until one node holds them all."""
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    leaves: List[_Leaf] = []
    for key in sorted(entries):
        v = entries[key]
        if isinstance(v, bytes) and len(v) > _MAX_INLINE:
            path = new_data_file(root)
            with open(os.path.join(root, path), "wb") as f:
                f.write(v)
            v = (path, 0, len(v))
        leaves.append(_Leaf(key.encode(), v))

    node_file = new_data_file(root)
    nodes = bytearray()

    def put(body: bytes) -> Tuple[int, int]:
        rec = _record(BTREE_MAGIC, body)
        nodes.extend(rec)
        return len(nodes) - len(rec), len(rec)

    def value_size(e: _Leaf) -> int:
        return len(e.key) + 12 + (len(e.value) if isinstance(e.value, bytes) else 0)

    level: List[_Child] = []
    for run in _groups(leaves, value_size, max_node_bytes // 2):
        strip = _common_prefix(run[0].key, run[-1].key) if len(leaves) > len(run) else 0
        off, length = put(_leaf_body(run, strip))
        indirect = sum(e.value[2] for e in run if not isinstance(e.value, bytes))
        level.append(_Child(run[0].key, run[-1].key, off, length, len(run), length, indirect))
    height = 0
    while len(level) > 1:
        height += 1
        up: List[_Child] = []
        for run in _groups(level, lambda c: len(c.first) + 40, max_node_bytes // 2):
            strip = _common_prefix(run[0].first, run[-1].last) if len(level) > len(run) else 0
            off, length = put(_interior_body(height, run, node_file, strip))
            up.append(_Child(run[0].first, run[-1].last, off, length, sum(c.num_keys for c in run),
                             length + sum(c.tree_bytes for c in run), sum(c.indirect_bytes for c in run)))
        level = up
    with open(os.path.join(root, node_file), "wb") as f:
        f.write(nodes)

    config = os.urandom(16) + _varint(0) + _varint(_MAX_INLINE) + _varint(max_node_bytes)
    config += bytes([_ARITY_LOG2]) + _varint(0)
    if level:
        root_ref = level[0]
        files = _encode_file_table([node_file])
        version = _varints([1]) + bytes([height]) + _varints([0, root_ref.offset, root_ref.length])
        version += _varints([root_ref.num_keys, root_ref.tree_bytes, root_ref.indirect_bytes])
    else:
        files = _encode_file_table([""])
        version = _varints([1]) + b"\x00" + _varints([0, _NULL, _NULL, 0, 0, 0])
    version += struct.pack("<Q", time.time_ns())
    body = config + files + _varint(1) + version + _varint(0)
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(_record(MANIFEST_MAGIC, body))


def new_data_file(root: str) -> str:
    """A fresh data file's path relative to ``root`` (``d/<32 hex>``)."""
    return "d/" + os.urandom(16).hex()
