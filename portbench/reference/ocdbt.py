"""A reader of orbax/tensorstore OCDBT checkpoints in plain Python.

A frozen copy of ``vtd_tpu_torch/train/ocdbt.py``, kept with the
benchmark so that the plain reference reads the trained checkpoints
without anything of the program under test. The JAX package saves its
models with orbax into an OCDBT key-value store (``manifest.ocdbt``,
B-tree nodes and value data under ``d/`` and ``ocdbt.process_<i>/d/``),
one zarr v2 array per leaf of the variables tree. This module reads such
a directory with numpy, the standard library and ``libzstd.so.1`` through
ctypes. It reads; it never writes.

Record layout (manifest and B-tree node alike):
  magic (uint32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de node),
  length of the whole record (uint64 little-endian), format version
  (varint, 0), compression (varint: 0 none, 1 zstd), the body
  (compressed as said), CRC-32C of everything before it (uint32 LE).
Every record's CRC-32C is checked.

Manifest body: config (uuid[16], manifest kind, max inline value bytes,
max decoded node bytes, version tree arity log2 as one byte, compression
method and for zstd a 4-byte level), a data file table, the inline
versions as columns (generation, root height, root node file / offset /
length, key count, tree bytes, indirect value bytes, commit time) and
references to version-tree nodes. The newest version is always inline.

B-tree node body: height byte, data file table, entry count, keys as
columns (shared-prefix lengths of entries 1.., suffix lengths, on
interior nodes the subtree's common prefix lengths, suffix bytes). A
leaf then has value lengths, value kinds (0 inline, 1 indirect), file
ids and offsets of the indirect values, and the inline bytes; an
interior node has its children's file ids, offsets, lengths and
statistics. A child's keys omit the parent's prefix: the part of the
entry key below ``subtree_common_prefix_length`` bytes.

Data file table: count, then shared-prefix lengths (entries 1..), suffix
lengths, base-path lengths, suffix bytes; a path is relative to the
directory that holds the manifest.
"""
from __future__ import annotations

import ctypes
import json
import struct
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_VALUE_INLINE, _VALUE_INDIRECT = 0, 1


# --------------------------------------------------------------------------
# zstd through ctypes
# --------------------------------------------------------------------------
class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2
_zstd_lock = threading.Lock()
_zstd: Optional[ctypes.CDLL] = None


def _libzstd() -> ctypes.CDLL:
    global _zstd
    with _zstd_lock:
        if _zstd is not None:
            return _zstd
        try:
            lib = ctypes.CDLL("libzstd.so.1")
        except OSError as e:
            raise RuntimeError(
                "libzstd.so.1 could not be loaded; the port reads zstd-"
                f"compressed checkpoints through it ({e})"
            ) from e
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_createDStream.restype = ctypes.c_void_p
        lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_initDStream.restype = ctypes.c_size_t
        lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_DStreamOutSize.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
            ctypes.POINTER(_InBuffer),
        ]
        _zstd = lib
        return lib


def _check(lib: ctypes.CDLL, code: int) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def zstd_decompress(data: bytes, size_hint: Optional[int] = None) -> bytes:
    """Decompress zstd frames. One call of ``ZSTD_decompress`` when the
    frame header carries the content size (or the caller knows it as
    ``size_hint``); the streaming API otherwise."""
    lib = _libzstd()
    src = ctypes.c_char_p(data)
    size = lib.ZSTD_getFrameContentSize(src, len(data))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a zstd frame")
    if size == _CONTENTSIZE_UNKNOWN:
        size = size_hint
    if size is not None:
        dst = ctypes.create_string_buffer(max(int(size), 1))
        n = _check(lib, lib.ZSTD_decompress(dst, int(size), src, len(data)))
        if size_hint is None and n != size:
            raise ValueError(f"zstd: {n} bytes where the frame says {size}")
        return dst.raw[:n]
    return _zstd_stream(lib, data)


def _zstd_stream(lib: ctypes.CDLL, data: bytes) -> bytes:
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(stream))
        chunk = int(lib.ZSTD_DStreamOutSize())
        src = ctypes.create_string_buffer(data, len(data))
        dst = ctypes.create_string_buffer(chunk)
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        parts: List[bytes] = []
        last = 0
        while True:
            outb = _OutBuffer(ctypes.cast(dst, ctypes.c_void_p), chunk, 0)
            last = _check(lib, lib.ZSTD_decompressStream(
                stream, ctypes.byref(outb), ctypes.byref(inb)))
            parts.append(dst.raw[:outb.pos])
            if inb.pos >= inb.size and outb.pos < chunk:
                break
        if last != 0:
            raise ValueError("zstd: truncated frame")
        return b"".join(parts)
    finally:
        lib.ZSTD_freeDStream(stream)


# --------------------------------------------------------------------------
# CRC-32C (Castagnoli), reflected polynomial 0x82F63B78
# --------------------------------------------------------------------------
def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# --------------------------------------------------------------------------
# records
# --------------------------------------------------------------------------
class _Reader:
    """Cursor over a decoded body."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def varint(self) -> int:
        out = shift = 0
        while True:
            byte = self.buf[self.pos]
            self.pos += 1
            out |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError("OCDBT: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("OCDBT: record ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.raw(1)[0]

    def done(self) -> bool:
        return self.pos == len(self.buf)


def decode_record(data: bytes, magic: int, what: str) -> bytes:
    """Check a record's header and CRC-32C; return its decoded body."""
    if len(data) < 18:
        raise ValueError(f"OCDBT {what}: {len(data)} bytes is too short")
    (got_magic,) = struct.unpack(">I", data[:4])
    if got_magic != magic:
        raise ValueError(
            f"OCDBT {what}: magic {got_magic:#010x}, expected {magic:#010x}")
    (length,) = struct.unpack("<Q", data[4:12])
    if length != len(data):
        raise ValueError(
            f"OCDBT {what}: header says {length} bytes, read {len(data)}")
    (want_crc,) = struct.unpack("<I", data[-4:])
    if crc32c(data[:-4]) != want_crc:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    head = _Reader(data[12:-4])
    version = head.varint()
    if version != 0:
        raise ValueError(f"OCDBT {what}: format version {version}")
    compression = head.varint()
    body = data[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body)
    raise ValueError(f"OCDBT {what}: compression format {compression}")


def _data_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base-path lengths: the full path is what is opened
    paths, prev = [], b""
    for i in range(n):
        full = prev[:shared[i]] + r.raw(suffix[i])
        path = full.decode()
        if path.startswith("/") or ".." in path.split("/"):
            raise ValueError(f"OCDBT: data file {path!r} outside the store")
        paths.append(path)
        prev = full
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        key = prev[:shared[i]] + r.raw(suffix[i])
        keys.append(key)
        prev = key
    return keys, common


@dataclass(frozen=True)
class _Ref:
    """Where a record or an indirect value lies: a file below the store's
    root, a byte offset and a length."""

    file: str
    offset: int
    length: int


@dataclass(frozen=True)
class _Version:
    generation: int
    height: int
    root: Optional[_Ref]  # None: the empty tree


def _parse_manifest(body: bytes) -> _Version:
    r = _Reader(body)
    r.raw(16)  # uuid
    kind = r.varint()
    if kind != 0:
        raise NotImplementedError(
            "OCDBT: numbered manifests (manifest kind 1) are not read; "
            "orbax writes single-file manifests")
    r.varint()  # max inline value bytes
    r.varint()  # max decoded node bytes
    r.byte()  # version tree arity log2
    method = r.varint()
    if method == 1:
        r.raw(4)  # zstd level
    elif method != 0:
        raise ValueError(f"OCDBT manifest: compression method {method}")
    files = _data_file_table(r)
    n = r.varint()
    gens = r.varints(n)
    heights = [r.byte() for _ in range(n)]
    fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
    # the rest (statistics, commit times, version-tree node references)
    # describes older versions and is not needed to read the newest
    if not n:
        raise ValueError("OCDBT manifest: no version")
    i = max(range(n), key=gens.__getitem__)
    root = (
        _Ref(files[fids[i]], offs[i], lens[i]) if lens[i] else None
    )
    return _Version(gens[i], heights[i], root)


class OcdbtStore:
    """The key-value map of one OCDBT directory, read at its newest
    version (``generation``; ``height`` of its B-tree root). Keys are
    bytes; ``get`` returns a value's bytes."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        manifest = self.root / "manifest.ocdbt"
        if not manifest.is_file():
            raise FileNotFoundError(f"no OCDBT manifest in {self.root}")
        version = _parse_manifest(
            decode_record(manifest.read_bytes(), MANIFEST_MAGIC, "manifest"))
        self.generation = version.generation
        self.height = version.height
        self._values: Dict[bytes, object] = {}
        if version.root is not None:
            self._walk(version.root, version.height, b"")

    def _read(self, ref: _Ref) -> bytes:
        with open(self.root / ref.file, "rb") as fh:
            fh.seek(ref.offset)
            data = fh.read(ref.length)
        if len(data) != ref.length:
            raise ValueError(f"OCDBT: {ref.file} ends before {ref}")
        return data

    def _walk(self, ref: _Ref, height: int, prefix: bytes) -> None:
        r = _Reader(decode_record(self._read(ref), NODE_MAGIC, "node"))
        got_height = r.byte()
        if got_height != height:
            raise ValueError(
                f"OCDBT node {ref}: height {got_height}, parent says {height}")
        files = _data_file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)
        if height > 0:
            fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # statistics: keys, tree bytes, indirect bytes
            if not r.done():
                raise ValueError(f"OCDBT node {ref}: trailing bytes")
            for i in range(n):
                self._walk(
                    _Ref(files[fids[i]], offs[i], lens[i]), height - 1,
                    prefix + keys[i][:common[i]],
                )
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == _VALUE_INDIRECT]
        if any(k not in (_VALUE_INLINE, _VALUE_INDIRECT) for k in kinds):
            raise ValueError(f"OCDBT node {ref}: unknown value kind")
        fids = r.varints(len(indirect))
        offs = r.varints(len(indirect))
        for j, i in enumerate(indirect):
            self._values[prefix + keys[i]] = _Ref(
                files[fids[j]], offs[j], lengths[i])
        for i in range(n):
            if kinds[i] == _VALUE_INLINE:
                self._values[prefix + keys[i]] = r.raw(lengths[i])
        if not r.done():
            raise ValueError(f"OCDBT node {ref}: trailing bytes")

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def __contains__(self, key: bytes) -> bool:
        return key in self._values

    def get(self, key: bytes) -> bytes:
        value = self._values[key]
        return self._read(value) if isinstance(value, _Ref) else value


# --------------------------------------------------------------------------
# zarr v2 arrays
# --------------------------------------------------------------------------
def _decompress_chunk(meta: dict, data: bytes, nbytes: int) -> bytes:
    comp = meta.get("compressor")
    if comp is None:
        return data
    if comp.get("id") == "zstd":
        return zstd_decompress(data, size_hint=nbytes)
    raise NotImplementedError(f"zarr compressor {comp!r}")


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype of a zarr dtype string; bfloat16 is read as its
    raw 16-bit words."""
    return np.dtype("<u2") if name == "bfloat16" else np.dtype(name)


def bfloat16_bits_to_float32(words: np.ndarray) -> np.ndarray:
    """Widen raw bfloat16 words (uint16) to float32, exactly: a bfloat16
    is the upper half of the float32 with the same value."""
    return (words.astype(np.uint32) << 16).view(np.float32)


def _fill_value(meta: dict):
    """A zarr v2 fill value in the storage dtype (null reads as 0)."""
    fill = meta.get("fill_value")
    if fill is None:
        return 0
    if meta["dtype"] == "bfloat16":
        return int(np.float32(fill).view(np.uint32) >> 16)
    return fill


def read_zarr(store: OcdbtStore, name: str) -> Tuple[np.ndarray, str]:
    """The zarr v2 array stored under ``name`` -> (array, stored dtype
    name). bfloat16 arrays come back widened to float32."""
    meta = json.loads(store.get(f"{name}/.zarray".encode()))
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"{name}: zarr format {meta.get('zarr_format')}")
    if meta.get("filters") or meta.get("order", "C") != "C":
        raise NotImplementedError(
            f"{name}: zarr filters or order {meta.get('order')!r}")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    dt = _storage_dtype(meta["dtype"])
    out = np.full(shape, _fill_value(meta), dt)
    if not shape:  # a scalar: one chunk named "0"
        grid, chunks = [(0,)], (1,)
    else:
        counts = [-(-s // c) for s, c in zip(shape, chunks)]
        grid = list(np.ndindex(*counts))
    nbytes = int(np.prod(chunks)) * dt.itemsize
    for idx in grid:
        key = f"{name}/{sep.join(map(str, idx))}".encode()
        if key not in store:
            continue  # never written: fill value
        raw = _decompress_chunk(meta, store.get(key), nbytes)
        if len(raw) != nbytes:
            raise ValueError(f"{key!r}: {len(raw)} bytes, expected {nbytes}")
        block = np.frombuffer(raw, dt).reshape(chunks)
        if not shape:
            out[()] = block.reshape(-1)[0]
            continue
        dst = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks, shape)
        )
        out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
    if meta["dtype"] == "bfloat16":
        return bfloat16_bits_to_float32(out), "bfloat16"
    return out, dt.name
