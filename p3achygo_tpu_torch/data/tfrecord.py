"""TFRecord IO: the native C++ codec through ctypes, a pure-python fallback
(port of p3achygo_tpu/data/tfrecord.py).

Replaces cc/data/tfrecord/ (record_writer.h:17-27, record_reader.h:24):
TFRecord framing (8-byte LE length + masked crc32c + payload + crc) with
whole-stream zlib for the reference's `.tfrecord.zz` chunks. Both codecs
write the same bytes; the pure-python one is the wire reference.

The native codec is `native/tfrecord.cc`. The committed
`native/libtfrecord.so` is loaded when it loads; otherwise the source is
compiled with g++ into `p3achygo_tpu_torch/_build/libtfrecord_<hash>.so`,
named after a hash of the source and the flags, at first use. Without a
compiler the python codec runs; `using_native()` says which one does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import zlib
from typing import Iterator, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
_SOURCE = os.path.join(_NATIVE_DIR, "tfrecord.cc")
_COMMITTED_LIB = os.path.join(_NATIVE_DIR, "libtfrecord.so")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None  # None: not tried yet; False: no native codec in this process


def built_path() -> str:
    """Where the fallback build of native/tfrecord.cc goes: named after a
    hash of the source and the flags."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libtfrecord_{digest.hexdigest()[:12]}.so")


def _build() -> str:
    """Compile native/tfrecord.cc into BUILD_DIR (tmp file + rename)."""
    path = built_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, _SOURCE, "-o", tmp, "-lz"],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _bind(path: str):
    lib = ctypes.CDLL(path)
    lib.tfrec_write.restype = ctypes.c_int
    lib.tfrec_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, ctypes.c_int]
    lib.tfrec_open.restype = ctypes.c_void_p
    lib.tfrec_open.argtypes = [ctypes.c_char_p]
    lib.tfrec_next.restype = ctypes.c_int64
    lib.tfrec_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.tfrec_close.restype = None
    lib.tfrec_close.argtypes = [ctypes.c_void_p]
    return lib


def _load_native():
    global _lib
    if _lib is not None:
        return _lib
    try:
        _lib = _bind(_COMMITTED_LIB)
    except OSError:
        try:
            _lib = _bind(_build())
        except (OSError, subprocess.CalledProcessError):
            _lib = False
    return _lib


# ---------------- pure-python wire format (fallback + reference) ----------
def _make_crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if c & 1 else (c >> 1)
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()
_MASK_DELTA = 0xA282EAD8


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for byte in data:
        c = _CRC_TABLE[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _mask(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def _unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot << 15) | (rot >> 17)) & 0xFFFFFFFF


def _frame(record: bytes) -> bytes:
    header = struct.pack("<Q", len(record))
    return (header + struct.pack("<I", _mask(_crc32c(header))) + record
            + struct.pack("<I", _mask(_crc32c(record))))


def _py_write(path: str, records: List[bytes], zlib_level: Optional[int]):
    blob = b"".join(_frame(r) for r in records)
    if zlib_level is not None:
        blob = zlib.compress(blob, zlib_level)
    with open(path, "wb") as f:
        f.write(blob)


def _py_read(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        blob = f.read()
    # A zlib stream starts with 0x78 and a header whose 16 bits are a
    # multiple of 31 with a standard level byte; an uncompressed file whose
    # first length byte is 0x78 fails that test or fails to inflate.
    if (len(blob) >= 2 and blob[0] == 0x78
            and ((blob[0] << 8) | blob[1]) % 31 == 0
            and blob[1] in (0x01, 0x5E, 0x9C, 0xDA)):
        try:
            blob = zlib.decompress(blob)
        except zlib.error:
            pass
    pos = 0
    while pos < len(blob):
        if pos + 12 > len(blob):
            raise ValueError("truncated tfrecord header")
        (length,) = struct.unpack_from("<Q", blob, pos)
        (len_crc,) = struct.unpack_from("<I", blob, pos + 8)
        if _unmask(len_crc) != _crc32c(blob[pos:pos + 8]):
            raise ValueError("corrupt length crc")
        if pos + 16 + length > len(blob):
            raise ValueError("truncated tfrecord payload")
        payload = blob[pos + 12:pos + 12 + length]
        (data_crc,) = struct.unpack_from("<I", blob, pos + 12 + length)
        if _unmask(data_crc) != _crc32c(payload):
            raise ValueError("corrupt data crc")
        yield payload
        pos += 12 + length + 4


# ---------------- public API ----------------
def write_records(path: str, records: List[bytes],
                  zlib_level: Optional[int] = 6):
    """Write a TFRecord file (.zz semantics when zlib_level is not None)."""
    lib = _load_native()
    if not lib:
        _py_write(path, records, zlib_level)
        return
    n = len(records)
    arr = (ctypes.c_char_p * n)(*records)
    lens = (ctypes.c_uint64 * n)(*[len(r) for r in records])
    rc = lib.tfrec_write(path.encode(), arr, lens, n,
                         -1 if zlib_level is None else zlib_level)
    if rc != 0:
        raise IOError(f"tfrec_write failed rc={rc}")


def read_records(path: str) -> Iterator[bytes]:
    """Iterate the records of a TFRecord file (zlib auto-detected)."""
    lib = _load_native()
    if not lib:
        yield from _py_read(path)
        return
    handle = lib.tfrec_open(path.encode())
    if not handle:
        raise IOError(f"cannot open {path}")
    try:
        cap = 1 << 16
        buf = ctypes.create_string_buffer(cap)
        while True:
            got = lib.tfrec_next(handle, buf, cap)
            if got == -3:
                return
            if got == -2:  # the record is larger than the buffer
                cap *= 4
                buf = ctypes.create_string_buffer(cap)
                continue
            if got < 0:
                raise ValueError("corrupt tfrecord")
            yield buf.raw[:got]
    finally:
        lib.tfrec_close(handle)


def using_native() -> bool:
    """True when the native codec serves this process."""
    return bool(_load_native())
