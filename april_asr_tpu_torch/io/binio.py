"""Little-endian binary readers/writers over file objects.

Equivalent role to the reference's mfu_* helpers (reference: src/file/util.h:41-80),
reimplemented for Python file objects with explicit EOF errors instead of
silent short reads.
"""

from __future__ import annotations

import struct
from typing import BinaryIO


class BinaryFormatError(ValueError):
    """Raised when a container/params blob fails validation."""


def read_exact(f: BinaryIO, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise BinaryFormatError(f"unexpected EOF: wanted {n} bytes, got {len(data)}")
    return data


def read_u32(f: BinaryIO) -> int:
    return struct.unpack("<I", read_exact(f, 4))[0]


def read_i32(f: BinaryIO) -> int:
    return struct.unpack("<i", read_exact(f, 4))[0]


def read_u64(f: BinaryIO) -> int:
    return struct.unpack("<Q", read_exact(f, 8))[0]


def read_i64(f: BinaryIO) -> int:
    return struct.unpack("<q", read_exact(f, 8))[0]


def read_len_string(f: BinaryIO, max_len: int = 1 << 30) -> bytes:
    """u64 length followed by raw bytes (reference: mfu_alloc_read_string,
    src/file/util.h:63-80)."""
    n = read_u64(f)
    if n > max_len:
        raise BinaryFormatError(f"string length {n} exceeds bound {max_len}")
    return read_exact(f, n)


def write_u32(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<I", v))


def write_i32(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<i", v))


def write_u64(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<Q", v))


def write_i64(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<q", v))


def write_len_string(f: BinaryIO, data: bytes) -> None:
    write_u64(f, len(data))
    f.write(data)
