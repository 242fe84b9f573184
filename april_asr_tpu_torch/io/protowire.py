"""Minimal protobuf wire-format codec, no external protobuf dependency
(the port's copy of april_asr_tpu/io/protowire.py, which imports no JAX).

The reference feeds the `.april` container's embedded ONNX graphs straight to
ONNXRuntime (reference: src/ort_util.h:127-134). This framework parses those
graphs itself — ONNX is plain protobuf, and the subset of the wire format
needed (varint / 64-bit / length-delimited / 32-bit fields, packed repeated
scalars) is small enough to implement directly.

`decode_message` produces a dict: field_number -> list of raw (wire_type,
value) entries, which io/onnx_model.py interprets against the ONNX schema.
`MessageWriter` provides the encoding side for the model exporter.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

WIRE_VARINT = 0
WIRE_64BIT = 1
WIRE_LEN = 2
WIRE_32BIT = 5


class ProtoError(ValueError):
    pass


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ProtoError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ProtoError("varint too long")


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value). LEN fields yield bytes; varint
    yields int; 32/64-bit yield raw little-endian bytes."""
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field = tag >> 3
        wire = tag & 7
        if wire == WIRE_VARINT:
            val, pos = _read_varint(data, pos)
            yield field, wire, val
        elif wire == WIRE_64BIT:
            if pos + 8 > n:
                raise ProtoError("truncated 64-bit field")
            yield field, wire, data[pos : pos + 8]
            pos += 8
        elif wire == WIRE_LEN:
            ln, pos = _read_varint(data, pos)
            if pos + ln > n:
                raise ProtoError("truncated length-delimited field")
            yield field, wire, data[pos : pos + ln]
            pos += ln
        elif wire == WIRE_32BIT:
            if pos + 4 > n:
                raise ProtoError("truncated 32-bit field")
            yield field, wire, data[pos : pos + 4]
            pos += 4
        else:
            raise ProtoError(f"unsupported wire type {wire}")


def decode_message(data: bytes) -> Dict[int, List[Tuple[int, bytes | int]]]:
    out: Dict[int, List[Tuple[int, bytes | int]]] = {}
    for field, wire, val in iter_fields(data):
        out.setdefault(field, []).append((wire, val))
    return out


# -- typed readers ---------------------------------------------------------


def as_int(entry: Tuple[int, bytes | int]) -> int:
    wire, val = entry
    if wire == WIRE_VARINT:
        return val  # type: ignore[return-value]
    if wire == WIRE_64BIT:
        return struct.unpack("<q", val)[0]  # type: ignore[arg-type]
    if wire == WIRE_32BIT:
        return struct.unpack("<i", val)[0]  # type: ignore[arg-type]
    raise ProtoError("field is not an integer")


def as_signed_int(entry: Tuple[int, bytes | int]) -> int:
    """Varint interpreted as two's-complement int64 (proto int64/int32)."""
    v = as_int(entry)
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def as_float(entry: Tuple[int, bytes | int]) -> float:
    wire, val = entry
    if wire == WIRE_32BIT:
        return struct.unpack("<f", val)[0]  # type: ignore[arg-type]
    if wire == WIRE_64BIT:
        return struct.unpack("<d", val)[0]  # type: ignore[arg-type]
    raise ProtoError("field is not a float")


def as_bytes(entry: Tuple[int, bytes | int]) -> bytes:
    wire, val = entry
    if wire != WIRE_LEN:
        raise ProtoError("field is not length-delimited")
    return val  # type: ignore[return-value]


def packed_varints(data: bytes, signed: bool = True) -> List[int]:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        if signed and v >= 1 << 63:
            v -= 1 << 64
        out.append(v)
    return out


def repeated_int(entries: List[Tuple[int, bytes | int]]) -> List[int]:
    """Repeated int64 field: either packed (LEN) or one varint per entry."""
    out: List[int] = []
    for wire, val in entries:
        if wire == WIRE_LEN:
            out.extend(packed_varints(val))  # type: ignore[arg-type]
        elif wire == WIRE_VARINT:
            v = val
            if v >= 1 << 63:
                v -= 1 << 64
            out.append(v)  # type: ignore[arg-type]
        else:
            raise ProtoError("bad repeated int field")
    return out


# -- writer ----------------------------------------------------------------


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class MessageWriter:
    """Accumulates protobuf fields; `bytes(writer)` yields the message."""

    def __init__(self):
        self._buf = bytearray()

    def _tag(self, field: int, wire: int) -> None:
        self._buf += _varint((field << 3) | wire)

    def varint(self, field: int, value: int) -> "MessageWriter":
        self._tag(field, WIRE_VARINT)
        self._buf += _varint(value)
        return self

    def float32(self, field: int, value: float) -> "MessageWriter":
        self._tag(field, WIRE_32BIT)
        self._buf += struct.pack("<f", value)
        return self

    def bytes_field(self, field: int, value: bytes) -> "MessageWriter":
        self._tag(field, WIRE_LEN)
        self._buf += _varint(len(value))
        self._buf += value
        return self

    def string(self, field: int, value: str) -> "MessageWriter":
        return self.bytes_field(field, value.encode("utf-8"))

    def message(self, field: int, sub: "MessageWriter") -> "MessageWriter":
        return self.bytes_field(field, bytes(sub))

    def packed_varints(self, field: int, values) -> "MessageWriter":
        payload = b"".join(_varint(v) for v in values)
        return self.bytes_field(field, payload)

    def __bytes__(self) -> bytes:
        return bytes(self._buf)
