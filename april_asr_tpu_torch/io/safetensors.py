"""Minimal safetensors-format reader/writer (public format, no dependency).

Used for the native checkpoint payload inside MODEL_NATIVE_TRANSDUCER_TPU
containers and for standalone weight dumps. Layout: u64 little-endian JSON
header length, JSON header mapping tensor name -> {dtype, shape, data_offsets},
with an optional "__metadata__" dict (string values), then the raw buffer.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Tuple

import numpy as np

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def save_safetensors_bytes(
    tensors: Dict[str, np.ndarray], metadata: dict | None = None
) -> bytes:
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = {k: json.dumps(v) for k, v in metadata.items()}
    offset = 0
    bufs = []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        dtype_name = _DTYPE_NAMES.get(arr.dtype)
        if dtype_name is None:
            raise ValueError(f"unsupported dtype {arr.dtype} for {name}")
        raw = arr.tobytes()
        header[name] = {
            "dtype": dtype_name,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        bufs.append(raw)
        offset += len(raw)
    hjson = json.dumps(header).encode("utf-8")
    return struct.pack("<Q", len(hjson)) + hjson + b"".join(bufs)


def load_safetensors_bytes(data: bytes) -> Tuple[Dict[str, np.ndarray], dict]:
    if len(data) < 8:
        raise ValueError("truncated safetensors blob")
    (hlen,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8 : 8 + hlen].decode("utf-8"))
    body = data[8 + hlen :]
    meta_raw = header.pop("__metadata__", {})
    metadata = {k: json.loads(v) for k, v in meta_raw.items()}
    tensors = {}
    for name, info in header.items():
        dtype = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        arr = np.frombuffer(body[start:end], dtype=dtype).reshape(info["shape"])
        tensors[name] = arr
    return tensors, metadata
