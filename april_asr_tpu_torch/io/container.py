"""`.april` model container reader/writer.

Layout (reference: src/file/model_file.c:57-129, written by
extra/export-april.py:387-443):

    "APRILMDL" | u32 version (=1) | u64 header_size | header | blobs...

    header:
      8 bytes  language (IETF tag, NUL padded)
      u64-len  name
      u64-len  description
      u32      model type
      u64      params offset     u64 params size
      u64      num_networks (<= 8)
      per network: u64 offset, u64 size

The reference streams network blobs into ONNXRuntime; here the blobs are
returned as bytes for the ONNX importer / native weight extractor. Model type 1
is the reference's MODEL_LSTM_TRANSDUCER_STATELESS (src/file/model_file.h:27-31);
type 64 is this framework's native-checkpoint extension (network blobs are
safetensors-format weight dumps instead of ONNX graphs).
"""

from __future__ import annotations

import dataclasses
import io as _stdio
import os
from typing import List

from .binio import (
    BinaryFormatError,
    read_exact,
    read_len_string,
    read_u32,
    read_u64,
    write_len_string,
    write_u32,
    write_u64,
)
from .params import ModelParameters, read_params, write_params

APRIL_MAGIC = b"APRILMDL"
APRIL_CONTAINER_VERSION = 1

MODEL_UNKNOWN = 0
MODEL_LSTM_TRANSDUCER_STATELESS = 1  # 3 ONNX networks: encoder, decoder, joiner
# Extension (not readable by the reference): networks are safetensors blobs of
# a native JAX parameter tree. Chosen far above the reference's MODEL_MAX so a
# reference build cleanly rejects the file instead of misparsing it.
MODEL_NATIVE_TRANSDUCER_TPU = 64

MAX_NETWORKS = 8


@dataclasses.dataclass
class AprilContainer:
    language: str
    name: str
    description: str
    model_type: int
    params: ModelParameters
    networks: List[bytes]

    @property
    def network_count(self) -> int:
        return len(self.networks)


def read_container(path: str | os.PathLike) -> AprilContainer:
    """Read and validate a .april file (reference: model_read, model_file.c:131-149)."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        file_size = f.tell()
        f.seek(0)

        magic = read_exact(f, 8)
        if magic != APRIL_MAGIC:
            raise BinaryFormatError("bad APRILMDL magic")
        version = read_u32(f)
        if version != APRIL_CONTAINER_VERSION:
            raise BinaryFormatError(f"unsupported container version {version}")
        header_size = read_u64(f)
        header_offset = f.tell()
        if header_offset + header_size > file_size:
            raise BinaryFormatError("header out of bounds")

        language = read_exact(f, 8).rstrip(b"\0").decode("utf-8", errors="replace")
        name = read_len_string(f, max_len=1 << 20).decode("utf-8", errors="replace")
        description = read_len_string(f, max_len=1 << 20).decode(
            "utf-8", errors="replace"
        )
        model_type = read_u32(f)
        if model_type == MODEL_UNKNOWN:
            raise BinaryFormatError(f"unexpected model type {model_type}")

        params_offset = read_u64(f)
        params_size = read_u64(f)
        if params_offset + params_size > file_size:
            raise BinaryFormatError("params out of bounds of file")

        num_networks = read_u64(f)
        if num_networks > MAX_NETWORKS:
            raise BinaryFormatError(f"too many networks {num_networks}")
        entries = []
        for i in range(num_networks):
            off = read_u64(f)
            size = read_u64(f)
            if off + size > file_size:
                raise BinaryFormatError(f"network {i} out of bounds of file")
            entries.append((off, size))

        # Unlike the reference (which relies on the fd happening to sit at the
        # params blob after reading the last network, model_file.c:164-166), we
        # seek to the recorded offset explicitly.
        f.seek(params_offset)
        params = read_params(f)

        networks = []
        for off, size in entries:
            f.seek(off)
            networks.append(read_exact(f, size))

    return AprilContainer(
        language=language,
        name=name,
        description=description,
        model_type=model_type,
        params=params,
        networks=networks,
    )


def write_container(path: str | os.PathLike, container: AprilContainer) -> None:
    """Write a .april file byte-compatible with the reference reader
    (layout mirrors extra/export-april.py:387-443: header, then network blobs,
    then the params blob)."""
    if len(container.networks) > MAX_NETWORKS:
        raise ValueError("too many networks")

    params_blob = write_params(container.params)

    lang = container.language.encode("utf-8").ljust(8, b"\0")
    if len(lang) > 8:
        raise ValueError("language string may not be longer than 8 bytes")

    header = _stdio.BytesIO()
    header.write(lang)
    write_len_string(header, container.name.encode("utf-8"))
    write_len_string(header, container.description.encode("utf-8"))
    write_u32(header, container.model_type)
    params_entry_pos = header.tell()
    write_u64(header, 0)
    write_u64(header, len(params_blob))
    network_entry_pos = []
    write_u64(header, len(container.networks))
    for blob in container.networks:
        network_entry_pos.append(header.tell())
        write_u64(header, 0)
        write_u64(header, len(blob))

    header_bytes = bytearray(header.getvalue())

    # Offsets are absolute file offsets; compute with the fixed preamble size.
    preamble = 8 + 4 + 8  # magic + version + header_size
    cursor = preamble + len(header_bytes)
    network_offsets = []
    for blob in container.networks:
        network_offsets.append(cursor)
        cursor += len(blob)
    params_offset = cursor

    import struct

    header_bytes[params_entry_pos : params_entry_pos + 8] = struct.pack(
        "<Q", params_offset
    )
    for pos, off in zip(network_entry_pos, network_offsets):
        header_bytes[pos : pos + 8] = struct.pack("<Q", off)

    with open(path, "wb") as f:
        f.write(APRIL_MAGIC)
        write_u32(f, APRIL_CONTAINER_VERSION)
        write_u64(f, len(header_bytes))
        f.write(bytes(header_bytes))
        for blob in container.networks:
            f.write(blob)
        f.write(params_blob)
