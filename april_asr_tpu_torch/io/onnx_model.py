"""ONNX model deserialization against the public onnx.proto schema (the
port's copy of april_asr_tpu/io/onnx_model.py, which imports no JAX).

Parses ModelProto / GraphProto / NodeProto / AttributeProto / TensorProto from
raw bytes using the wire codec in protowire.py — no onnx or protobuf package
required. Only the fields needed to execute inference graphs are materialized.

This replaces the reference's dependency on ONNXRuntime session creation
(reference: src/ort_util.h:127-134, src/april_model.c:57-59): instead of
handing the graph bytes to an external engine, the graph becomes a Python
structure that ops/onnx2torch.py lowers to a PyTorch function. Initializers
stored as `raw_data` stay `np.frombuffer` views of the model bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .protowire import (
    MessageWriter,
    ProtoError,
    as_bytes,
    as_float,
    as_signed_int,
    decode_message,
    repeated_int,
)

# TensorProto.DataType
DT_FLOAT = 1
DT_UINT8 = 2
DT_INT8 = 3
DT_INT16 = 5
DT_INT32 = 6
DT_INT64 = 7
DT_BOOL = 9
DT_FLOAT16 = 10
DT_DOUBLE = 11
DT_BFLOAT16 = 16

_NP_DTYPES = {
    DT_FLOAT: np.float32,
    DT_UINT8: np.uint8,
    DT_INT8: np.int8,
    DT_INT16: np.int16,
    DT_INT32: np.int32,
    DT_INT64: np.int64,
    DT_BOOL: np.bool_,
    DT_FLOAT16: np.float16,
    DT_DOUBLE: np.float64,
}

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_GRAPH = 5
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str
    attrs: Dict[str, object]


@dataclasses.dataclass
class OnnxGraph:
    name: str
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]  # graph inputs that are NOT initializers
    outputs: List[str]
    input_shapes: Dict[str, List[int]]
    input_dtypes: Dict[str, np.dtype]
    output_shapes: Dict[str, List[int]]


@dataclasses.dataclass
class OnnxModel:
    ir_version: int
    opset: int
    graph: OnnxGraph


def parse_tensor(data: bytes) -> tuple[str, np.ndarray]:
    """TensorProto -> (name, ndarray)."""
    f = decode_message(data)
    dims = repeated_int(f.get(1, []))
    data_type = as_signed_int(f[2][0]) if 2 in f else DT_FLOAT
    name = as_bytes(f[8][0]).decode("utf-8") if 8 in f else ""

    np_dtype = _NP_DTYPES.get(data_type)
    if np_dtype is None:
        raise ProtoError(f"unsupported tensor data type {data_type}")

    if 9 in f:  # raw_data
        raw = as_bytes(f[9][0])
        arr = np.frombuffer(raw, dtype=np_dtype if data_type != DT_BOOL else np.uint8)
        if data_type == DT_BOOL:
            arr = arr.astype(np.bool_)
    elif 4 in f and data_type == DT_FLOAT:  # float_data
        vals = []
        for wire, val in f[4]:
            if wire == 2:  # packed
                vals.append(np.frombuffer(val, dtype="<f4"))
            else:
                import struct as _s

                vals.append(np.array([_s.unpack("<f", val)[0]], dtype=np.float32))
        arr = np.concatenate(vals) if vals else np.zeros(0, np.float32)
    elif 7 in f and data_type == DT_INT64:  # int64_data
        arr = np.array(repeated_int(f[7]), dtype=np.int64)
    elif 5 in f and data_type in (DT_INT32, DT_INT8, DT_UINT8, DT_INT16, DT_BOOL):
        arr = np.array(repeated_int(f[5]), dtype=np_dtype)
    elif 10 in f and data_type == DT_DOUBLE:  # double_data
        vals = []
        for wire, val in f[10]:
            if wire == 2:
                vals.append(np.frombuffer(val, dtype="<f8"))
        arr = np.concatenate(vals) if vals else np.zeros(0, np.float64)
    else:
        arr = np.zeros(0, np_dtype)

    return name, arr.reshape(dims) if dims else arr.reshape(())


def _parse_attr(data: bytes) -> tuple[str, object]:
    f = decode_message(data)
    name = as_bytes(f[1][0]).decode("utf-8") if 1 in f else ""
    atype = as_signed_int(f[20][0]) if 20 in f else None

    if atype == ATTR_FLOAT or (atype is None and 2 in f):
        return name, as_float(f[2][0])
    if atype == ATTR_INT or (atype is None and 3 in f):
        return name, as_signed_int(f[3][0])
    if atype == ATTR_STRING or (atype is None and 4 in f):
        return name, as_bytes(f[4][0])
    if atype == ATTR_TENSOR or (atype is None and 5 in f):
        _, arr = parse_tensor(as_bytes(f[5][0]))
        return name, arr
    if atype == ATTR_FLOATS or (atype is None and 7 in f):
        vals = []
        for wire, val in f.get(7, []):
            if wire == 2:
                vals.extend(np.frombuffer(val, dtype="<f4").tolist())
            else:
                vals.append(as_float((wire, val)))
        return name, vals
    if atype == ATTR_INTS or (atype is None and 8 in f):
        return name, repeated_int(f.get(8, []))
    if atype == ATTR_STRINGS or (atype is None and 9 in f):
        return name, [as_bytes(e) for e in f.get(9, [])]
    if atype == ATTR_GRAPH or (atype is None and 6 in f):
        return name, parse_graph(as_bytes(f[6][0]))
    # Attribute present but empty (e.g. empty ints list)
    return name, None


def _parse_value_info(data: bytes) -> tuple[str, Optional[List[int]], Optional[np.dtype]]:
    f = decode_message(data)
    name = as_bytes(f[1][0]).decode("utf-8") if 1 in f else ""
    shape = None
    dtype = None
    if 2 in f:  # TypeProto
        t = decode_message(as_bytes(f[2][0]))
        if 1 in t:  # tensor_type
            tt = decode_message(as_bytes(t[1][0]))
            if 1 in tt:
                dtype = _NP_DTYPES.get(as_signed_int(tt[1][0]))
            if 2 in tt:  # shape
                sh = decode_message(as_bytes(tt[2][0]))
                shape = []
                for _, dim_bytes in sh.get(1, []):
                    d = decode_message(dim_bytes)  # type: ignore[arg-type]
                    if 1 in d:
                        shape.append(as_signed_int(d[1][0]))
                    else:
                        shape.append(-1)  # dim_param (symbolic)
    return name, shape, np.dtype(dtype) if dtype else None


def parse_graph(data: bytes) -> OnnxGraph:
    f = decode_message(data)
    name = as_bytes(f[2][0]).decode("utf-8") if 2 in f else ""

    initializers: Dict[str, np.ndarray] = {}
    for _, tdata in f.get(5, []):
        tname, arr = parse_tensor(tdata)  # type: ignore[arg-type]
        initializers[tname] = arr

    nodes: List[OnnxNode] = []
    for _, ndata in f.get(1, []):
        nf = decode_message(ndata)  # type: ignore[arg-type]
        node = OnnxNode(
            op_type=as_bytes(nf[4][0]).decode("utf-8") if 4 in nf else "",
            inputs=[as_bytes(e).decode("utf-8") for e in nf.get(1, [])],
            outputs=[as_bytes(e).decode("utf-8") for e in nf.get(2, [])],
            name=as_bytes(nf[3][0]).decode("utf-8") if 3 in nf else "",
            attrs=dict(_parse_attr(as_bytes(e)) for e in nf.get(5, [])),
        )
        nodes.append(node)

    inputs = []
    input_shapes = {}
    input_dtypes = {}
    for _, vdata in f.get(11, []):
        vname, shape, dtype = _parse_value_info(vdata)  # type: ignore[arg-type]
        if vname not in initializers:
            inputs.append(vname)
            if shape is not None:
                input_shapes[vname] = shape
            if dtype is not None:
                input_dtypes[vname] = dtype

    outputs = []
    output_shapes = {}
    for _, vdata in f.get(12, []):
        vname, shape, _ = _parse_value_info(vdata)  # type: ignore[arg-type]
        outputs.append(vname)
        if shape is not None:
            output_shapes[vname] = shape

    return OnnxGraph(
        name=name,
        nodes=nodes,
        initializers=initializers,
        inputs=inputs,
        outputs=outputs,
        input_shapes=input_shapes,
        input_dtypes=input_dtypes,
        output_shapes=output_shapes,
    )


def parse_model(data: bytes) -> OnnxModel:
    f = decode_message(data)
    ir_version = as_signed_int(f[1][0]) if 1 in f else 0
    opset = 0
    for _, op_bytes in f.get(8, []):
        opf = decode_message(op_bytes)  # type: ignore[arg-type]
        domain = as_bytes(opf[1][0]).decode() if 1 in opf else ""
        if domain in ("", "ai.onnx") and 2 in opf:
            opset = as_signed_int(opf[2][0])
    if 7 not in f:
        raise ProtoError("ModelProto has no graph")
    graph = parse_graph(as_bytes(f[7][0]))
    return OnnxModel(ir_version=ir_version, opset=opset, graph=graph)
