"""ONNX graph construction (writer side of onnx_model.py; the port's copy of
april_asr_tpu/io/onnx_build.py, which imports no JAX, writing the same bytes).

Lets the framework export native transducer weights as the three opset-11
ONNX graphs a `.april` file embeds — the counterpart of the reference's
torch-based exporter (reference: extra/export-april.py:226-332). Graphs are
written in the same unrolled-primitive form torch traces produce (projected
LSTMs cannot be expressed with the ONNX LSTM op), so the files are loadable
by this framework's native extractor AND by the reference library/ONNXRuntime.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .onnx_model import DT_FLOAT, DT_INT64
from .protowire import MessageWriter

_NP_TO_DT = {
    np.dtype(np.float32): DT_FLOAT,
    np.dtype(np.int64): DT_INT64,
}


def _tensor_proto(name: str, arr: np.ndarray) -> MessageWriter:
    # NB: not ascontiguousarray — it promotes 0-d scalars to 1-d, which would
    # change TensorProto dims; tobytes() is contiguous regardless.
    arr = np.asarray(arr)
    dt = _NP_TO_DT.get(arr.dtype)
    if dt is None:
        raise ValueError(f"unsupported export dtype {arr.dtype}")
    t = MessageWriter()
    for d in arr.shape:
        t.varint(1, d)  # dims
    t.varint(2, dt)  # data_type
    t.string(8, name)  # name
    t.bytes_field(9, arr.tobytes())  # raw_data
    return t


def _value_info(name: str, shape: Sequence[int], dtype=np.float32) -> MessageWriter:
    dims = MessageWriter()
    for d in shape:
        dim = MessageWriter()
        dim.varint(1, d)  # dim_value
        dims.message(1, dim)
    tensor_type = MessageWriter()
    tensor_type.varint(1, _NP_TO_DT[np.dtype(dtype)])  # elem_type
    tensor_type.message(2, dims)  # shape
    type_proto = MessageWriter()
    type_proto.message(1, tensor_type)
    vi = MessageWriter()
    vi.string(1, name)
    vi.message(2, type_proto)
    return vi


def _attr(name: str, value) -> MessageWriter:
    a = MessageWriter()
    a.string(1, name)
    if isinstance(value, bool):
        a.varint(3, int(value))
        a.varint(20, 2)  # INT
    elif isinstance(value, int):
        a.varint(3, value)
        a.varint(20, 2)  # INT
    elif isinstance(value, float):
        a.float32(2, value)
        a.varint(20, 1)  # FLOAT
    elif isinstance(value, (bytes, str)):
        a.bytes_field(4, value.encode() if isinstance(value, str) else value)
        a.varint(20, 3)  # STRING
    elif isinstance(value, np.ndarray):
        a.message(5, _tensor_proto("", value))
        a.varint(20, 4)  # TENSOR
    elif isinstance(value, (list, tuple)) and all(isinstance(v, int) for v in value):
        a.packed_varints(8, list(value))
        a.varint(20, 7)  # INTS
    else:
        raise ValueError(f"unsupported attribute {name}={value!r}")
    return a


class GraphBuilder:
    """Builds a ModelProto with a single GraphProto."""

    def __init__(self, name: str):
        self.name = name
        self._nodes: List[MessageWriter] = []
        self._initializers: Dict[str, np.ndarray] = {}
        self._inputs: List[Tuple[str, Sequence[int], np.dtype]] = []
        self._outputs: List[Tuple[str, Sequence[int], np.dtype]] = []
        self._counter = 0

    def fresh(self, hint: str = "t") -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def init(self, name: str, arr: np.ndarray) -> str:
        self._initializers[name] = np.asarray(arr)
        return name

    def input(self, name: str, shape: Sequence[int], dtype=np.float32) -> str:
        self._inputs.append((name, shape, np.dtype(dtype)))
        return name

    def output(self, name: str, shape: Sequence[int], dtype=np.float32) -> None:
        self._outputs.append((name, shape, np.dtype(dtype)))

    def node(self, op: str, inputs: Sequence[str], outputs: Sequence[str] | None = None, **attrs) -> str | List[str]:
        if outputs is None:
            outputs = [self.fresh(op.lower())]
        n = MessageWriter()
        for i in inputs:
            n.string(1, i)
        for o in outputs:
            n.string(2, o)
        n.string(3, f"{op}_{self._counter}")
        n.string(4, op)
        for k, v in attrs.items():
            n.message(5, _attr(k, v))
        self._nodes.append(n)
        return outputs[0] if len(outputs) == 1 else list(outputs)

    # convenience composites -------------------------------------------------

    def const(self, value: np.ndarray, hint: str = "const") -> str:
        out = self.fresh(hint)
        self.node("Constant", [], [out], value=np.asarray(value))
        return out

    def matmul_bias(self, x: str, w: np.ndarray, b: np.ndarray, prefix: str) -> str:
        wn = self.init(f"{prefix}_w", w.astype(np.float32))
        y = self.node("MatMul", [x, wn])
        bn = self.init(f"{prefix}_b", b.astype(np.float32))
        return self.node("Add", [y, bn])

    def double_swish(self, x: str) -> str:
        one = self.const(np.float32(1.0), "one")
        return self.node("Mul", [x, self.node("Sigmoid", [self.node("Sub", [x, one])])])

    def build(self, opset: int = 11, producer: str = "april_asr_tpu") -> bytes:
        g = MessageWriter()
        for n in self._nodes:
            g.message(1, n)
        g.string(2, self.name)
        for name, arr in self._initializers.items():
            g.message(5, _tensor_proto(name, arr))
        for name, shape, dtype in self._inputs:
            g.message(11, _value_info(name, shape, dtype))
        for name, shape, dtype in self._outputs:
            g.message(12, _value_info(name, shape, dtype))

        m = MessageWriter()
        m.varint(1, 7)  # ir_version
        m.string(2, producer)
        opset_w = MessageWriter()
        opset_w.string(1, "")
        opset_w.varint(2, opset)
        m.message(8, opset_w)
        m.message(7, g)
        return bytes(m)


def build_transducer_graphs(dims, params: Dict[str, np.ndarray]) -> Tuple[bytes, bytes, bytes]:
    """Native params pytree -> (encoder, decoder, joiner) ONNX bytes with the
    reference's I/O names and batch-1 shapes (export-april.py:234-331)."""
    P = {k: np.asarray(v, np.float32) if np.asarray(v).dtype.kind == "f" else np.asarray(v) for k, v in params.items()}
    L, d, H = dims.layers, dims.d_model, dims.hidden
    seg, mel, J, V, ctx = dims.segment_size, dims.mel, dims.joiner_dim, dims.vocab, dims.context
    c1, c2, c3 = dims.conv_channels
    t_sub = dims.subsampled_t

    # ---- encoder ----
    g = GraphBuilder("encoder")
    x = g.input("x", (1, seg, mel))
    h_in = g.input("h", (L, 1, d))
    c_in = g.input("c", (L, 1, H))

    y = g.node("Unsqueeze", [x], axes=[1])  # (1,1,seg,mel)
    y = g.node(
        "Conv",
        [y, g.init("conv1_w", P["conv1_w"]), g.init("conv1_b", P["conv1_b"])],
        strides=[1, 1], pads=[1, 1, 1, 1], dilations=[1, 1], group=1,
        kernel_shape=[3, 3],
    )
    y = g.double_swish(y)
    y = g.node(
        "Conv",
        [y, g.init("conv2_w", P["conv2_w"]), g.init("conv2_b", P["conv2_b"])],
        strides=[2, 2], pads=[0, 0, 0, 0], dilations=[1, 1], group=1,
        kernel_shape=[3, 3],
    )
    y = g.double_swish(y)
    y = g.node(
        "Conv",
        [y, g.init("conv3_w", P["conv3_w"]), g.init("conv3_b", P["conv3_b"])],
        strides=[2, 2], pads=[0, 0, 0, 0], dilations=[1, 1], group=1,
        kernel_shape=[3, 3],
    )
    y = g.double_swish(y)
    # (1, c3, t', f') -> (1, t', c3*f')
    y = g.node("Transpose", [y], perm=[0, 2, 1, 3])
    y = g.node(
        "Reshape",
        [y, g.init("embed_reshape", np.array([1, t_sub, c3 * dims.conv_freq_out], np.int64))],
    )
    y = g.matmul_bias(y, P["embed_out_w"], P["embed_out_b"], "embed_out")
    y = g.node("Squeeze", [y], axes=[1])  # t'=1 -> (1, d)

    h_outs, c_outs = [], []
    for l in range(L):
        idx = g.const(np.array(l, np.int64), f"layer{l}_idx")
        h_l = g.node("Gather", [h_in, idx], axis=0)  # (1, d)
        c_l = g.node("Gather", [c_in, idx], axis=0)  # (1, H)
        gates = g.node(
            "Add",
            [
                g.node(
                    "Add",
                    [
                        g.node("MatMul", [y, g.init(f"l{l}_w_ih", P["w_ih_t"][l])]),
                        g.node("MatMul", [h_l, g.init(f"l{l}_w_hh", P["w_hh_t"][l])]),
                    ],
                ),
                g.init(f"l{l}_bias", P["bias"][l]),
            ],
        )
        i_g, f_g, g_g, o_g = g.node(
            "Split", [gates], [g.fresh("gi"), g.fresh("gf"), g.fresh("gg"), g.fresh("go")],
            axis=1, split=[H, H, H, H],
        )
        c_new = g.node(
            "Add",
            [
                g.node("Mul", [g.node("Sigmoid", [f_g]), c_l]),
                g.node("Mul", [g.node("Sigmoid", [i_g]), g.node("Tanh", [g_g])]),
            ],
        )
        hc = g.node("Mul", [g.node("Sigmoid", [o_g]), g.node("Tanh", [c_new])])
        h_new = g.node("MatMul", [hc, g.init(f"l{l}_w_hr", P["w_hr_t"][l])])
        y = g.node("Add", [y, h_new])
        ff = g.matmul_bias(
            g.double_swish(g.matmul_bias(y, P["ff1_t"][l], P["ff1_b"][l], f"l{l}_ff1")),
            P["ff2_t"][l], P["ff2_b"][l], f"l{l}_ff2",
        )
        y = g.node("Add", [y, ff])
        # basic norm: y * (mean(y^2) + eps)^-0.5
        mean_sq = g.node("ReduceMean", [g.node("Mul", [y, y])], axes=[-1], keepdims=1)
        eps = g.init(f"l{l}_norm_eps", np.float32(P["norm_eps"][l]).reshape(()))
        neg_half = g.const(np.float32(-0.5), "neghalf")
        y = g.node("Mul", [y, g.node("Pow", [g.node("Add", [mean_sq, eps]), neg_half])])
        h_outs.append(g.node("Unsqueeze", [h_new], axes=[0]))
        c_outs.append(g.node("Unsqueeze", [c_new], axes=[0]))

    eout = g.matmul_bias(y, P["enc_proj_t"], P["enc_proj_b"], "enc_proj")
    g.node("Unsqueeze", [eout], ["encoder_out"], axes=[1])  # (1,1,J)
    g.node("Concat", h_outs, ["next_h"], axis=0)
    g.node("Concat", c_outs, ["next_c"], axis=0)
    g.output("encoder_out", (1, t_sub, J))
    g.output("next_h", (L, 1, d))
    g.output("next_c", (L, 1, H))
    enc_bytes = g.build()

    # ---- decoder ----
    g = GraphBuilder("decoder")
    context = g.input("context", (1, ctx), np.int64)
    emb = g.node("Gather", [g.init("dec_embed", P["dec_embed"]), context], axis=0)  # (1,ctx,d)
    emb = g.node("Transpose", [emb], perm=[0, 2, 1])  # (1,d,ctx)
    conv = g.node(
        "Conv", [emb, g.init("dec_conv_w", P["dec_conv_w"])],
        strides=[1], pads=[0, 0], dilations=[1], group=dims.decoder_groups,
        kernel_shape=[ctx],
    )
    conv = g.node("Transpose", [conv], perm=[0, 2, 1])  # (1,1,d)
    relu = g.node("Relu", [conv])
    dout = g.matmul_bias(relu, P["dec_proj_t"], P["dec_proj_b"], "dec_proj")
    g.node("Identity", [dout], ["decoder_out"])
    g.output("decoder_out", (1, 1, J))
    dec_bytes = g.build()

    # ---- joiner ----
    g = GraphBuilder("joiner")
    e_in = g.input("encoder_out", (1, 1, J))
    d_in = g.input("decoder_out", (1, 1, J))
    t = g.node("Tanh", [g.node("Add", [e_in, d_in])])
    logits = g.matmul_bias(t, P["join_t"], P["join_b"], "join")
    g.node("Identity", [logits], ["logits"])
    g.output("logits", (1, 1, V))
    joi_bytes = g.build()

    return enc_bytes, dec_bytes, joi_bytes
